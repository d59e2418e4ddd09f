# Frozen copy of tpu_vo_torch/ops/patch.py (plain parts only): the benchmark's reference.
"""Kernel B2's plain version: one 43x43 window per keypoint.

The window of keypoint (y, x) starts at clip(y - 21, 0, H' - 43),
clip(x - 21, 0, W' - 43) of the level zero-padded to H' = max(H, 43),
W' = max(W, 43).
"""

from __future__ import annotations

import torch


RAW_RADIUS = 21
RAW_SIZE = 2 * RAW_RADIUS + 1  # 43


def _check(levels: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> None:
    if levels.dim() != 3 or levels.dtype != torch.float32:
        raise ValueError(f"levels must be (B, H, W) float32, got "
                         f"{tuple(levels.shape)} {levels.dtype}")
    want = (levels.shape[0], ys.shape[-1])
    for name, t in (("ys", ys), ("xs", xs)):
        if t.dtype != torch.int32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be int32 of shape {want}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != levels.device:
            raise ValueError(f"{name} is on {t.device}, levels on "
                             f"{levels.device}")


def _starts(c: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.clamp(c.to(torch.int64) - RAW_RADIUS, 0,
                       max(dim, RAW_SIZE) - RAW_SIZE)


def extract_patches_reference(levels: torch.Tensor, ys: torch.Tensor,
                              xs: torch.Tensor) -> torch.Tensor:
    """(B, N, 43, 43) float32 windows of one level."""
    _check(levels, ys, xs)
    b, h, w = levels.shape
    lvl = torch.nn.functional.pad(
        levels, (0, max(0, RAW_SIZE - w), 0, max(0, RAW_SIZE - h)))
    r = torch.arange(RAW_SIZE, device=levels.device)
    rows = (_starts(ys, h)[..., None] + r)[..., :, None]    # (B, N, 43, 1)
    cols = (_starts(xs, w)[..., None] + r)[..., None, :]    # (B, N, 1, 43)
    bi = torch.arange(b, device=levels.device)[:, None, None, None]
    return lvl[bi, rows, cols]


def _check_offsets(levels, ys: torch.Tensor, slot_offsets) -> list:
    """Each level's slot range [start, end) of the N slots."""
    n = ys.shape[-1]
    offs = [int(o) for o in slot_offsets]
    if (len(offs) != len(levels) or not offs or offs[0] != 0
            or any(a > b for a, b in zip(offs, offs[1:] + [n]))):
        raise ValueError(f"slot_offsets must rise from 0 to at most {n}, one "
                         f"per level, got {offs}")
    return list(zip(offs, offs[1:] + [n]))


def extract_patches_levels(levels, ys: torch.Tensor, xs: torch.Tensor,
                           slot_offsets) -> torch.Tensor:
    """(B, N, 43, 43) windows of a list of (B, H, W) levels at int32
    (B, N) keypoints, level l owning slots [slot_offsets[l],
    slot_offsets[l + 1]) (the last to N), level by level."""
    levels = list(levels)
    ranges = _check_offsets(levels, ys, slot_offsets)
    return torch.cat([extract_patches_reference(lvl, ys[:, a:e], xs[:, a:e])
                      for lvl, (a, e) in zip(levels, ranges)], dim=1)
