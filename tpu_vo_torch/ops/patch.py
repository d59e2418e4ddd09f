"""Per-keypoint 43x43 window extraction.

`extract_patches` replaces tpu_vo/ops/patch_pallas.py
`extract_patches_pallas` (and equals tpu_vo/features/patches.py
`extract_patches`); `extract_patches_levels` does the same for the slots
of a list of levels at once. For CUDA tensors they launch kernel B2
(csrc/patch.cu) once, for all levels; for CPU tensors they run
`extract_patches_reference`, level by level.

The window of keypoint (y, x) starts at clip(y - 21, 0, H' - 43),
clip(x - 21, 0, W' - 43) of the level zero-padded to H' = max(H, 43),
W' = max(W, 43), like jax.lax.dynamic_slice, so every slot (valid or
not) and every level size gives the same window on both paths.
"""

from __future__ import annotations

import torch

from tpu_vo_torch.ops import levels as lvl_table

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
    """Plain PyTorch version of kernel B2: (B, N, 43, 43) float32."""
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


def _extract_patches_cuda(levels, ys: torch.Tensor, xs: torch.Tensor,
                          slot_offsets) -> torch.Tensor:
    from tpu_vo_torch.ops import _build

    lvl_table.check_levels(levels)
    for lvl in levels:
        _check(lvl, ys, xs)
    if not (ys.is_contiguous() and xs.is_contiguous()):
        raise ValueError("ys and xs must be contiguous")
    b, n = ys.shape
    out = torch.empty((b, n, RAW_SIZE, RAW_SIZE), dtype=torch.float32,
                      device=ys.device)
    if b * n == 0:
        return out
    table = lvl_table.level_table(levels, slot_offsets, n)
    with _build.on_device(ys) as stream:
        err = _build.library().tvo_extract_patches_levels(
            table, ys.data_ptr(), xs.data_ptr(), out.data_ptr(), b, stream)
    _build.check_launch(err, "extract_patches")
    extract_patches.launches += 1
    return out


def extract_patches_levels(levels, ys: torch.Tensor, xs: torch.Tensor,
                           slot_offsets) -> torch.Tensor:
    """(B, N, 43, 43) windows of a list of (B, H, W) levels at int32
    (B, N) keypoints, level l owning slots [slot_offsets[l],
    slot_offsets[l + 1]) (the last to N): kernel B2 launched once for up
    to MAX_LEVELS levels of CUDA tensors, the plain version level by level
    on CPU tensors."""
    levels = list(levels)
    ranges = _check_offsets(levels, ys, slot_offsets)
    if levels[0].device.type == "cpu":
        return torch.cat([extract_patches_reference(lvl, ys[:, a:e], xs[:, a:e])
                          for lvl, (a, e) in zip(levels, ranges)], dim=1)
    if levels[0].device.type != "cuda":
        raise ValueError(f"extract_patches_levels: unsupported device {levels[0].device}")
    starts = [a for a, _ in ranges]
    head = lvl_table.MAX_LEVELS
    if len(levels) <= head:
        return _extract_patches_cuda(levels, ys, xs, starts)
    cut = starts[head]
    return torch.cat([
        extract_patches_levels(levels[:head], ys[:, :cut].contiguous(),
                               xs[:, :cut].contiguous(), starts[:head]),
        extract_patches_levels(levels[head:], ys[:, cut:].contiguous(),
                               xs[:, cut:].contiguous(), [a - cut for a in starts[head:]])],
        dim=1)


def extract_patches(levels: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """(B, N, 43, 43) windows of (B, H, W) levels at int32 (B, N)
    keypoints: kernel B2 (a one-level table) on a CUDA tensor, the plain
    version on a CPU tensor."""
    if levels.device.type == "cuda":
        return _extract_patches_cuda([levels], ys, xs, [0])
    if levels.device.type == "cpu":
        return extract_patches_reference(levels, ys, xs)
    raise ValueError(f"extract_patches: unsupported device {levels.device}")


extract_patches.launches = 0  # kernel B2 launches, by either entry point
