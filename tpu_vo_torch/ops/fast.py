"""FAST-9/16 arc margins: (score, corner) maps of pyramid levels.

`fast_margin` replaces tpu_vo/ops/fast_pallas.py `fast_margin_pallas`,
and `fast_margin_levels` does the same for a list of levels. For CUDA
tensors they launch kernel B3 (csrc/fast.cu) once, for all levels; for
CPU tensors they run `fast_margin_reference`, which is features/fast.py
`fast_score_map`, level by level. Both take (B, H, W) float32 levels and
return

  score   (B, H, W) float32: max(margin, threshold) - 1 at corners, 0
          elsewhere (OpenCV's cornerScore<16>);
  corner  (B, H, W) bool: margin > threshold, 3-pixel border excluded;

and agree bit for bit on finite input.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_vo_torch.features.fast import fast_score_map
from tpu_vo_torch.ops import levels as lvl_table

fast_margin_reference = fast_score_map


def _check(levels: torch.Tensor) -> None:
    if levels.dim() != 3 or levels.dtype != torch.float32:
        raise ValueError(f"levels must be (B, H, W) float32, got "
                         f"{tuple(levels.shape)} {levels.dtype}")


def _fast_margin_cuda(levels, threshold: int):
    from tpu_vo_torch.ops import _build

    lvl_table.check_levels(levels)
    b, dev = levels[0].shape[0], levels[0].device
    # two allocations for all levels (one per level and output cost the
    # host more than the kernel's launch)
    sizes = [lvl.numel() for lvl in levels]
    scores = torch.empty(sum(sizes), dtype=torch.float32, device=dev).split(sizes)
    corners = torch.empty(sum(sizes), dtype=torch.bool, device=dev).split(sizes)
    out = [(s.view(lvl.shape), c.view(lvl.shape)) for s, c, lvl in zip(scores, corners, levels)]
    if sum(sizes) == 0:
        return out
    table = lvl_table.level_table(levels, score=[s for s, _ in out], corner=[c for _, c in out])
    with _build.on_device(levels[0]) as stream:
        err = _build.library().tvo_fast_margin_levels(table, b, float(threshold), stream)
    _build.check_launch(err, "fast_margin")
    fast_margin.launches += 1
    return out


def fast_margin_levels(levels, threshold: int):
    """[(score, corner)] of a list of (B, H, W) float32 pyramid levels:
    kernel B3 launched once for up to MAX_LEVELS levels of CUDA tensors,
    the plain version level by level on CPU tensors."""
    levels = list(levels)
    if levels and levels[0].device.type == "cpu":
        for lvl in levels:
            _check(lvl)
        return [fast_margin_reference(lvl, threshold) for lvl in levels]
    if levels and levels[0].device.type == "cuda":
        return [m for i in range(0, len(levels), lvl_table.MAX_LEVELS)
                for m in _fast_margin_cuda(levels[i:i + lvl_table.MAX_LEVELS], threshold)]
    raise ValueError(f"fast_margin_levels: unsupported levels "
                     f"{[lvl.device for lvl in levels]}")


def fast_margin(levels: torch.Tensor, threshold: int):
    """(score, corner) of (B, H, W) float32 levels: kernel B3 (a one-level
    table) on a CUDA tensor, the plain version on a CPU tensor."""
    _check(levels)
    if levels.device.type == "cuda":
        return _fast_margin_cuda([levels], threshold)[0]
    if levels.device.type == "cpu":
        return fast_margin_reference(levels, threshold)
    raise ValueError(f"fast_margin: unsupported device {levels.device}")


def occupancy():
    """(registers per thread, blocks per SM) of kernel B3 on the current
    card."""
    from tpu_vo_torch.ops import _build

    regs = ctypes.c_int(0)
    blocks = _build.library().tvo_fast_margin_occupancy(ctypes.byref(regs))
    if blocks < 0:
        raise RuntimeError("fast_margin: occupancy query failed")
    return regs.value, blocks


fast_margin.launches = 0  # kernel B3 launches, by either entry point
