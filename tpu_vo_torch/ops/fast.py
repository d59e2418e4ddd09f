"""FAST-9/16 arc margins: (score, corner) maps of pyramid levels.

`fast_margin` replaces tpu_vo/ops/fast_pallas.py `fast_margin_pallas`.
For a CUDA tensor it launches kernel B3 (csrc/fast.cu); for a CPU tensor
it runs `fast_margin_reference`, which is features/fast.py
`fast_score_map`. Both take (B, H, W) float32 levels and return

  score   (B, H, W) float32: max(margin, threshold) - 1 at corners, 0
          elsewhere (OpenCV's cornerScore<16>);
  corner  (B, H, W) bool: margin > threshold, 3-pixel border excluded;

and agree bit for bit on finite input.
"""

from __future__ import annotations

import torch

from tpu_vo_torch.features.fast import fast_score_map

fast_margin_reference = fast_score_map

_MAX_GRID_Z = 65535  # CUDA's limit on gridDim.z, which holds the batch


def _check(levels: torch.Tensor) -> None:
    if levels.dim() != 3 or levels.dtype != torch.float32:
        raise ValueError(f"levels must be (B, H, W) float32, got "
                         f"{tuple(levels.shape)} {levels.dtype}")


def _fast_margin_cuda(levels: torch.Tensor, threshold: int):
    from tpu_vo_torch.ops import _build

    _check(levels)
    if not levels.is_contiguous():
        raise ValueError("levels must be contiguous")
    b, h, w = levels.shape
    if b > _MAX_GRID_Z:
        raise ValueError(f"fast_margin: batch {b} above {_MAX_GRID_Z}")
    score = torch.empty((b, h, w), dtype=torch.float32, device=levels.device)
    corner = torch.empty((b, h, w), dtype=torch.bool, device=levels.device)
    if b * h * w == 0:
        return score, corner
    lib = _build.library()
    stream = torch.cuda.current_stream(levels.device).cuda_stream
    err = lib.tvo_fast_margin(levels.data_ptr(), score.data_ptr(),
                              corner.data_ptr(), b, h, w, float(threshold),
                              stream)
    _build.check_launch(err, "fast_margin")
    fast_margin.launches += 1
    return score, corner


def fast_margin(levels: torch.Tensor, threshold: int):
    """(score, corner) of (B, H, W) float32 levels: kernel B3 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if levels.device.type == "cuda":
        return _fast_margin_cuda(levels, threshold)
    if levels.device.type == "cpu":
        _check(levels)
        return fast_margin_reference(levels, threshold)
    raise ValueError(f"fast_margin: unsupported device {levels.device}")


fast_margin.launches = 0  # kernel launches, counted by _fast_margin_cuda
