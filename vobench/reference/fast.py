# Frozen copy of tpu_vo_torch/features/fast.py (plain parts only): the benchmark's reference.
"""FAST-9/16 corner score maps, strict 3x3 NMS and detection (port of
tpu_vo/features/fast.py).

Score semantics replicate OpenCV's cornerScore<16>: score =
max(threshold, dark, bright) - 1 at corners, where dark/bright are the
best 9-contiguous-arc margins, and a pixel is a corner iff
max(dark, bright) > threshold. `fast_score_map` is the plain version of
kernel B3 (ops/fast.py) and, with `nonmax_suppress`, a building block of
kernel B1's plain version (ops/select.py). `detect` is kernel B3
followed by NMS: the first step of the dense ORB selection route
(features/orb.py `_select_level_keypoints`); `detect_levels` does the
same for a pyramid, with one launch of B3 for all its levels.
"""

from __future__ import annotations

import torch

# Copied from tpu_vo/features/fast.py: Bresenham circle of radius 3 in
# OpenCV's makeOffsets order, (dx, dy) with x = column, y = row.
CIRCLE_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)

ARC_LEN = 9  # FAST-9: at least 9 contiguous pixels


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """[..., y, x] = img[..., y + dy, x + dx] with wraparound."""
    return torch.roll(img, (-dy, -dx), dims=(-2, -1))


def _arc_margin(d_ext: torch.Tensor) -> torch.Tensor:
    """max over the 16 circular arcs of (min over ARC_LEN consecutive d);
    d_ext is (24, ..., H, W): the 16 diffs plus the first 8 repeated."""
    m = d_ext
    for j in range(1, ARC_LEN):
        m = torch.minimum(m, torch.roll(d_ext, -j, dims=0))
    return m[:16].amax(dim=0)


def _border_mask(h: int, w: int, border: int, device) -> torch.Tensor:
    """(H, W) bool: border <= y < h - border and border <= x < w - border
    (OpenCV's runByImageBorder)."""
    row = torch.arange(h, device=device)
    col = torch.arange(w, device=device)
    return (((row >= border) & (row < h - border))[:, None]
            & ((col >= border) & (col < w - border))[None, :])


def fast_score_map(img: torch.Tensor, threshold: int):
    """Dense FAST-9/16 response of (..., H, W) float32 images on the
    integer grid. Returns (score, corner): the OpenCV cornerScore at
    corners and 0 elsewhere, and the corner mask with the 3-pixel border
    excluded."""
    h, w = img.shape[-2], img.shape[-1]
    thr = float(threshold)
    d = torch.stack([img - _shift(img, dy, dx) for dx, dy in CIRCLE_OFFSETS])
    d_ext = torch.cat([d, d[:8]], dim=0)
    margin = torch.maximum(_arc_margin(d_ext), _arc_margin(-d_ext))
    corner = (margin > thr) & _border_mask(h, w, 3, img.device)
    score = torch.where(corner, torch.clamp(margin, min=thr) - 1.0,
                        torch.zeros_like(margin))
    return score, corner


def nonmax_suppress(score: torch.Tensor, corner: torch.Tensor) -> torch.Tensor:
    """3x3 strict-greater NMS on the corner score map (cv::FAST)."""
    nmax = torch.stack([_shift(score, dy, dx)
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                        if dx or dy]).amax(dim=0)
    return corner & (score > nmax)
