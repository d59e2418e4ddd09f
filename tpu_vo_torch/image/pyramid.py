"""ORB-style image pyramid with OpenCV-convention bilinear resize (port of
tpu_vo/image/pyramid.py).

Level L has size (round(H / 1.2^L), round(W / 1.2^L)) and is resized from
level L-1 with the half-pixel-center convention, edge-clamped, computed
in float32 and rounded to the integer grid. Each axis of the resize is a
2-tap linear map, applied as a banded matmul in full f32 (TF32 is off
package-wide), as in the JAX package.

A 2-tap matmul rounds with or without a fused multiply-add depending on
the BLAS kernel: XLA:CPU picks by block shape, so a handful of pixels per level whose f32 value lies within one
ulp of a .5 rounding boundary can round the other way (tested in
tests/test_torch_image.py).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def level_sizes(height: int, width: int, n_levels: int,
                scale_factor: float) -> List[Tuple[int, int]]:
    """Per-level (H, W) using OpenCV's cvRound(size / scale^level)."""
    sizes = []
    for level in range(n_levels):
        s = scale_factor ** level
        sizes.append((int(round(height / s)), int(round(width / s))))
    return sizes


def level_scales(n_levels: int, scale_factor: float) -> List[float]:
    """Multiplier mapping level-L pixel coords back to level-0 coords."""
    return [scale_factor ** level for level in range(n_levels)]


# Copied from tpu_vo/image/pyramid.py (_resize_matrix).
def _resize_matrix(dst: int, src: int) -> np.ndarray:
    """(src, dst) interpolation matrix for one axis (OpenCV half-pixel
    convention, edge-clamped)."""
    scale = src / dst
    x = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x)
    w = x - x0
    w = np.where(x < 0, 0.0, w)  # OpenCV clamps the source coordinate
    i0 = np.clip(x0.astype(np.int64), 0, src - 1)
    i1 = np.clip(x0.astype(np.int64) + 1, 0, src - 1)
    M = np.zeros((src, dst), dtype=np.float32)
    np.add.at(M, (i0, np.arange(dst)), 1.0 - w)
    np.add.at(M, (i1, np.arange(dst)), w)
    return M


_BANDED_MIN_SRC = 256
_BAND_TILE = 128


# Copied from tpu_vo/image/pyramid.py (_banded_blocks).
def _banded_blocks(M: np.ndarray, tile: int):
    """Split a 2-tap interpolation matrix (src, dst) into per-output-tile
    banded blocks [(r0, block(rows, tile_cols)), ...]."""
    src, dst = M.shape
    blocks = []
    for c0 in range(0, dst, tile):
        cols = M[:, c0:c0 + tile]
        nz = np.nonzero(cols.any(axis=1))[0]
        r0, r1 = int(nz[0]), int(nz[-1]) + 1
        blocks.append((r0, cols[r0:r1]))
    return blocks


@functools.lru_cache(maxsize=None)
def _resize_operands(dst: int, src: int, device: torch.device):
    """((r0, block), ...) of one axis' (src, dst) interpolation matrix on
    `device`: banded blocks above _BANDED_MIN_SRC like the JAX package,
    else the whole matrix. Built and copied once: a copy from pageable
    host memory waits for the stream to drain."""
    M = _resize_matrix(dst, src)
    blocks = _banded_blocks(M, _BAND_TILE) if src > _BANDED_MIN_SRC else [(0, M)]
    return tuple((r0, torch.as_tensor(blk, device=device)) for r0, blk in blocks)


def _resize_axis(x: torch.Tensor, dst: int) -> torch.Tensor:
    """Resize the last axis of x to dst samples."""
    ops = _resize_operands(dst, x.shape[-1], x.device)
    if len(ops) == 1:
        return x @ ops[0][1]
    return torch.cat([x[..., r0:r0 + blk.shape[0]] @ blk for r0, blk in ops], dim=-1)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) float32 images (rows, then columns)."""
    x = img.to(torch.float32)
    out = _resize_axis(x.transpose(-1, -2), out_h)
    return _resize_axis(out.transpose(-1, -2), out_w)


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale_factor: float) -> List[torch.Tensor]:
    """Cascaded pyramid like cv::ORB: level L resized from level L-1.

    img: (..., H, W) uint8 or float. Returns n_levels float32 tensors on
    the integer grid 0..255.
    """
    h, w = img.shape[-2], img.shape[-1]
    sizes = level_sizes(h, w, n_levels, scale_factor)
    levels = [img.to(torch.float32)]
    for lh, lw in sizes[1:]:
        nxt = resize_bilinear(levels[-1], lh, lw)
        levels.append(torch.clamp(torch.round(nxt), 0.0, 255.0))
    return levels
