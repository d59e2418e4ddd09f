"""Harris corner response for ORB keypoint ranking (port of
tpu_vo/features/harris.py).

OpenCV orb.cpp HarrisResponses: 3x3 Sobel derivatives, structure tensor
summed over a 7x7 block, response (a*b - c^2 - k*(a+b)^2) * scale^4 with
k = 0.04 and scale = 1/(4*7*255). Every sum keeps the JAX package's
order of additions (f32 adds do not reassociate), and each eager torch op
rounds on its own, so the result is reproducible bit for bit by the
select kernel built without FMA contraction.
"""

from __future__ import annotations

import torch

from tpu_vo_torch.features.fast import _shift

HARRIS_K = 0.04
BLOCK_SIZE = 7


def harris_scale4(block_size: int = BLOCK_SIZE) -> float:
    """scale^4 as the f32 constant both the plain map and the kernel use."""
    return float(torch.tensor((1.0 / ((1 << 2) * block_size * 255.0)) ** 4,
                              dtype=torch.float32))


def sobel_derivatives(img: torch.Tensor):
    """OpenCV orb.cpp derivative stencils (unnormalized 3x3 Sobel)."""
    Ix = ((_shift(img, 0, 1) - _shift(img, 0, -1)) * 2.0
          + (_shift(img, -1, 1) - _shift(img, -1, -1))
          + (_shift(img, 1, 1) - _shift(img, 1, -1)))
    Iy = ((_shift(img, 1, 0) - _shift(img, -1, 0)) * 2.0
          + (_shift(img, 1, -1) - _shift(img, -1, -1))
          + (_shift(img, 1, 1) - _shift(img, -1, 1)))
    return Ix, Iy


def _box_sum(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable (2r+1)^2 box sum: (acc + x[c+d]) + x[c-d], d = 1..r,
    horizontally, then the same vertically."""
    acc = img
    for d in range(1, radius + 1):
        acc = acc + _shift(img, 0, d) + _shift(img, 0, -d)
    out = acc
    for d in range(1, radius + 1):
        out = out + _shift(acc, d, 0) + _shift(acc, -d, 0)
    return out


def harris_response_map(img: torch.Tensor, block_size: int = BLOCK_SIZE,
                        k: float = HARRIS_K) -> torch.Tensor:
    """Dense Harris response of (..., H, W); valid where the 7x7+Sobel
    support is interior."""
    Ix, Iy = sobel_derivatives(img)
    r = block_size // 2
    a = _box_sum(Ix * Ix, r)
    b = _box_sum(Iy * Iy, r)
    c = _box_sum(Ix * Iy, r)
    return (a * b - c * c - k * (a + b) * (a + b)) * harris_scale4(block_size)
