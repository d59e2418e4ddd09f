"""Color conversion matching cv::cvtColor(BGR2GRAY) bit for bit (port of
tpu_vo/image/color.py): BT.601 weights in 15-bit fixed point with
round-half-up, y = (B*3735 + G*19235 + R*9798 + 16384) >> 15.
"""

from __future__ import annotations

import torch

_B_COEF = 3735   # 0.114 * 2^15, rounded to make the triple sum 2^15
_G_COEF = 19235  # 0.587 * 2^15
_R_COEF = 9798   # 0.299 * 2^15
_SHIFT = 15


def _gray(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    r, g, b = (c.to(torch.int32) for c in (r, g, b))
    y = (b * _B_COEF + g * _G_COEF + r * _R_COEF + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.to(torch.uint8)


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 BGR -> (..., H, W) uint8 grayscale (cv2-exact)."""
    return _gray(img[..., 2], img[..., 1], img[..., 0])


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB -> uint8 grayscale (cv2 RGB2GRAY-exact)."""
    return _gray(img[..., 0], img[..., 1], img[..., 2])


def ensure_gray(img: torch.Tensor) -> torch.Tensor:
    """Pass through 2D images, convert (H, W, 3) BGR like the reference."""
    if img.dim() >= 3 and img.shape[-1] == 3:
        return bgr_to_gray(img)
    return img
