"""Separable Gaussian blur matching cv::GaussianBlur(ksize=7, sigma=2)
(port of tpu_vo/image/filters.py).

`gaussian_kernel_1d` is copied from the JAX package (pure numpy). The
full-frame `gaussian_blur` keeps its order of operations: taps are
multiplied and added left to right in float32 (each eager op rounds on
its own), horizontally then vertically, over a reflect-101 border, then
rounded and clipped to the integer grid. features/patches.py blurs one
window per keypoint with the same arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel: exp(-x^2/(2 sigma^2)) normalized to sum 1."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _reflect101_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source index of each of the n + 2 pad padded positions, on `device`,
    copied once (numpy's "reflect" is jnp.pad's)."""
    return torch.as_tensor(np.pad(np.arange(n), pad, mode="reflect"),
                           device=device)


def _reflect101_pad(img: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    """BORDER_REFLECT_101 along one axis: the edge pixel is not repeated
    (gfedcb|abcdefgh|gfedcb). An index along the axis, so any rank and
    any axis (F.pad's reflect mode pads only trailing axes)."""
    return torch.index_select(img, axis,
                              _reflect101_index(img.shape[axis], pad, img.device))


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0,
                  quantize: bool = True) -> torch.Tensor:
    """Blur (..., H, W) images; float32 output, on the integer grid when
    quantize (the ORB descriptor comparisons operate on those integers)."""
    k = [float(v) for v in gaussian_kernel_1d(ksize, sigma).astype(np.float32)]
    pad = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    x = _reflect101_pad(img.to(torch.float32), pad, -1)
    x = sum(x[..., i:i + w] * k[i] for i in range(ksize))
    x = _reflect101_pad(x, pad, -2)
    x = sum(x[..., i:i + h, :] * k[i] for i in range(ksize))
    if quantize:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x
