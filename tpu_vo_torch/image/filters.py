"""Separable Gaussian blur matching cv::GaussianBlur(ksize=7, sigma=2)
(port of tpu_vo/image/filters.py).

`gaussian_kernel_1d` is copied from the JAX package (pure numpy). The
full-frame `gaussian_blur` keeps its order of operations: taps are
multiplied and added left to right in float32 (each eager op rounds on
its own), horizontally then vertically, over a reflect-101 border, then
rounded and clipped to the integer grid. features/patches.py blurs one
window per keypoint with the same arithmetic.

`filter2d` is cv2.filter2D's direct path on the host (numpy), bit for bit
(cv2 5's arithmetic, measured against it: tests/test_torch_nuisances.py).
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


# cv2.filter2D's direct path: a float32 image's columns below a multiple
# of FILTER2D_LANES are summed by vector FMAs, the rest by a scalar
# multiply and add; a kernel of DFT_TAPS cells or more goes to cv2's DFT
# path, which filter2d does not model
FILTER2D_LANES = 16
DFT_TAPS = {np.dtype(np.float32): 130, np.dtype(np.float64): 50}


def _fma_f32(acc: np.ndarray, k: np.float32, x: np.ndarray) -> np.ndarray:
    """float32 fma(k, x, acc), correctly rounded: the exact product and
    the sum rounded to odd in float64 (TwoSum, then one step toward the
    error), then to float32 (53 >= 24 + 2 bits, so the second rounding is
    the only one that counts)."""
    a = acc.astype(np.float64)
    p = np.float64(k) * x.astype(np.float64)  # exact: 24 + 24 bits
    s = a + p
    bb = s - a
    err = (a - (s - bb)) + (p - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.copysign(np.inf, err)), s)
    return s.astype(np.float32)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D(img, -1, kernel) for a 2-D float32 or float64 image
    and a float32 kernel: the centred anchor, delta 0, BORDER_REFLECT_101,
    the direct path. The kernel's nonzero taps are summed in row-major
    order, the first one's product rounded. In float64 each tap is a
    multiply and an add; in float32 the columns below
    FILTER2D_LANES * (W // FILTER2D_LANES) take one FMA a tap and the tail
    columns a float32 multiply and add, as cv2's vector and scalar loops
    do. A kernel of DFT_TAPS cells or more raises (cv2 switches to its DFT
    there)."""
    img = np.asarray(img)
    kern = np.asarray(kernel, np.float32)
    if img.ndim != 2 or img.dtype not in DFT_TAPS or kern.ndim != 2:
        raise ValueError(f"filter2d takes a 2-D float32 or float64 image and a 2-D kernel, got "
                         f"{img.dtype} {img.shape} and {kern.shape}")
    kh, kw = kern.shape
    if kh * kw >= DFT_TAPS[img.dtype]:
        raise ValueError(f"a {kh}x{kw} kernel takes cv2.filter2D's DFT path for "
                         f"{img.dtype} images, which filter2d does not model")
    h, w = img.shape
    ay, ax = kh // 2, kw // 2
    src = np.pad(img, ((ay, kh - 1 - ay), (ax, kw - 1 - ax)), mode="reflect")
    taps = [(y, x, kern[y, x]) for y in range(kh) for x in range(kw) if kern[y, x] != 0]
    out = np.zeros_like(img)
    vec = FILTER2D_LANES * (w // FILTER2D_LANES)
    for i, (y, x, k) in enumerate(taps):
        win = src[y:y + h, x:x + w]
        if img.dtype == np.float64:
            prod = np.float64(k) * win
            out = prod if i == 0 else out + prod
            continue
        prod = k * win  # float32 product, rounded
        if i == 0:
            out = prod
            continue
        tail = out[:, vec:] + prod[:, vec:]
        out = np.concatenate([_fma_f32(out[:, :vec], k, win[:, :vec]), tail], 1)
    return out
