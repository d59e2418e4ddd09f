# Frozen copy of tpu_vo_torch/features/patches.py (whole): the benchmark's reference.
"""Orientation, blur and steered rBRIEF from one 43x43 window per
keypoint (port of tpu_vo/features/patches.py).

  raw window (43x43, radius 21; ops/patch.py)
    ├─ center 31x31 → intensity-centroid moments → angle
    ├─ separable 7-tap Gaussian, same f32 kernel and left-fold tap order
    │  as cv::GaussianBlur's emulation → blurred window (37x37, radius 18)
    └─ steered rBRIEF samples gathered from the blurred window

Moments are sums of integral values below 2^24 and so exact in any order;
the blur rounds each product and sum on its own in eager torch, like the
JAX package run op by op.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vobench.reference import brief, orientation
from vobench.reference.filters import gaussian_kernel_1d

SAMPLE_RADIUS = 18      # max |cvRound(rotated pattern offset)|
BLUR_PAD = 3            # GaussianBlur ksize=7
RAW_RADIUS = SAMPLE_RADIUS + BLUR_PAD   # 21
RAW_SIZE = 2 * RAW_RADIUS + 1           # 43
BLUR_SIZE = 2 * SAMPLE_RADIUS + 1       # 37
_MOM_LO = RAW_RADIUS - orientation.HALF_PATCH   # 6
_MOM_HI = _MOM_LO + 2 * orientation.HALF_PATCH + 1  # 37


@functools.lru_cache(maxsize=None)
def _moment_kernels(device: torch.device):
    """The 31x31 moment kernels on `device`, copied once (a copy from
    pageable host memory waits for the stream to drain)."""
    return (torch.as_tensor(orientation._KU, device=device),
            torch.as_tensor(orientation._KV, device=device))


def extract_patches(lvl: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    radius: int = RAW_RADIUS) -> torch.Tensor:
    """(N, 2r+1, 2r+1) windows centered at integer keypoints, with the
    semantics of tpu_vo's vmapped lax.dynamic_slice: a level smaller than
    the window is zero-padded at its bottom and right first; a negative
    start counts from the end of its axis; every start is then clamped
    into [0, dim - size]. Plain PyTorch: tpu_vo's non-Pallas ORB route
    and the reference that B2 (ops/patch.py) is written against."""
    size = 2 * radius + 1
    h, w = lvl.shape
    if h < size or w < size:
        lvl = torch.nn.functional.pad(lvl, (0, max(0, size - w), 0, max(0, size - h)))
        h, w = lvl.shape

    def starts(c, dim):
        s = c.to(torch.int64) - radius
        return torch.clamp(torch.where(s < 0, s + dim, s), 0, dim - size)

    offs = torch.arange(size, device=lvl.device)
    rows = starts(ys, h)[:, None] + offs
    cols = starts(xs, w)[:, None] + offs
    return lvl[rows[:, :, None], cols[:, None, :]]


def angles_from_patches(raw: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (degrees) from (..., 43, 43) windows."""
    p31 = raw[..., _MOM_LO:_MOM_HI, _MOM_LO:_MOM_HI]
    ku, kv = _moment_kernels(raw.device)
    m10 = (p31 * ku).sum((-2, -1))
    m01 = (p31 * kv).sum((-2, -1))
    return orientation.fast_atan2_deg(m01, m10)


def blur_patches(raw: torch.Tensor, ksize: int = 7,
                 sigma: float = 2.0) -> torch.Tensor:
    """(..., 37, 37) Gaussian-blurred window centers on the integer grid."""
    k = [float(v) for v in gaussian_kernel_1d(ksize, sigma).astype(np.float32)]
    n = raw.shape[-1] - 2 * BLUR_PAD
    x = raw.to(torch.float32)
    acc = x[..., :, 0:n] * k[0]
    for i in range(1, ksize):
        acc = acc + x[..., :, i:i + n] * k[i]
    x = acc
    acc = x[..., 0:n, :] * k[0]
    for i in range(1, ksize):
        acc = acc + x[..., i:i + n, :] * k[i]
    return torch.clamp(torch.round(acc), 0.0, 255.0)


def sample_steered(blurred: torch.Tensor, angles_deg: torch.Tensor) -> torch.Tensor:
    """(..., 512) steered rBRIEF sample values from (..., 37, 37) blurred
    windows: an exact gather at the rotated offsets."""
    dy, dx = brief.steered_offsets(angles_deg)
    flat = (dy + SAMPLE_RADIUS) * BLUR_SIZE + (dx + SAMPLE_RADIUS)
    return torch.gather(blurred.flatten(-2), -1, flat)


def descriptor_bits_from_patches(raw: torch.Tensor,
                                 angles_deg: torch.Tensor) -> torch.Tensor:
    """(..., 256) descriptor bits from raw windows and angles."""
    vals = sample_steered(blur_patches(raw), angles_deg)
    return vals[..., 0::2] < vals[..., 1::2]
