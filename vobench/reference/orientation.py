# Frozen copy of tpu_vo_torch/features/orientation.py (whole): the benchmark's reference.
"""Intensity-centroid orientation (ORB's ICAngles), cv2-exact (port of
tpu_vo/features/orientation.py).

`build_umax`, `moment_kernels` and `_circle_offsets` are copied from the
JAX package (pure numpy); `fast_atan2_deg` is OpenCV's fastAtan2
polynomial in float32. The dense formulations below take (..., H, W)
images and (..., N) keypoints. On integer-valued images every moment sum
is an integer below 2^24, so all three give the same float32 moments.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

HALF_PATCH = 15


# Copied from tpu_vo/features/orientation.py.
def build_umax(half_patch: int = HALF_PATCH) -> np.ndarray:
    """OpenCV's umax table: horizontal extent of the circular patch per row."""
    umax = np.zeros(half_patch + 2, dtype=np.int32)
    vmax = int(np.floor(half_patch * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(half_patch * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.round(np.sqrt(half_patch * half_patch - v * v)))
    # Symmetry fix-up (orb.cpp): make the circle 8-way symmetric.
    v0 = 0
    for v in range(half_patch, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: half_patch + 1]


# Copied from tpu_vo/features/orientation.py.
def moment_kernels(half_patch: int = HALF_PATCH):
    """(Ku, Kv): 31x31 kernels with u / v weights inside the circular mask."""
    umax = build_umax(half_patch)
    size = 2 * half_patch + 1
    Ku = np.zeros((size, size), dtype=np.float32)
    Kv = np.zeros((size, size), dtype=np.float32)
    for v in range(-half_patch, half_patch + 1):
        d = umax[abs(v)]
        for u in range(-d, d + 1):
            Ku[v + half_patch, u + half_patch] = u
            Kv[v + half_patch, u + half_patch] = v
    return Ku, Kv


_KU, _KV = moment_kernels()

_DEG = np.float32(180.0 / np.pi)
_P1 = float(np.float32(0.9997878412794807) * _DEG)
_P3 = float(np.float32(-0.3258083974640975) * _DEG)
_P5 = float(np.float32(0.1555786518463281) * _DEG)
_P7 = float(np.float32(-0.04432655554792128) * _DEG)
_EPS = float(np.float32(2.220446049250313e-16))  # (float)DBL_EPSILON


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV cv::fastAtan2: polynomial atan in float32, degrees [0, 360)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    ax, ay = torch.abs(x), torch.abs(y)
    c = torch.where(ax >= ay, ay / (ax + _EPS), ax / (ay + _EPS))
    c2 = c * c
    poly = (((_P7 * c2 + _P5) * c2 + _P3) * c2 + _P1) * c
    a = torch.where(ax >= ay, poly, 90.0 - poly)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


@functools.lru_cache(maxsize=None)
def _moment_weights(device: torch.device) -> torch.Tensor:
    """(2, 1, 31, 31) float64 conv weights (Kv, Ku) on `device`, copied
    once."""
    return torch.as_tensor(np.stack([_KV, _KU])[:, None], dtype=torch.float64,
                           device=device)


def moment_maps(img: torch.Tensor):
    """(m01, m10) dense moment maps of (..., H, W) images by 31x31
    correlation with zero padding. The correlation runs in float64 so that
    its sums are exact whatever algorithm the convolution picks (cuDNN may
    take an FFT for a 31x31 kernel, and TF32 would round the input), then
    rounds to float32."""
    h, w = img.shape[-2], img.shape[-1]
    x = img.reshape(-1, 1, h, w).to(torch.float64)
    out = torch.nn.functional.conv2d(x, _moment_weights(img.device),
                                     padding=HALF_PATCH).to(torch.float32)
    return out[:, 0].view(img.shape), out[:, 1].view(img.shape)


def _at(maps: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """maps[..., ys, xs] per image: (..., H, W) and (..., N) -> (..., N)."""
    idx = ys.to(torch.int64) * maps.shape[-1] + xs.to(torch.int64)
    return torch.gather(maps.flatten(-2), -1, idx)


def ic_angles(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Orientation in degrees at integer keypoint locations."""
    m01, m10 = moment_maps(img)
    return fast_atan2_deg(_at(m01, ys, xs), _at(m10, ys, xs))


# Copied from tpu_vo/features/orientation.py.
def _circle_offsets(half_patch: int = HALF_PATCH):
    """Static (P, 2) int offsets and (P,) u/v weights of the circular patch."""
    umax = build_umax(half_patch)
    offs, us, vs = [], [], []
    for v in range(-half_patch, half_patch + 1):
        d = umax[abs(v)]
        for u in range(-d, d + 1):
            offs.append((v, u))
            us.append(u)
            vs.append(v)
    return (np.asarray(offs, dtype=np.int32),
            np.asarray(us, dtype=np.float32),
            np.asarray(vs, dtype=np.float32))


_OFFS, _US, _VS = _circle_offsets()


@functools.lru_cache(maxsize=None)
def _circle_tables(device: torch.device):
    """(offs, us, vs) of the circular patch and the per-row (v, umax[|v|])
    of the prefix-sum form, on `device`, copied once."""
    v = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    return (torch.as_tensor(_OFFS, dtype=torch.int64, device=device),
            torch.as_tensor(_US, device=device),
            torch.as_tensor(_VS, device=device),
            torch.as_tensor(v, dtype=torch.int64, device=device),
            torch.as_tensor(build_umax()[np.abs(v)], dtype=torch.int64,
                            device=device))


def ic_angles_gather(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Orientation via a gather of the circular patch at each keypoint."""
    h, w = img.shape[-2], img.shape[-1]
    offs, us, vs, _, _ = _circle_tables(img.device)
    sy = torch.clamp(ys.to(torch.int64)[..., None] + offs[:, 0], 0, h - 1)
    sx = torch.clamp(xs.to(torch.int64)[..., None] + offs[:, 1], 0, w - 1)
    vals = torch.gather(img.to(torch.float32).flatten(-2), -1,
                        (sy * w + sx).flatten(-2)).view(sy.shape)   # (..., N, P)
    return fast_atan2_deg(vals @ vs, vals @ us)


def ic_angles_prefix(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Orientation via horizontal int32 prefix sums: each circular-patch
    row contributes sum_u u*I and sum_u I as two prefix-sum differences,
    so a keypoint gathers 31 rows x 4 prefix values instead of 725
    pixels. Exactly the gather formulation on integer-valued images."""
    h, w = img.shape[-2], img.shape[-1]
    _, _, _, v, d = _circle_tables(img.device)
    ii = torch.round(img).to(torch.int32)
    x_idx = torch.arange(w, dtype=torch.int32, device=img.device)
    pad = torch.nn.functional.pad
    p0 = pad(torch.cumsum(ii, -1, dtype=torch.int32), (1, 0)).flatten(-2)
    p1 = pad(torch.cumsum(ii * x_idx, -1, dtype=torch.int32), (1, 0)).flatten(-2)

    ys = ys.to(torch.int64)[..., None]
    xs = xs.to(torch.int64)[..., None]
    rows = torch.clamp(ys + v, 0, h - 1) * (w + 1)                   # (..., N, 31)
    hi = (rows + torch.clamp(xs + d + 1, 0, w)).flatten(-2)
    lo = (rows + torch.clamp(xs - d, 0, w)).flatten(-2)
    shape = rows.shape
    s0 = (torch.gather(p0, -1, hi) - torch.gather(p0, -1, lo)).view(shape)
    s1 = (torch.gather(p1, -1, hi) - torch.gather(p1, -1, lo)).view(shape)
    m10 = (s1 - xs.to(torch.int32) * s0).sum(-1)
    m01 = (v.to(torch.int32) * s0).sum(-1)
    return fast_atan2_deg(m01.to(torch.float32), m10.to(torch.float32))
