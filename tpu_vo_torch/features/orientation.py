"""Intensity-centroid orientation (ORB's ICAngles), cv2-exact (port of
tpu_vo/features/orientation.py).

`build_umax` and `moment_kernels` are copied from the JAX package (pure
numpy); `fast_atan2_deg` is OpenCV's fastAtan2 polynomial in float32.
"""

from __future__ import annotations

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
