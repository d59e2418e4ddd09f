"""Cheirality test of cv::recoverPose (port of
tpu_vo/geometry/triangulation.py, closed-form midpoint method).

Depth along the first ray from the cross-product identity
z1 (x2 x R x1) = -(x2 x t); a point passes when its depth is positive
and below `distance_thresh` in both views.
"""

from __future__ import annotations

import torch

from tpu_vo_torch.geometry.camera import homogenize


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting cross product over the last axis."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def cheirality_mask(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor, distance_thresh: float = 50.0) -> torch.Tensor:
    """Boolean (..., N) mask of points in front of both cameras.

    R: (..., 3, 3), t: (..., 3), x1/x2: (..., N, 2) normalized coordinates.
    """
    h1 = homogenize(x1)
    h2 = homogenize(x2)
    Rx1 = (R.unsqueeze(-3) * h1.unsqueeze(-2)).sum(-1)        # (..., N, 3)
    a = _cross(h2, Rx1)                                        # x2 x R x1
    b = _cross(h2, t.unsqueeze(-2))
    denom = (a * a).sum(-1)
    z1 = -(a * b).sum(-1) / torch.clamp(denom, min=1e-18)
    z2 = z1 * Rx1[..., 2] + t[..., None, 2]
    ok = (z1 > 0) & (z1 < distance_thresh)
    ok &= (z2 > 0) & (z2 < distance_thresh)
    ok &= denom > 1e-18
    return ok
