"""Linear (DLT) triangulation and the cheirality test of cv::recoverPose
(port of tpu_vo/geometry/triangulation.py).

`cheirality_mask` keeps a point when its depth is positive and below
`distance_thresh` in both views. method="midpoint" (the default, the
pipeline's) takes the depth along the first ray from the cross-product
identity z1 (x2 x R x1) = -(x2 x t); method="dlt" triangulates like
cv::recoverPose, the null vector of each point's 4x4 DLT system by a
batched symmetric eigendecomposition.
"""

from __future__ import annotations

import torch

from tpu_vo_torch.geometry.camera import homogenize


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting cross product over the last axis."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _apply(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., r, c) applied to every row of (..., N, c): (..., N, r)."""
    return pts @ M.transpose(-1, -2)


def projection_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = [R | t] of shape (..., 3, 4) (camera extrinsic form)."""
    return torch.cat([R, t[..., :, None]], dim=-1)


def triangulate_dlt(P0: torch.Tensor, P1: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Linear triangulation of (..., N, 2) correspondences: the null vector
    of [x1 P0[2] - P0[0]; y1 P0[2] - P0[1]; x2 P1[2] - P1[0]; y2 P1[2] - P1[1]]
    as the eigenvector of A^T A with the least eigenvalue. Returns
    homogeneous points (..., N, 4), unnormalized (the sign is arbitrary)."""
    def rows(P, x):
        P = P[..., None, :, :]                                   # (..., 1, 3, 4)
        r0 = x[..., 0:1] * P[..., 2, :] - P[..., 0, :]           # (..., N, 4)
        r1 = x[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return torch.stack([r0, r1], dim=-2)                     # (..., N, 2, 4)

    A = torch.cat([rows(P0, x1), rows(P1, x2)], dim=-2)         # (..., N, 4, 4)
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0]


def _dlt_points(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """(Q (..., N, 4) homogeneous, w_safe (..., N)) under P0 = [I | 0] and
    P1 = [R | t]."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R)
    Q = triangulate_dlt(projection_matrix(eye, torch.zeros_like(t)),
                        projection_matrix(R, t), x1, x2)
    w = Q[..., 3]
    return Q, torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))


def cheirality_mask(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor, distance_thresh: float = 50.0,
                    method: str = "midpoint") -> torch.Tensor:
    """Boolean (..., N) mask of points in front of both cameras.

    R: (..., 3, 3), t: (..., 3), x1/x2: (..., N, 2) normalized coordinates.
    The two methods agree but for points near the depth cutoff under noise.
    """
    if method == "midpoint":
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
    if method != "dlt":
        raise ValueError(f"unknown cheirality method {method!r}")

    Q, w_safe = _dlt_points(R, t, x1, x2)
    ok = Q[..., 2] * Q[..., 3] > 0
    ok &= Q[..., 2] / w_safe < distance_thresh
    pc2 = _apply(R, Q[..., :3] / w_safe[..., None]) + t[..., None, :]
    ok &= pc2[..., 2] > 0
    ok &= pc2[..., 2] < distance_thresh
    return ok


def depths_in_both_views(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                         x2: torch.Tensor):
    """(z1, z2) depths of the DLT-triangulated points, for diagnostics."""
    Q, w_safe = _dlt_points(R, t, x1, x2)
    X = Q[..., :3] / w_safe[..., None]
    return X[..., 2], (_apply(R, X) + t[..., None, :])[..., 2]


def reprojection_error(P: torch.Tensor, X: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reprojection error of points X (..., N, 3) through the (..., 3, 4)
    projection P (including K if x is in pixels)."""
    proj = _apply(P, homogenize(X))
    z = torch.where(torch.abs(proj[..., 2]) > 1e-12, proj[..., 2],
                    torch.full_like(proj[..., 2], 1e-12))
    return torch.linalg.norm(proj[..., :2] / z[..., None] - x, dim=-1)
