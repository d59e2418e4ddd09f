"""Epipolar algebra (port of tpu_vo/geometry/epipolar.py).

Correspondences satisfy x2^T F x1 = 0 in 0-based pixels, E = [t]_x R acts
on normalized coordinates, F = K^{-T} E K^{-1}.
"""

from __future__ import annotations

import torch

from tpu_vo_torch.geometry.camera import homogenize, invert_intrinsics
from tpu_vo_torch.geometry.se3 import skew


def essential_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R for relative motion x2 = R x1 + t."""
    return skew(t) @ R


def fundamental_from_essential(E: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """F = K^{-T} E K^{-1}."""
    Kinv = invert_intrinsics(K)
    return Kinv.transpose(-1, -2) @ E @ Kinv


def essential_from_fundamental(F: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """E = K^T F K."""
    return K.transpose(-1, -2) @ F @ K


def _apply(M: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) applied to every row of (..., N, 3): (..., N, 3)."""
    return h @ M.transpose(-1, -2)


def algebraic_residual(F: torch.Tensor, x1: torch.Tensor,
                       x2: torch.Tensor) -> torch.Tensor:
    """|x2^T F x1| per correspondence; x1/x2 are (..., N, 2) pixels."""
    h1 = homogenize(x1)
    h2 = homogenize(x2)
    return torch.abs((h2 * _apply(F, h1)).sum(-1))


def epipolar_line(F: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """l2 = F x1 for points (..., N, 2); returns (..., N, 3) line coeffs."""
    return _apply(F, homogenize(x1))


def point_line_distance(line: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Perpendicular pixel distance from (..., N, 2) points to (..., N, 3)
    lines; inf for a degenerate line."""
    a, b, c = line[..., 0], line[..., 1], line[..., 2]
    num = torch.abs(a * x[..., 0] + b * x[..., 1] + c)
    den = torch.sqrt(a * a + b * b)
    return torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12),
                       torch.full_like(den, float("inf")))


def sampson_error(E: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error of x2^T E x1 = 0.

    E: (..., 3, 3); x1/x2: (..., N, 2) in the coordinates E lives in
    (batch dims broadcast). Written out per entry so that scoring many
    hypotheses against many points allocates no (..., N, 3, 3) product.
    """
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    e = [[E[..., i, j, None] for j in range(3)] for i in range(3)]
    Ex1 = [e[i][0] * u1 + e[i][1] * v1 + e[i][2] for i in range(3)]
    Etx2 = [e[0][j] * u2 + e[1][j] * v2 + e[2][j] for j in range(2)]
    x2Ex1 = u2 * Ex1[0] + v2 * Ex1[1] + Ex1[2]
    denom = Ex1[0] ** 2 + Ex1[1] ** 2 + Etx2[0] ** 2 + Etx2[1] ** 2
    return (x2Ex1 * x2Ex1) / torch.clamp(denom, min=1e-18)


def normalize_frobenius(F: torch.Tensor) -> torch.Tensor:
    """Scale F to unit Frobenius norm (a zero F stays zero)."""
    n = torch.linalg.norm(F, dim=(-2, -1), keepdim=True)
    return torch.where(n > 0.0, F / torch.clamp(n, min=1e-30), F)


def one_based_shift_matrix(dtype=torch.float64, device=None) -> torch.Tensor:
    """T mapping 0-based pixel coords to 1-based."""
    return torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0], [0.0, 0.0, 1.0]],
                        dtype=dtype, device=device)


def convert_F_0based_to_1based(F0: torch.Tensor) -> torch.Tensor:
    """F1 = T^{-T} F0 T^{-1}."""
    Tinv = torch.linalg.inv(one_based_shift_matrix(F0.dtype, F0.device))
    return Tinv.transpose(-1, -2) @ F0 @ Tinv


def convert_F_1based_to_0based(F1: torch.Tensor) -> torch.Tensor:
    """F0 = T^T F1 T."""
    T = one_based_shift_matrix(F1.dtype, F1.device)
    return T.transpose(-1, -2) @ F1 @ T
