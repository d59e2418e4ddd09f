"""Epipolar algebra (port of tpu_vo/geometry/epipolar.py).

Correspondences satisfy x2^T F x1 = 0 in 0-based pixels, E = [t]_x R acts
on normalized coordinates, F = K^{-T} E K^{-1}.
"""

from __future__ import annotations

import torch

from tpu_vo_torch.geometry.camera import homogenize, invert_intrinsics


def fundamental_from_essential(E: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """F = K^{-T} E K^{-1}."""
    Kinv = invert_intrinsics(K)
    return Kinv.transpose(-1, -2) @ E @ Kinv


def _apply(M: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) applied to every row of (..., N, 3): (..., N, 3)."""
    return h @ M.transpose(-1, -2)


def algebraic_residual(F: torch.Tensor, x1: torch.Tensor,
                       x2: torch.Tensor) -> torch.Tensor:
    """|x2^T F x1| per correspondence; x1/x2 are (..., N, 2) pixels."""
    h1 = homogenize(x1)
    h2 = homogenize(x2)
    return torch.abs((h2 * _apply(F, h1)).sum(-1))


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
