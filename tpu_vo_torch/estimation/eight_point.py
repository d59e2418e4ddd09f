"""Masked, batched normalized 8-point essential estimation (port of
tpu_vo/estimation/eight_point.py): the LO refit after RANSAC.

The nullspace comes from the 9x9 normal matrix A^T A by a symmetric
eigendecomposition; eigenvector signs differ between LAPACK and
cuSOLVER, so E is defined up to sign. Both decompositions go through
estimation/solve, torch.linalg's results without a wait for the card.
"""

from __future__ import annotations

import functools
import math

import torch

from tpu_vo_torch.estimation import solve


def _constraint_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., N, 9) rows a_i with a_i . vec(E) = x2_i^T E x1_i."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], dim=-1)


def normalize_for_conditioning(x: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization over the masked points: zero mean, mean
    distance sqrt(2). Returns (x_norm, T) with x_norm_h = T @ x_h."""
    m = mask[..., None].to(x.dtype)
    cnt = torch.clamp(m.sum(-2), min=1.0)
    mean = (x * m).sum(-2) / cnt
    centered = (x - mean[..., None, :]) * m
    dist = torch.linalg.norm(centered, dim=-1)
    mean_dist = dist.sum(-1) / torch.clamp(cnt[..., 0], min=1.0)
    scale = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-12)
    x_norm = (x - mean[..., None, :]) * scale[..., None, None]
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], dim=-1),
        torch.stack([zero, scale, -scale * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return x_norm, T


def fit_fundamental_linear(x1: torch.Tensor, x2: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Least-squares 3x3 G minimizing sum (x2^T G x1)^2 over the mask."""
    x1n, T1 = normalize_for_conditioning(x1, mask)
    x2n, T2 = normalize_for_conditioning(x2, mask)
    A = _constraint_rows(x1n, x2n) * mask[..., None].to(x1.dtype)
    _, vecs = solve.eigh(A.transpose(-1, -2) @ A)
    G = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    return T2.transpose(-1, -2) @ G @ T1


@functools.lru_cache(maxsize=None)
def _essential_singular_values(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(1, 1, 0) on `device`, copied once (a copy from pageable host
    memory waits for the stream to drain)."""
    return torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=device)


def project_to_essential(G: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (1, 1, 0)."""
    U, _, Vt = solve.svd(G)
    return (U * _essential_singular_values(G.dtype, G.device)) @ Vt


def estimate_essential_8pt(x1: torch.Tensor, x2: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point essential estimate from masked (..., N, 2)
    normalized correspondences; returns (..., 3, 3)."""
    return project_to_essential(fit_fundamental_linear(x1, x2, mask))
