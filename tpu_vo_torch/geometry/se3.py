"""SE(3) rigid transforms stored camera->world (port of tpu_vo/geometry/se3.py).

A pose holds (R_wc, t_wc) with x_w = R_wc @ x_c + t_wc. All functions
broadcast over leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pose(NamedTuple):
    """Camera->world rigid transform. R: (..., 3, 3), t: (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "Pose":
        R = torch.eye(3, dtype=dtype, device=device).expand(
            *batch_shape, 3, 3).clone()
        t = torch.zeros(*batch_shape, 3, dtype=dtype, device=device)
        return Pose(R, t)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def compose(a: Pose, b: Pose) -> Pose:
    """a then b in a's frame: T_a @ T_b (matrix composition order)."""
    return Pose(a.R @ b.R, _matvec(a.R, b.t) + a.t)


def cumulative_compose(rel: Pose) -> Pose:
    """Inclusive prefix composition of relative poses along axis 0.

    cum[i] = rel[0] ∘ rel[1] ∘ ... ∘ rel[i]. Hillis–Steele doubling:
    ceil(log2 n) levels of one batched 3x3 matmul each, in full f32
    (the package turns TF32 off at import).
    """
    R, t = rel.R, rel.t
    n = R.shape[0]
    d = 1
    while d < n:
        c = compose(Pose(R[:-d], t[:-d]), Pose(R[d:], t[d:]))
        R = torch.cat([R[:d], c.R], dim=0)
        t = torch.cat([t[:d], c.t], dim=0)
        d *= 2
    return Pose(R, t)


def invert_relative(R_c2_c1: torch.Tensor, t_c2_c1: torch.Tensor):
    """Invert x_c2 = R x_c1 + t into x_c1 = R^T x_c2 - R^T t."""
    RT = R_c2_c1.transpose(-1, -2)
    return RT, -_matvec(RT, t_c2_c1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [v]_x of shape (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)
