# Frozen copy of tpu_vo_torch/geometry/se3.py (whole): the benchmark's reference.
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


def homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Stack (R, t) into a homogeneous (..., 4, 4) transform."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(*batch, 1, 4)
    return torch.cat([top, bottom], dim=-2)


def inverse(pose: Pose) -> Pose:
    """Invert: (R, t) -> (R^T, -R^T t)."""
    RT = pose.R.transpose(-1, -2)
    return Pose(RT, -_matvec(RT, pose.t))


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


def transform_points(pose: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply x_w = R x + t to points of shape (..., 3)."""
    return _matvec(pose.R, pts) + pose.t


def invert_relative(R_c2_c1: torch.Tensor, t_c2_c1: torch.Tensor):
    """Invert x_c2 = R x_c1 + t into x_c1 = R^T x_c2 - R^T t."""
    RT = R_c2_c1.transpose(-1, -2)
    return RT, -_matvec(RT, t_c2_c1)


def compose_next_pose(prev: Pose, R_c1_c2: torch.Tensor, t_c1_c2: torch.Tensor,
                      scale: torch.Tensor) -> Pose:
    """T_w_c2 = T_w_c1 * T_c1_c2 with the translation increment scaled:
    R = R_prev R_c1_c2, t = t_prev + scale * (R_prev t_c1_c2), so scale 0
    is the reference's rotation-only fallback."""
    return Pose(prev.R @ R_c1_c2, prev.t + scale[..., None] * _matvec(prev.R, t_c1_c2))


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [v]_x of shape (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def rotation_from_axis_angle(axis: torch.Tensor, angle) -> torch.Tensor:
    """Rodrigues rotation from unit axis (..., 3) and angle (...,)."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    K = skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand_as(K)
    return eye + s * K + (1.0 - c) * (K @ K)


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion (x, y, z, w), TUM convention, by
    Shepperd's method: the candidate of the largest diagonal combination."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-24))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)
    pick = torch.argmax(torch.stack([tr, m00, m11, m22], -1), -1)
    qs = torch.stack([q0, q1, q2, q3], -2)
    q = torch.gather(qs, -2, pick[..., None, None].expand(*pick.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (x, y, z, w) -> (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)


def geodesic_rotation_distance(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle (radians) between two rotations."""
    tr = torch.diagonal(Ra.transpose(-1, -2) @ Rb, dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
