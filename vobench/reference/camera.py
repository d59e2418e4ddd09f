# Frozen copy of tpu_vo_torch/geometry/camera.py (whole): the benchmark's reference.
"""Pinhole intrinsics utilities (port of tpu_vo/geometry/camera.py).

K is derived from image size like the reference: fx = fy = W, cx = W/2,
cy = H/2. Points are 0-based pixel coordinates treated as homogeneous
x = [u, v, 1]^T.
"""

from __future__ import annotations

import torch


def intrinsics_from_image_size(width: int, height: int, dtype=torch.float32,
                               device=None) -> torch.Tensor:
    """K = [[W, 0, W/2], [0, W, H/2], [0, 0, 1]], the reference's rule."""
    w, h = float(width), float(height)
    return intrinsics(w, w, w / 2.0, h / 2.0, dtype=dtype, device=device)


def intrinsics(fx, fy, cx, cy, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=dtype,
        device=device)


def invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of an upper-triangular pinhole K."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    s = K[..., 0, 1]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    row0 = torch.stack([1.0 / fx, -s / (fx * fy),
                        (s * cy - cx * fy) / (fx * fy)], dim=-1)
    row1 = torch.stack([zero, 1.0 / fy, -cy / fy], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def normalize_points(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel (..., 2) -> normalized camera coordinates x_hat = K^{-1} x."""
    u = (pts[..., 0] - K[..., 0, 2]) / K[..., 0, 0]
    v = (pts[..., 1] - K[..., 1, 2]) / K[..., 1, 1]
    return torch.stack([u, v], dim=-1)


def denormalize_points(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Normalized camera coords (..., 2) -> pixels."""
    u = pts[..., 0] * K[..., 0, 0] + K[..., 0, 2]
    v = pts[..., 1] * K[..., 1, 1] + K[..., 1, 2]
    return torch.stack([u, v], dim=-1)


def homogenize(pts: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (..., 3) homogeneous with trailing 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def project(pts_c: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points (..., 3) -> pixel coordinates (..., 2)."""
    return denormalize_points(pts_c[..., :2] / pts_c[..., 2:3], K)
