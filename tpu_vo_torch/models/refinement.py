"""Sliding-window triangulation + Levenberg-Marquardt pose refinement
(port of tpu_vo/models/refinement.py; the benchmark's config 5, a mini
bundle adjustment the reference does not have).

  - refine_relative_pose_lm: two-view polish of P relative motions at
    once. Each motion is parameterized as (so3 tangent, translation
    direction) around its start and the masked Sampson error minimized
    by a fixed number of LM iterations, each accepted or rejected per
    pair by a mask, never by a branch on the data. The Jacobians are
    analytic (the Sampson error's gradient in E times E's derivative in
    the parameters, Rodrigues' derivative by Gallego and Yezzi): about
    450 dispatched ops an iteration for the whole window, half of them
    views, where a vmapped torch.func.jacfwd dispatches several times
    more through its wrappers; tests/test_torch_refinement.py holds them
    against jacfwd of `_residuals`. The 6x6 normal systems are solved
    by torch.linalg.solve_ex, whose info != 0 (a singular system)
    rejects the step as a non-finite one would be.
  - refine_window: every relative pose of a window of consecutive pairs,
    independently given their correspondences; the caller re-chains
    (pipeline/runner.refine_pairs, run_sequence_batched(refine_iters=n)).

On a CUDA device refine_relative_pose_lm (and so refine_window) replays
one CUDA graph per call signature (utils/cuda_graphs.GraphCache; iters
and lambda0 are in the signature): one launch in place of some 1,700 at
6 iterations over a window, bit for bit the eager loop. The signature
holds the TF32 matmul flag, which the capture fixes. CPU inputs run
eagerly.

Spans (utils/profiling.span): refine_window runs in `refine.lm`. The
eager loop holds each LM iteration in an `lm.step`; on CUDA `refine.lm`
holds `refine.capture` (a signature's first call, with the `lm.step`s
of its eager run and of its capture, host-only spans) and
`refine.replay`, where a replay opens no `lm.step`. Nothing here waits
for the card: no .item(), no boolean indexing, solve_ex without
check_errors.

The normal equations are fragile at reduced precision; the package keeps
TF32 off (tpu_vo_torch/__init__.py), and nothing here turns it on.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu_vo_torch.geometry.epipolar import essential_from_Rt
from tpu_vo_torch.geometry.se3 import skew
from tpu_vo_torch.utils.cuda_graphs import GraphCache
from tpu_vo_torch.utils.profiling import span


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) by Rodrigues, with series forms
    below theta^2 = 1e-12 so that it is smooth (and differentiable) at 0."""
    theta2 = (w * w).sum(-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = skew(w)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(K)
    return eye + a * K + b * (K @ K)


class LMResult(NamedTuple):
    R: torch.Tensor         # (..., 3, 3) refined rotation
    t: torch.Tensor         # (..., 3) refined unit translation
    cost: torch.Tensor      # (...,) final masked mean Sampson error
    improved: torch.Tensor  # (...,) bool: refinement lowered the cost


@functools.lru_cache(maxsize=None)
def _constants(dtype: torch.dtype, device: torch.device):
    """(I, the generators [e_k]_x (3, 3, 3), the mask (1, 1, 0)) on the
    device, built once, and by kernels: no copy from the host, which would
    wait for the card."""
    eye = torch.eye(3, dtype=dtype, device=device)
    return eye, skew(eye), (torch.arange(3, device=device) < 2).to(dtype)


def _motion(p, R0, t0):
    """(R, t) = (exp(w) R0, normalized t0 + dt) for params p (..., 6)."""
    R = so3_exp(p[..., :3]) @ R0
    t = t0 + p[..., 3:]
    return R, t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)


def _sampson(E, h1, h2):
    """(err, s, D_raw, E h1, E^T h2) of the Sampson error s^2 / max(D,
    1e-18) of homogeneous (..., N, 3) points, a non-finite error as 1e6."""
    Ex1 = h1 @ E.transpose(-1, -2)
    Etx2 = h2 @ E
    s = (h2 * Ex1).sum(-1)
    D_raw = (Ex1[..., :2] ** 2).sum(-1) + (Etx2[..., :2] ** 2).sum(-1)
    err = (s * s) / torch.clamp(D_raw, min=1e-18)
    return torch.where(torch.isfinite(err), err, torch.full_like(err, 1e6)), s, D_raw, Ex1, Etx2


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _residuals(p, x1, x2, w_mask, R0, t0):
    """Masked square-root Sampson residuals (..., N) at params p (..., 6)."""
    R, t = _motion(p, R0, t0)
    err = _sampson(essential_from_Rt(R, t), _homogeneous(x1), _homogeneous(x2))[0]
    return torch.sqrt(torch.clamp(err, min=1e-24)) * w_mask


def _so3_exp_derivatives(w: torch.Tensor, Rw: torch.Tensor) -> torch.Tensor:
    """d exp(w) / d w_k at Rw = exp(w), (..., 3, 3, 3) indexed [k]:
    (w_k [w]_x + [w x (I - exp(w)) e_k]_x) exp(w) / theta^2, and the
    generator [e_k]_x plus its first-order term below theta^2 = 1e-12."""
    eye, gens, _ = _constants(w.dtype, w.device)
    theta2 = (w * w).sum(-1)[..., None, None, None]
    K = skew(w)[..., None, :, :]
    cols = (eye - Rw).transpose(-1, -2)                       # rows: ((I - R) e_k)^T
    v = torch.linalg.cross(w[..., None, :].expand_as(cols), cols)
    big = (w[..., :, None, None] * K + skew(v)) @ Rw[..., None, :, :] / torch.clamp(theta2,
                                                                                    min=1e-24)
    small = gens + 0.5 * (gens @ K + K @ gens)
    return torch.where(theta2 < 1e-12, small, big)


def _residuals_and_jacobian(p, x1, x2, w_mask, R0, t0):
    """Residuals (P, N) and their Jacobian (P, N, 6) at params p (P, 6):
    d r / d E (the Sampson error's gradient) times d E / d p."""
    eye, _, lead2 = _constants(p.dtype, p.device)
    Rw = so3_exp(p[..., :3])
    R = Rw @ R0
    t_raw = t0 + p[..., 3:]
    n = torch.clamp(torch.linalg.norm(t_raw, dim=-1, keepdim=True), min=1e-12)
    t = t_raw / n
    tx = skew(t)
    dR = _so3_exp_derivatives(p[..., :3], Rw) @ R0[..., None, :, :]     # (P, 3, 3, 3)
    dt = (eye - t[..., :, None] * t[..., None, :]) / n[..., None]       # (P, 3 (t), 3 (dt_j))
    dE = torch.cat([tx[..., None, :, :] @ dR,                          # d/dw_k
                    skew(dt.transpose(-1, -2)) @ R[..., None, :, :]],  # d/ddt_j
                   dim=-3).flatten(-2).transpose(-1, -2)              # (P, 9, 6)

    h1, h2 = _homogeneous(x1), _homogeneous(x2)
    err, s, D_raw, Ex1, Etx2 = _sampson(tx @ R, h1, h2)
    root = torch.sqrt(torch.clamp(err, min=1e-24))
    # d err / d E_ab = 2 q x2_a x1_b - q^2 dD/dE_ab with q = s / D, and
    # dD/dE_ab = 2 (E x1)_a x1_b [a < 2] + 2 (E^T x2)_b x2_a [b < 2]
    q = (s / torch.clamp(D_raw, min=1e-18))[..., None, None]
    dD = torch.where((D_raw > 1e-18)[..., None, None],
                     2.0 * ((Ex1 * lead2)[..., :, None] * h1[..., None, :]
                            + h2[..., :, None] * (Etx2 * lead2)[..., None, :]), 0.0)
    derr = 2.0 * q * h2[..., :, None] * h1[..., None, :] - q * q * dD      # (P, N, 3, 3)
    dr = torch.where(err > 1e-24, 0.5 / root, 0.0) * w_mask              # err 1e6: no slope
    dr = torch.where(torch.isfinite(s * s / torch.clamp(D_raw, min=1e-18)), dr, 0.0)
    return root * w_mask, (dr[..., None, None] * derr).flatten(-2) @ dE


def refine_relative_pose_lm(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor,
                            R0: torch.Tensor, t0: torch.Tensor, iters: int = 8,
                            lambda0: float = 1e-3) -> LMResult:
    """LM polish of relative motions on masked normalized correspondences.

    x1, x2: (N, 2) or (P, N, 2) normalized coordinates; mask (N,) or
    (P, N) inliers; R0 (..., 3, 3), t0 (..., 3). Minimizes the Sampson
    error of E = [t]_x R with R = exp(w) R0, t = norm(t0 + dt). A pair
    whose cost did not fall keeps (R0, t0). CUDA inputs replay the
    signature's CUDA graph, CPU inputs run eagerly; the results are the
    same bit for bit.
    """
    if x1.dim() == 2:
        out = refine_relative_pose_lm(x1[None], x2[None], mask[None], R0[None], t0[None],
                                      iters, lambda0)
        return LMResult(*(v[0] for v in out))
    return LMResult(*_refine_graphs(x1, x2, mask, R0, t0, iters, lambda0))


def _refine(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor, R0: torch.Tensor,
            t0: torch.Tensor, iters: int, lambda0: float = 1e-3):
    """refine_relative_pose_lm on (P, N, 2) inputs, eagerly: (R, t, cost,
    improved), some 270 kernel launches an iteration whatever P, each
    iteration in an `lm.step` span."""
    dtype, dev = x1.dtype, x1.device
    n_inl = torch.clamp(mask.sum(-1), min=1).to(dtype)
    w_mask = mask.to(dtype)
    args = (x1, x2, w_mask, R0, t0)

    def cost_of(p):
        r = _residuals(p, *args)
        return (r * r).sum(-1) / n_inl

    p = torch.zeros(x1.shape[0], 6, dtype=dtype, device=dev)
    c0 = cost_of(p)
    c = c0
    lam = torch.full_like(c0, lambda0)
    for _ in range(iters):
        with span("lm.step"):
            r, J = _residuals_and_jacobian(p, *args)             # (P, N), (P, N, 6)
            JtJ = J.transpose(-1, -2) @ J
            g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
            A = JtJ + lam[:, None, None] * torch.diag_embed(
                torch.diagonal(JtJ, dim1=-2, dim2=-1) + 1e-12)
            step, info = torch.linalg.solve_ex(A, g)
            p_new = p - step
            c_new = cost_of(p_new)
            accept = (c_new < c) & torch.isfinite(p_new).all(-1) & (info == 0)
            p = torch.where(accept[:, None], p_new, p)
            c = torch.where(accept, c_new, c)
            lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 4.0), 1e-9, 1e6)
    R, t = _motion(p, R0, t0)
    improved = c < c0
    R = torch.where(improved[:, None, None], R, R0)
    t = torch.where(improved[:, None], t, t0)
    return R, t, torch.minimum(c, c0), improved


_refine_graphs = GraphCache("refine", _refine)


def triangulate_pair_points(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                            x2: torch.Tensor) -> torch.Tensor:
    """Closed-form ray-depth triangulation of (..., N, 2) normalized
    correspondences under x2 ~ R x1 + t; returns (..., N, 3) points in
    camera 1."""
    ones = torch.ones_like(x1[..., :1])
    h1 = torch.cat([x1, ones], dim=-1)
    h2 = torch.cat([x2, ones], dim=-1)
    Rx1 = h1 @ R.transpose(-1, -2)
    a = torch.linalg.cross(h2, Rx1)
    b = torch.linalg.cross(h2, t[..., None, :].expand_as(h2))
    z1 = -(a * b).sum(-1) / torch.clamp((a * a).sum(-1), min=1e-18)
    return h1 * z1[..., None]


class WindowRefineResult(NamedTuple):
    R_rel: torch.Tensor     # (P, 3, 3) refined relative rotations
    t_rel: torch.Tensor     # (P, 3) refined unit translations
    cost: torch.Tensor      # (P,) final costs
    improved: torch.Tensor  # (P,) bool


def refine_window(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor,
                  R_rel: torch.Tensor, t_rel: torch.Tensor,
                  iters: int = 8) -> WindowRefineResult:
    """Refine every relative pose of a window of consecutive pairs.

    x1, x2: (P, N, 2) per-pair normalized correspondences; mask (P, N);
    R_rel (P, 3, 3), t_rel (P, 3) initial motions (RANSAC + recover). The
    pairs are independent given their correspondences, so all refine at
    once; the caller re-chains the trajectory.
    """
    with span("refine.lm"):
        out = refine_relative_pose_lm(x1, x2, mask, R_rel, t_rel, iters)
    return WindowRefineResult(out.R, out.t, out.cost, out.improved)
