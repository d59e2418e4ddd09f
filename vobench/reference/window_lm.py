"""The reference run of a cell that refines every pair's motion after
stage 2 (tpu_vo's config 5): the reference pipeline's features and
estimates, every pair's relative motion polished by Levenberg-Marquardt
over its RANSAC inliers, and the chain over the polished motions.

The refinement is written here from its published description, not
copied from the program:

  - a motion is (R, t) = (exp(w) R0, (t0 + d) / |t0 + d|) for the six
    parameters p = (w, d) around RANSAC's (R0, t0), exp by Rodrigues;
  - the cost is the mean over the inliers of the Sampson error
    s^2 / D of E = [t]x R, s = x2^T E x1, D the squared first two
    entries of E x1 and of E^T x2; each point's residual is its root;
  - the Jacobian is the chain rule written out: for each parameter j,
    dE_j = [t]x dR_j (rotation) or [dt_j]x R (translation), with
    Rodrigues' derivative by Gallego and Yezzi (J. Math. Imaging Vis.
    51, 2015, eq. 9): d exp(w)/dw_k = (w_k [w]x + [w x (I - exp(w)) e_k]x)
    exp(w) / |w|^2, and dt/dd = (I - t t^T) / |t0 + d|; then
    ds/dp_j = x2^T dE_j x1 and dD/dp_j = 2 sum of the first two entries
    of (E x1) * (dE_j x1) and of (E^T x2) * (dE_j^T x2);
  - each iteration solves (J^T J + lambda diag(J^T J)) step = J^T r per
    pair, takes p - step where the cost falls, and scales lambda by 0.3
    on a step taken and by 4 on one refused; a pair whose cost did not
    fall keeps (R0, t0).

Departures from that description, each one the program's (tpu_vo's
models/refinement), so that both compute one function:
  - below |w|^2 = 1e-12, exp and its derivative take their series forms
    (1 - |w|^2 / 6, 1/2 - |w|^2 / 24; the generator plus half the
    symmetrised product with [w]x), since at w = 0, where every pair
    starts, the closed forms are 0 / 0;
  - D is floored at 1e-18 (no slope of D below it), a non-finite error
    counts as 1e6 with no slope, an error is floored at 1e-24 before
    its root (no slope below), |t0 + d| at 1e-12;
  - lambda starts at 1e-3, is held in [1e-9, 1e6], and diag(J^T J) gets
    1e-12 more; a step is also refused where it is not finite or where
    the 6x6 system is singular (torch.linalg.solve_ex's info);
  - the cost divides by the inlier count floored at 1.

Plain torch, batched over the pairs, in the inputs' precision; it
imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference import camera, pipeline
from vobench.reference.se3 import Pose

LAMBDA0 = 1e-3


class Refined(NamedTuple):
    R_rel: torch.Tensor     # (P, 3, 3)
    t_rel: torch.Tensor     # (P, 3)
    cost: torch.Tensor      # (P,)
    improved: torch.Tensor  # (P,) bool


def hat(v: torch.Tensor) -> torch.Tensor:
    """[v]x of (..., 3) vectors, (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """exp([w]x) = I + sin|w|/|w| [w]x + (1 - cos|w|)/|w|^2 [w]x^2."""
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(torch.clamp(th2, min=1e-24))
    small = th2 < 1e-12
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-24))
    K = hat(w)
    return _eye(w) + a * K + b * (K @ K)


def rodrigues_derivative(w: torch.Tensor, k: int) -> torch.Tensor:
    """d exp([w]x) / d w_k, (..., 3, 3): Gallego and Yezzi's closed form,
    its series below |w|^2 = 1e-12."""
    R = rodrigues(w)
    th2 = (w * w).sum(-1)[..., None, None]
    e_k = torch.zeros_like(w)
    e_k[..., k] = 1.0
    col = ((_eye(w) - R) @ e_k[..., None])[..., 0]                  # (I - R) e_k
    closed = (w[..., k, None, None] * hat(w) + hat(torch.linalg.cross(w, col))) @ R
    closed = closed / torch.clamp(th2, min=1e-24)
    G, K = hat(e_k), hat(w)
    series = G + 0.5 * (G @ K + K @ G)
    return torch.where(th2 < 1e-12, series, closed)


def motion(p: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor):
    """(R, t, |t0 + d|) of the parameters p (..., 6) around (R0, t0)."""
    R = rodrigues(p[..., :3]) @ R0
    t_raw = t0 + p[..., 3:]
    n = torch.clamp(torch.linalg.vector_norm(t_raw, dim=-1), min=1e-12)
    return R, t_raw / n[..., None], n


def _sampson(E, h1, h2):
    """(error, s, D, E x1, E^T x2) of each point, (P, N) and (P, N, 3):
    the error floored and a non-finite one 1e6, as the module says."""
    Ex1 = torch.einsum("...ab,...nb->...na", E, h1)
    Etx2 = torch.einsum("...ba,...nb->...na", E, h2)
    s = (h2 * Ex1).sum(-1)
    D = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    err = s * s / torch.clamp(D, min=1e-18)
    return torch.where(torch.isfinite(err), err, torch.full_like(err, 1e6)), s, D, Ex1, Etx2


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def residuals(p, x1, x2, w, R0, t0) -> torch.Tensor:
    """Each point's residual (P, N): the root of its Sampson error, times
    its weight (1 on an inlier, 0 elsewhere)."""
    R, t, _ = motion(p, R0, t0)
    err = _sampson(hat(t) @ R, _homogeneous(x1), _homogeneous(x2))[0]
    return torch.sqrt(torch.clamp(err, min=1e-24)) * w


def residuals_and_jacobian(p, x1, x2, w, R0, t0):
    """(residuals (P, N), their Jacobian (P, N, 6)) by the chain rule of
    the module's description, one parameter at a time."""
    R, t, n = motion(p, R0, t0)
    E = hat(t) @ R
    h1, h2 = _homogeneous(x1), _homogeneous(x2)
    err, s, D, Ex1, Etx2 = _sampson(E, h1, h2)
    root = torch.sqrt(torch.clamp(err, min=1e-24))
    finite = torch.isfinite(s * s / torch.clamp(D, min=1e-18))
    # d root / d err where it has a slope (above the floor, finite)
    droot = torch.where((err > 1e-24) & finite, 0.5 / root, torch.zeros_like(root)) * w
    Dc = torch.clamp(D, min=1e-18)
    has_dD = D > 1e-18
    dt = (_eye(t) - t[:, :, None] * t[:, None, :]) / n[:, None, None]   # columns: dt/dd_j
    cols = []
    for j in range(6):
        if j < 3:
            dE = hat(t) @ rodrigues_derivative(p[:, :3], j) @ R0
        else:
            dE = hat(dt[:, :, j - 3]) @ R
        dEx1 = torch.einsum("pab,pnb->pna", dE, h1)
        dEtx2 = torch.einsum("pba,pnb->pna", dE, h2)
        ds = (h2 * dEx1).sum(-1)
        dD = torch.where(has_dD, 2.0 * (Ex1[..., 0] * dEx1[..., 0] + Ex1[..., 1] * dEx1[..., 1]
                                        + Etx2[..., 0] * dEtx2[..., 0]
                                        + Etx2[..., 1] * dEtx2[..., 1]), torch.zeros_like(D))
        derr = 2.0 * s / Dc * ds - (s / Dc) ** 2 * dD
        cols.append(droot * derr)
    return root * w, torch.stack(cols, -1)


def refine_window(x1, x2, mask, R0, t0, iters: int, lambda0: float = LAMBDA0) -> Refined:
    """`iters` LM iterations on each of P pairs: x1, x2 (P, N, 2)
    normalized correspondences, mask (P, N) the inliers, (R0, t0) the
    start. Returns the refined motions, the final cost and `improved`
    (the cost fell); a pair that did not improve keeps (R0, t0)."""
    w = mask.to(x1.dtype)
    n_inl = torch.clamp(mask.sum(-1), min=1).to(x1.dtype)

    def cost(p):
        r = residuals(p, x1, x2, w, R0, t0)
        return (r * r).sum(-1) / n_inl

    p = torch.zeros(x1.shape[0], 6, dtype=x1.dtype, device=x1.device)
    c0 = cost(p)
    c, lam = c0, torch.full_like(c0, lambda0)
    for _ in range(iters):
        r, J = residuals_and_jacobian(p, x1, x2, w, R0, t0)
        JtJ = torch.einsum("pni,pnj->pij", J, J)
        g = torch.einsum("pni,pn->pi", J, r)
        A = JtJ + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(JtJ, dim1=-2, dim2=-1) + 1e-12)
        step, info = torch.linalg.solve_ex(A, g)
        p_try = p - step
        c_try = cost(p_try)
        take = (c_try < c) & torch.isfinite(p_try).all(-1) & (info == 0)
        p = torch.where(take[:, None], p_try, p)
        c = torch.where(take, c_try, c)
        lam = torch.clamp(torch.where(take, lam * 0.3, lam * 4.0), 1e-9, 1e6)
    R, t, _ = motion(p, R0, t0)
    improved = c < c0
    return Refined(torch.where(improved[:, None, None], R, R0),
                   torch.where(improved[:, None], t, t0), torch.minimum(c, c0), improved)


def correspondences(prev_xy, cur_xy, train_idx, cfg):
    """(x1, x2) (P, N, 2): each query keypoint of the first frame of a
    pair and the keypoint of the second that it matched, both normalized
    by the configuration's intrinsics."""
    K = camera.intrinsics(*cfg.intrinsics, dtype=prev_xy.dtype, device=prev_xy.device)
    x2 = torch.gather(cur_xy, 1, train_idx[..., None].expand(-1, -1, 2))
    return camera.normalize_points(prev_xy, K), camera.normalize_points(x2, K)


def run(frames: torch.Tensor, cfg, seed: int, block: int, refine_iters: int):
    """vobench.reference.pipeline.run, then every pair refined by
    `refine_iters` LM iterations over its RANSAC inliers and the chain
    over the refined motions: (features, estimates, poses (1, T),
    {"refine": {"R_rel", "t_rel", "improved"}}) of (T, H, W) frames."""
    feats, est, _ = pipeline.run(frames, cfg, seed, block)
    x1, x2 = correspondences(feats.xy[:-1], feats.xy[1:], est["match_train_idx"], cfg)
    out = refine_window(x1, x2, est["match_mask"], est["R"], est["t"], refine_iters)
    chain = pipeline.chain_relative_poses(out.R_rel, out.t_rel, est["have_rt"], est["pose_ok"],
                                          cfg)
    poses = Pose(chain.R[None], chain.t[None])
    return feats, est, poses, {"refine": {"R_rel": out.R_rel, "t_rel": out.t_rel,
                                          "improved": out.improved}}
