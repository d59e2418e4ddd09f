"""Pose-chaining variants at trajectory scale (port of tools/profile_chain.py).

n relative poses (the JAX tool's N, 63: a 64-frame run's pairs) drawn as
the JAX tool draws them (numpy.random.RandomState(0): unit axes, angles
up to 0.2 rad, translations 0.1 N(0, 1), float32), it times:

  doubling  geometry/se3.cumulative_compose (Hillis-Steele, log-depth
            batched 3x3 products)
  soa       doubling with the pose axis minor-most and the 3x3 products
            unrolled into elementwise multiply-adds
  assoc     a work-efficient scan over se3.compose (torch has no
            lax.associative_scan; this is its odd/even recursion)
  scan      a Python loop of se3.compose, one step a pose
  full      runner.chain_relative_poses (inversion, gates, doubling, the
            identity first)

Rows as tools/profile_rows says (torch.profiler's figures on every row:
all are the chain). No kernel of the port runs here.

    python -m tpu_vo_torch.tools.profile_chain [--n 63 --reps 64]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.geometry import se3
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.pipeline.runner import chain_relative_poses
from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(n=63, reps=64, iters=5)


def poses(n: int):
    """(R (n, 3, 3), t (n, 3)) float32 numpy, the JAX tool's draws."""
    rng = np.random.RandomState(0)
    ax = rng.randn(n, 3)
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    R = se3.rotation_from_axis_angle(torch.from_numpy(ax.astype(np.float32)),
                                     torch.from_numpy((rng.rand(n) * 0.2).astype(np.float32)))
    t = rng.randn(n, 3).astype(np.float32) * 0.1
    return R.numpy(), t


def doubling(R, t):
    p = se3.cumulative_compose(Pose(R, t))
    return p.R, p.t


def soa(R, t):
    """Doubling with the pose axis minor-most, (3, 3, n) and (3, n)."""
    Rs, ts = R.movedim(0, -1), t.movedim(0, -1)
    n, d = R.shape[0], 1
    while d < n:
        Ra, ta, Rb, tb = Rs[..., :-d], ts[..., :-d], Rs[..., d:], ts[..., d:]
        Rc = (Ra[:, :, None, :] * Rb[None, :, :, :]).sum(1)      # sum_k Ra[i,k] Rb[k,j]
        tc = (Ra * tb[None, :, :]).sum(1) + ta
        Rs = torch.cat([Rs[..., :d], Rc], -1)
        ts = torch.cat([ts[..., :d], tc], -1)
        d *= 2
    return Rs.movedim(-1, 0), ts.movedim(-1, 0)


def assoc(R, t):
    """Inclusive scan of se3.compose by lax.associative_scan's recursion:
    compose neighbours, scan the n/2 results, fill in the even slots."""
    n = R.shape[0]
    if n < 2:
        return R, t
    red = se3.compose(Pose(R[0:-1:2], t[0:-1:2]), Pose(R[1::2], t[1::2]))
    oR, ot = assoc(red.R, red.t)                    # the odd slots 1, 3, 5, ...
    k = (n - 1) // 2                                # even slots past 0 to fill
    ev = se3.compose(Pose(oR[:k], ot[:k]), Pose(R[2::2], t[2::2]))
    outR, outt = torch.empty_like(R), torch.empty_like(t)
    outR[0], outt[0] = R[0], t[0]
    outR[1::2], outt[1::2] = oR, ot
    outR[2::2], outt[2::2] = ev.R, ev.t
    return outR, outt


def scan(R, t):
    carry = Pose.identity(dtype=R.dtype, device=R.device)
    Rs, ts = [], []
    for i in range(R.shape[0]):
        carry = se3.compose(carry, Pose(R[i], t[i]))
        Rs.append(carry.R)
        ts.append(carry.t)
    return torch.stack(Rs), torch.stack(ts)


VARIANTS = {"doubling": doubling, "soa": soa, "assoc": assoc, "scan": scan}


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("profile_chain", o)
    cfg = VOConfig(image_width=1241, image_height=376)
    R_np, t_np = poses(o.n)
    R, t = torch.from_numpy(R_np).to(o.device), torch.from_numpy(t_np).to(o.device)
    have = torch.ones(o.n, dtype=torch.bool, device=o.device)
    t_ = dict(reps=o.reps, iters=o.iters, profile=True)
    for name, fn in VARIANTS.items():
        rows.time(name, lambda fn=fn: fn(R, t), **t_)
    rows.time("full", lambda: chain_relative_poses(R, t, have, have, cfg), **t_)
    ref = doubling(R, t)
    rows.add("max_abs_diff_vs_doubling", {
        name: max(float((a - b).abs().max()) for a, b in zip(fn(R, t), ref))
        for name, fn in VARIANTS.items()})
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
