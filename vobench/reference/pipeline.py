"""The reference run of one call: the frames' features, their pairs'
estimates and each sequence's trajectory, batched as the program's
batched entries batch them (all frames of a call in one stage-1 pass,
all pairs in one stage-2 pass), so that every operation meets the same
shapes. The pose chain is a frozen copy of
tpu_vo_torch/pipeline/runner.py `chain_relative_poses`."""

from __future__ import annotations

import torch

from vobench.reference import se3
from vobench.reference.configs import VOConfig
from vobench.reference.orb import ORBFeatures, detect_and_compute
from vobench.reference.se3 import Pose
from vobench.reference.step import estimate_pair, pair_generators


def chain_relative_poses(R: torch.Tensor, t: torch.Tensor, have_rt: torch.Tensor,
                         pose_ok: torch.Tensor, cfg: VOConfig) -> Pose:
    """(P+1) world poses from P relative motions x_c2 = R x_c1 + t:
    invert each motion, scale its translation by 0.3 (pose_ok) or 0
    (rotation-only fallback), hold the pose where no model was found,
    and compose the prefix starting at identity."""
    scale = torch.where(pose_ok, cfg.trajectory_scale, 0.0).to(torch.float32)
    R_inv, t_inv = se3.invert_relative(R, t)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R_inv)
    R_rel = torch.where(have_rt[:, None, None], R_inv, eye)
    t_rel = torch.where(have_rt[:, None], scale[:, None] * t_inv,
                        torch.zeros_like(t_inv))
    cum = se3.cumulative_compose(Pose(R_rel, t_rel))
    first = Pose.identity((1,), dtype=R.dtype, device=R.device)
    return Pose(torch.cat([first.R, cum.R], 0), torch.cat([first.t, cum.t], 0))


def run(frames: torch.Tensor, cfg: VOConfig, seed: int, block: int):
    """(features (R*T, ...), estimates (R*(T-1), ...), poses (R, T)) of
    (T, H, W) or (R, T, H, W) uint8 frames, row r drawing its RANSAC
    samples from pair_generators(seed + r, range(1, T)). Kernel B1's
    plain version runs `block` frames at a time."""
    rows = frames.reshape(-1, *frames.shape[-3:])
    R, T = rows.shape[:2]
    feats = detect_and_compute(rows.reshape(R * T, *rows.shape[2:]), cfg.orb, block)
    per_row = [f.reshape(R, T, *f.shape[1:]) for f in feats]
    prev = ORBFeatures(*(f[:, :-1].reshape(R * (T - 1), *f.shape[2:]) for f in per_row))
    cur = ORBFeatures(*(f[:, 1:].reshape(R * (T - 1), *f.shape[2:]) for f in per_row))
    gens = [g for r in range(R) for g in pair_generators(seed + r, range(1, T))]
    est = estimate_pair(prev, cur, cfg, generators=gens)
    chains = [chain_relative_poses(*(est[k].reshape(R, T - 1, *est[k].shape[1:])[r]
                                     for k in ("R", "t", "have_rt", "pose_ok")), cfg)
              for r in range(R)]
    poses = Pose(torch.stack([p.R for p in chains]), torch.stack([p.t for p in chains]))
    return feats, est, poses
