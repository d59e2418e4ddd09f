"""The batched three-stage sequence runner (port of
tpu_vo/pipeline/runner.py `run_sequence_batched`):

  1. ORB features of all T frames, one launch per kernel and level;
  2. matching + RANSAC + pose recovery of all T-1 consecutive pairs as
     one batch dimension;
  3. world poses by a prefix composition of the relative motions.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.features.orb import ORBFeatures, detect_and_compute
from tpu_vo_torch.geometry import se3
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.pipeline.step import check_supported, estimate_pair


def pair_generators(seed: int, pairs) -> List[torch.Generator]:
    """One CPU generator per pair i (the pair of frames i-1 and i), seeded
    from (seed, i): a pair draws the same samples however the sequence
    is batched and on whatever device it runs."""
    gens = []
    for i in pairs:
        state = np.random.SeedSequence([int(seed), int(i)]).generate_state(2)
        g = torch.Generator()
        g.manual_seed(int(state[0]) << 32 | int(state[1]))
        gens.append(g)
    return gens


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


def entry_device(device=None) -> torch.device:
    """The device an entry point runs on: the card, unless the caller
    names another (device="cpu"). With no card and no device it raises
    rather than carry on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def run_sequence_batched(frames: torch.Tensor, cfg: VOConfig, seed: int = 0,
                         device=None):
    """Batched three-stage VO over (T, H, W) uint8 frames, moved to
    `device` (the card when None; see entry_device). Returns (poses: Pose
    with leading dim T, diagnostics dict of (T-1,) tensors)."""
    check_supported(cfg)
    frames = frames.to(entry_device(device))
    T = frames.shape[0]
    feats = detect_and_compute(frames, cfg.orb)
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    est = estimate_pair(prev, cur, cfg,
                        generators=pair_generators(seed, range(1, T)))
    poses = chain_relative_poses(est["R"], est["t"], est["have_rt"],
                                 est["pose_ok"], cfg)
    diags = {
        "num_keypoints": est["n_keypoints"],
        "num_matches": est["n_good"],
        "num_inliers": est["n_inliers"],
        "num_valid_points": est["n_valid_points"],
        "pose_ok": est["pose_ok"],
        "epipolar_residual": est["mean_residual"],
        "F": est["F"],
    }
    return poses, diags
