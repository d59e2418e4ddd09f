"""The batched three-stage sequence runner (port of
tpu_vo/pipeline/runner.py `run_sequence_batched`):

  1. ORB features of the T frames, one launch of each kernel per chunk
     of `frame_chunk` frames (all T at once by default);
  2. matching + RANSAC + pose recovery of the T-1 consecutive pairs as
     one batch dimension, `pair_chunk` pairs at a time (all by default);
  3. world poses by a prefix composition of the relative motions.

The chunks bound peak memory, as the JAX runner's `_chunked_map` does:
stage 1 holds every frame's windows and their blur temporaries at once.
"""

from __future__ import annotations

from typing import List, Optional

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


def _check_chunks(frame_chunk: Optional[int], pair_chunk: Optional[int]) -> None:
    """Reject a chunk below 1 (tpu_vo/pipeline/runner.py `_validate_chunks`).
    Its other check, KNOWN_FAULTING_PAIR_CHUNKS, guards a fault of the TPU
    runtime and is not ported: every pair_chunk runs here."""
    for name, v in (("frame_chunk", frame_chunk), ("pair_chunk", pair_chunk)):
        if v is not None and v < 1:
            raise ValueError(f"{name} must be a positive int, got {v}")


def _spans(n: int, chunk: Optional[int]):
    """[(start, end)] of the chunks of n items: one span when chunk is
    None or at least n, as tpu_vo's `_chunked_map` runs one vmap; else
    chunk must divide n."""
    if chunk is None or chunk >= n:
        return [(0, n)]
    if n % chunk:
        raise ValueError(f"sequence length {n} not divisible by {chunk}")
    return [(a, a + chunk) for a in range(0, n, chunk)]


def _cat(parts):
    """Concatenate along dim 0 the tensors of a list of equally shaped
    NamedTuples or dicts of tensors and NamedTuples."""
    first = parts[0]
    if len(parts) == 1:
        return first
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, 0)
    if isinstance(first, dict):
        return {k: _cat([p[k] for p in parts]) for k in first}
    return type(first)(*(_cat(list(f)) for f in zip(*parts)))


def run_sequence_batched(frames: torch.Tensor, cfg: VOConfig, seed: int = 0,
                         device=None, frame_chunk: Optional[int] = None,
                         pair_chunk: Optional[int] = None):
    """Batched three-stage VO over (T, H, W) uint8 frames, moved to
    `device` (the card when None; see entry_device). Stage 1 runs
    `frame_chunk` frames at a time and stage 2 `pair_chunk` pairs at a
    time (None: all at once); a chunk must divide T (T - 1 for pairs)
    unless it is at least that long. Returns (poses: Pose with leading
    dim T, diagnostics dict of (T-1,) tensors), the same for every
    chunking."""
    check_supported(cfg)
    _check_chunks(frame_chunk, pair_chunk)
    frames = frames.to(entry_device(device))
    T = frames.shape[0]
    feats = _cat([detect_and_compute(frames[a:e], cfg.orb)
                  for a, e in _spans(T, frame_chunk)])
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    gens = pair_generators(seed, range(1, T))
    est = _cat([estimate_pair(ORBFeatures(*(f[a:e] for f in prev)),
                              ORBFeatures(*(f[a:e] for f in cur)), cfg,
                              generators=gens[a:e])
                for a, e in _spans(T - 1, pair_chunk)])
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
