"""Sequence runners (port of tpu_vo/pipeline/runner.py).

`run_sequence_scan`, the streaming runner: `vo_step` over the frames one
at a time, the state flowing frame to frame; each kernel launches once
per frame.

`run_sequence_batched`, the batched three-stage runner:

  1. ORB features of the T frames, one launch of each kernel per chunk
     of `frame_chunk` frames (all T at once by default);
  2. matching + RANSAC + pose recovery of the T-1 consecutive pairs as
     one batch dimension, `pair_chunk` pairs at a time (all by default);
  3. world poses by a prefix composition of the relative motions.

The chunks bound peak memory, as the JAX runner's `_chunked_map` does:
stage 1 holds every frame's windows and their blur temporaries at once.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.features.orb import ORBFeatures, detect_and_compute
from tpu_vo_torch.geometry import se3
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.pipeline.step import (
    VOStepOutput,
    estimate_pair,
    initial_state,
    pair_generators,
    vo_step,
)


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


def _cat(parts, join=torch.cat):
    """Join along dim 0 (torch.cat, or torch.stack into a new dim 0) the
    tensors of a list of equally shaped NamedTuples or dicts of tensors
    and NamedTuples."""
    first = parts[0]
    if len(parts) == 1 and join is torch.cat:
        return first
    if isinstance(first, torch.Tensor):
        return join(parts, 0)
    if isinstance(first, dict):
        return {k: _cat([p[k] for p in parts], join) for k in first}
    return type(first)(*(_cat(list(f), join) for f in zip(*parts)))


def run_sequence_scan(frames: torch.Tensor, cfg: VOConfig, seed: int = 0,
                      device=None) -> VOStepOutput:
    """Streaming VO over (T, H, W) uint8 frames, moved to `device` (the
    card when None; see entry_device): `vo_step` frame by frame. Returns
    the per-frame outputs stacked along a leading T (poses: the
    trajectory, the first the identity). Pair i draws the samples that
    run_sequence_batched gives it."""
    frames = frames.to(entry_device(device))
    state = initial_state(cfg, seed, frames.device)
    outs = []
    for frame in frames:
        state, out = vo_step(state, frame, cfg)
        outs.append(out)
    return _cat(outs, torch.stack)


def detect_frames(frames: torch.Tensor, cfg: VOConfig,
                  frame_chunk: Optional[int] = None) -> ORBFeatures:
    """Stage 1: ORB features of (n, H, W) frames, `frame_chunk` frames
    per launch of each kernel (all at once when None)."""
    return _cat([detect_and_compute(frames[a:e], cfg.orb)
                 for a, e in _spans(frames.shape[0], frame_chunk)])


def estimate_pairs(prev: ORBFeatures, cur: ORBFeatures, cfg: VOConfig, generators,
                   pair_chunk: Optional[int] = None) -> dict:
    """Stage 2: `estimate_pair` over P pairs (leading dim P), `pair_chunk`
    pairs at a time, pair i drawing from generators[i]."""
    return _cat([estimate_pair(ORBFeatures(*(f[a:e] for f in prev)),
                               ORBFeatures(*(f[a:e] for f in cur)), cfg,
                               generators=generators[a:e])
                 for a, e in _spans(prev.xy.shape[0], pair_chunk)])


def diagnostics(est: dict) -> dict:
    """The runners' per-pair diagnostics from estimate_pair's output."""
    return {
        "num_keypoints": est["n_keypoints"],
        "num_matches": est["n_good"],
        "num_inliers": est["n_inliers"],
        "num_valid_points": est["n_valid_points"],
        "pose_ok": est["pose_ok"],
        "epipolar_residual": est["mean_residual"],
        "F": est["F"],
    }


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
    _check_chunks(frame_chunk, pair_chunk)
    frames = frames.to(entry_device(device))
    T = frames.shape[0]
    feats = detect_frames(frames, cfg, frame_chunk)
    est = estimate_pairs(ORBFeatures(*(f[:-1] for f in feats)),
                         ORBFeatures(*(f[1:] for f in feats)), cfg,
                         pair_generators(seed, range(1, T)), pair_chunk)
    poses = chain_relative_poses(est["R"], est["t"], est["have_rt"],
                                 est["pose_ok"], cfg)
    return poses, diagnostics(est)
