"""Batches of sequences on one card (port of the single-device form of
tpu_vo/parallel/sharding.py `run_batch_of_sequences`).

The B sequences are flattened before the stages, so `frame_chunk` and
`pair_chunk` are the sizes of each launch whatever B is: stage 1 runs
over the B*T frames, stage 2 over the B*(T-1) pairs, formed within each
sequence (never across two), sequence b drawing from
pair_generators(seed + b, range(1, T)). Each sequence's result equals
run_sequence_batched(frames[b], cfg, seed + b). Data parallelism over
several cards (torch.distributed) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.pipeline.runner import (
    _check_chunks,
    _spans,
    chain_relative_poses,
    detect_frames,
    diagnostics,
    entry_device,
    estimate_pairs,
)
from tpu_vo_torch.pipeline.step import pair_generators


def run_batch_of_sequences(frames: torch.Tensor, cfg: VOConfig, seed: int = 0,
                           frame_chunk: Optional[int] = None,
                           pair_chunk: Optional[int] = None, device=None):
    """VO over a (B, T, H, W) uint8 batch of sequences, moved to `device`
    (the card when None). A chunk must divide B*T (frames) or B*(T-1)
    (pairs) unless it is at least that long. Returns (poses: Pose with
    leading dims (B, T), diagnostics dict of (B, T-1) tensors)."""
    _check_chunks(frame_chunk, pair_chunk)
    B, T = frames.shape[:2]
    _spans(B * T, frame_chunk)
    _spans(B * (T - 1), pair_chunk)
    frames = frames.to(entry_device(device))
    feats = detect_frames(frames.reshape(B * T, *frames.shape[2:]), cfg, frame_chunk)
    feats = [f.reshape(B, T, *f.shape[1:]) for f in feats]
    prev = ORBFeatures(*(f[:, :-1].reshape(B * (T - 1), *f.shape[2:]) for f in feats))
    cur = ORBFeatures(*(f[:, 1:].reshape(B * (T - 1), *f.shape[2:]) for f in feats))
    gens = [g for b in range(B) for g in pair_generators(seed + b, range(1, T))]
    est = estimate_pairs(prev, cur, cfg, gens, pair_chunk)
    est = {k: v for k, v in est.items() if k != "stats"}
    est = {k: v.reshape(B, T - 1, *v.shape[1:]) for k, v in est.items()}
    poses = [chain_relative_poses(est["R"][b], est["t"][b], est["have_rt"][b],
                                  est["pose_ok"][b], cfg) for b in range(B)]
    return (Pose(torch.stack([p.R for p in poses]), torch.stack([p.t for p in poses])),
            diagnostics(est))
