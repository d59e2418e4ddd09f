"""Sequence runners (port of tpu_vo/pipeline/runner.py).

`run_sequence_scan`, the streaming runner: `vo_step` over the frames one
at a time, the state flowing frame to frame; each kernel launches once
per frame.

`run_sequence_batched`, the batched three-stage runner:

  1. ORB features of the T frames, one launch of each kernel per chunk
     of `frame_chunk` frames (all T at once by default);
  2. matching + RANSAC + pose recovery of the T-1 consecutive pairs as
     one batch dimension: matching and RANSAC's search `pair_chunk` pairs
     at a time (all by default), its refit and the poses of all at once;
  3. world poses by a prefix composition of the relative motions;

with `refine_iters` n > 0 (tpu_vo's config 5), between stages 2 and 3
every pair's motion is polished by n Levenberg-Marquardt iterations over
its RANSAC inliers (`refine_pairs`, models/refinement.refine_window),
and stage 3 chains the refined motions.

The chunks bound peak memory, as the JAX runner's `_chunked_map` does:
stage 1 holds every frame's windows and their blur temporaries at once.

`run_sequence_streamed`, the IO-overlapped runner: chunks of frames from
an iterator (the native loader's ring, a packed file), uploaded ahead by
a background thread (pipeline/upload: pinned ring, side stream), each
chunk's features and pairs run as the batched runner's stages, the last
frame's features carried to the next chunk.
"""

from __future__ import annotations

import functools
from typing import Iterable, Optional

import torch

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.features.orb import ORBFeatures, detect_and_compute
from tpu_vo_torch.geometry import se3
from tpu_vo_torch.geometry.camera import normalize_points
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.models.refinement import WindowRefineResult, refine_window
from tpu_vo_torch.pipeline.step import (
    VOStepOutput,
    _intrinsics,
    finish_pair,
    initial_state,
    pair_generators,
    search_pair,
    vo_step,
)
from tpu_vo_torch.pipeline.upload import upload_ahead
from tpu_vo_torch.utils.profiling import CALL_SPAN, span

# Frames per stage-1 launch and pairs per stage-2 call of a streamed
# chunk whose length they divide (else the whole chunk at once), as
# tpu_vo's `_streamed_step_fn` defaults
STREAM_FRAME_CHUNK = 8
STREAM_PAIR_CHUNK = 8


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
    and NamedTuples; a field that is None in each stays None."""
    first = parts[0]
    if first is None or (len(parts) == 1 and join is torch.cat):
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
    with span(CALL_SPAN):
        with span("vo.upload"):
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
    with span("vo.stage1"):
        return _cat([detect_and_compute(frames[a:e], cfg.orb)
                     for a, e in _spans(frames.shape[0], frame_chunk)])


def estimate_pairs(prev: ORBFeatures, cur: ORBFeatures, cfg: VOConfig, generators,
                   pair_chunk: Optional[int] = None) -> dict:
    """Stage 2: `estimate_pair` over P pairs (leading dim P), pair i
    drawing from generators[i]: the matching and RANSAC's search
    `pair_chunk` pairs at a time (search_pair), then the refit, the pose
    and F of all P at once (finish_pair), so that the chunks change no
    output."""
    with span("vo.stage2"):
        return finish_pair(_cat([search_pair(ORBFeatures(*(f[a:e] for f in prev)),
                                             ORBFeatures(*(f[a:e] for f in cur)), cfg,
                                             generators=generators[a:e])
                                 for a, e in _spans(prev.xy.shape[0], pair_chunk)]), cfg)


def refine_inputs(prev: ORBFeatures, cur: ORBFeatures, est: dict, cfg: VOConfig) -> tuple:
    """refine_window's inputs for P pairs: (x1, x2, mask, R, t), x1 the
    normalized keypoints of `prev`, x2 those of `cur` gathered by each
    query's match (match_train_idx), mask the RANSAC inliers, (R, t) stage
    2's motions. K is stage 2's (cfg.intrinsics), built once per device."""
    K = _intrinsics(cfg.intrinsics, prev.xy.device, prev.xy.dtype)
    x2 = torch.gather(normalize_points(cur.xy, K), 1,
                      est["match_train_idx"][..., None].expand(-1, -1, 2))
    return normalize_points(prev.xy, K), x2, est["match_mask"], est["R"], est["t"]


def refine_pairs(prev: ORBFeatures, cur: ORBFeatures, est: dict, cfg: VOConfig,
                 iters: int) -> WindowRefineResult:
    """Between stages 2 and 3: `iters` LM iterations on every pair's
    motion over its RANSAC inliers, all pairs at once, with fixed shapes
    and no wait for the card."""
    with span("vo.refine"):
        with span("refine.prep"):
            args = refine_inputs(prev, cur, est, cfg)
        return refine_window(*args, iters=iters)


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
                         pair_chunk: Optional[int] = None, refine_iters: int = 0):
    """Batched three-stage VO over (T, H, W) uint8 frames, moved to
    `device` (the card when None; see entry_device). Stage 1 runs
    `frame_chunk` frames at a time and stage 2 `pair_chunk` pairs at a
    time (None: all at once); a chunk must divide T (T - 1 for pairs)
    unless it is at least that long. With `refine_iters` n > 0 every
    pair's motion is refined by n LM iterations (refine_pairs) before
    the chain. Returns (poses: Pose with leading dim T, diagnostics dict
    of (T-1,) tensors, with refine_improved and refine_cost when n > 0),
    the same for every chunking."""
    _check_chunks(frame_chunk, pair_chunk)
    if refine_iters < 0:
        raise ValueError(f"refine_iters must be a non-negative int, got {refine_iters}")
    with span(CALL_SPAN):
        with span("vo.upload"):
            frames = frames.to(entry_device(device))
        T = frames.shape[0]
        feats = detect_frames(frames, cfg, frame_chunk)
        with span("vo.seeds"):
            gens = pair_generators(seed, range(1, T))
        prev = ORBFeatures(*(f[:-1] for f in feats))
        cur = ORBFeatures(*(f[1:] for f in feats))
        est = estimate_pairs(prev, cur, cfg, gens, pair_chunk)
        R, t, diags = est["R"], est["t"], diagnostics(est)
        if refine_iters:
            ref = refine_pairs(prev, cur, est, cfg, refine_iters)
            R, t = ref.R_rel, ref.t_rel
            diags.update(refine_improved=ref.improved, refine_cost=ref.cost)
        with span("vo.stage3"):
            poses = chain_relative_poses(R, t, est["have_rt"], est["pose_ok"], cfg)
        return poses, diags


@functools.lru_cache(maxsize=None)
def _empty_features(cfg: VOConfig, device: torch.device) -> ORBFeatures:
    """The all-invalid features of initial_state, as a batch of one on
    `device`: the carry before the first frame. Cached per device."""
    return ORBFeatures(*(f[None] for f in initial_state(cfg, device=device).prev))


def _stream_chunk(n: int, chunk: Optional[int]) -> Optional[int]:
    """`chunk` items per call where it divides n, else (or when None) all
    n at once."""
    return chunk if chunk is not None and n % chunk == 0 else None


def _streamed_pairs(carry: ORBFeatures, feats: ORBFeatures, cfg: VOConfig, seeds,
                    offset: int, pair_chunk: Optional[int] = STREAM_PAIR_CHUNK) -> dict:
    """The n pairs of each of R rows of frames whose first is at global
    index `offset`: features `feats` (R, n, ...), `carry` (R, ...) those
    of the frame before each row's first. Row b's pairs are the carried
    features against its first frame, then frame to frame, pair j
    drawing from the generator of global pair offset + j of seeds[b];
    `pair_chunk` pairs a call where it divides R*n, else all at once.
    Returns their estimates, leading dim R*n (row-major)."""
    R, n = feats.xy.shape[:2]
    prev = ORBFeatures(*(torch.cat([c[:, None], f[:, :-1]], 1).flatten(0, 1)
                         for c, f in zip(carry, feats)))
    cur = ORBFeatures(*(f.flatten(0, 1) for f in feats))
    with span("vo.seeds"):
        gens = [g for s in seeds for g in pair_generators(s, range(offset, offset + n))]
    return estimate_pairs(prev, cur, cfg, gens, _stream_chunk(R * n, pair_chunk))


def _streamed_step(carry: ORBFeatures, chunk: torch.Tensor, cfg: VOConfig, seed: int,
                   offset: int, frame_chunk: Optional[int] = STREAM_FRAME_CHUNK,
                   pair_chunk: Optional[int] = STREAM_PAIR_CHUNK):
    """One chunk of n frames, the first at global index `offset`: its
    features, `frame_chunk` frames a launch, then its n pairs (the carried
    features against the first frame, then frame to frame), `pair_chunk`
    pairs a call, pair j drawing from the generator of global pair offset
    + j. A chunk that does not divide n, or None, means all n in one call
    (tpu_vo's `_streamed_step_fn(cfg, frame_chunk, pair_chunk)`). Returns
    (the last frame's features, the pairs' estimates)."""
    feats = detect_frames(chunk, cfg, _stream_chunk(chunk.shape[0], frame_chunk))
    est = _streamed_pairs(carry, ORBFeatures(*(f[None] for f in feats)), cfg, [seed], offset,
                          pair_chunk)
    return ORBFeatures(*(f[-1:] for f in feats)), est


def run_sequence_streamed(chunks: Iterable, cfg: VOConfig, chunk_size: int = 0, seed: int = 0,
                          prefetch_depth: int = 2, device=None):
    """VO over an iterator of (n, H, W) uint8 frame chunks (numpy arrays
    or CPU tensors; n may vary), on `device` (the card when None; see
    entry_device). A background thread uploads up to `prefetch_depth`
    chunks ahead while the caller's stream computes. Each chunk runs
    `_streamed_step`; the first chunk's first pair is frame 0 against the
    all-invalid empty features, and is dropped. An error raised by the
    iterator reaches the caller; an empty iterator raises ValueError.
    `chunk_size` is unused: each chunk's length is its own. Returns
    (poses, diagnostics) as run_sequence_batched does on the
    concatenated frames, each pair drawing the same samples."""
    del chunk_size
    dev = entry_device(device)
    with span(CALL_SPAN):
        carry = _empty_features(cfg, dev)
        ests, offset = [], 0
        for _, chunk in upload_ahead(((None, c) for c in chunks), dev, prefetch_depth):
            carry, est = _streamed_step(carry, chunk, cfg, seed, offset)
            ests.append(est)
            offset += chunk.shape[0]
        if not ests:
            raise ValueError("run_sequence_streamed: empty chunk iterator")
        est = {k: v[1:] for k, v in _cat(ests).items() if k != "stats"}  # drop the first pair
        with span("vo.stage3"):
            poses = chain_relative_poses(est["R"], est["t"], est["have_rt"], est["pose_ok"],
                                         cfg)
        return poses, diagnostics(est)
