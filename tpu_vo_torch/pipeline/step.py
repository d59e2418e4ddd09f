"""The per-frame VO step and the pair estimation it runs (port of
tpu_vo/pipeline/step.py).

`estimate_pair`, batched over consecutive pairs: match by Hamming
distance (cross-check and adaptive threshold, or the ratio test),
normalize, run the batched RANSAC, recover the pose and compute F; in
two halves, `search_pair` (up to RANSAC's full-set scoring) and
`finish_pair` (its refit, the pose and F), which a chunked runner runs
once over all its chunks' searches. Every gate of the reference's
failure ladder comes back as a boolean tensor, never a branch.

`vo_step`, one frame at a time: features, `estimate_pair` against the
previous frame's features (on the first frame, against the all-invalid
empty set, its result masked as tpu_vo does), then the world-pose update
of the failure ladder:
  (a) first frame            -> identity pose
  (b) < 10 good matches      -> hold previous pose
  (c) RANSAC failed          -> hold previous pose
  (d) weak geometry          -> rotation-only, scale 0
  (e) good pose              -> scale 0.3 composition
The state carries the RANSAC seed and the frame index in place of
tpu_vo's PRNG key: frame i draws from `pair_generators(seed, [i])`, the
generator the batched runner gives the pair of frames i-1 and i.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.estimation.ransac import (
    Phases,
    Winner,
    lo_refit,
    pixel_threshold_to_normalized,
)
from tpu_vo_torch.estimation.recover_pose import recover_pose_from_essential
from tpu_vo_torch.features.orb import ORBFeatures, detect_and_compute
from tpu_vo_torch.geometry import se3
from tpu_vo_torch.geometry.camera import intrinsics, normalize_points
from tpu_vo_torch.geometry.epipolar import algebraic_residual, fundamental_from_essential
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.matching.filter import adaptive_threshold_filter, match_statistics
from tpu_vo_torch.matching.hamming import mutual_nearest_match, ratio_test_match
from tpu_vo_torch.utils.profiling import span


@functools.lru_cache(maxsize=None)
def _intrinsics(fx_fy_cx_cy, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """K on `device`, built once per calibration (a copy from pageable
    host memory waits for the stream to drain)."""
    return intrinsics(*fx_fy_cx_cy, dtype=dtype, device=device)


def pair_generators(seed: int, pairs) -> List[torch.Generator]:
    """One CPU generator per pair i (the pair of frames i-1 and i), seeded
    from (seed, i): a pair draws the same samples however the sequence
    is batched or streamed and on whatever device it runs."""
    gens = []
    for i in pairs:
        state = np.random.SeedSequence([int(seed), int(i)]).generate_state(2)
        g = torch.Generator()
        g.manual_seed(int(state[0]) << 32 | int(state[1]))
        gens.append(g)
    return gens


class PairSearch(NamedTuple):
    """search_pair's result for P pairs (leading dim P): the matches and
    RANSAC's winner before its LO refit, with what finish_pair reads."""

    n_keypoints: torch.Tensor    # (P,) int32 valid keypoints of `cur`
    n_good: torch.Tensor         # (P,) int32 good matches
    stats: tuple                 # the matcher's statistics, (P,) each
    train_idx: torch.Tensor      # (P, N) matched slot of `cur` for each slot of `prev`
    p1: torch.Tensor             # (P, N, 2) pixel coordinates in `prev`
    p2: torch.Tensor             # (P, N, 2) their matches' in `cur`
    x1n: torch.Tensor            # (P, N, 2) p1 normalized by K
    x2n: torch.Tensor            # (P, N, 2) p2 normalized by K
    mask: torch.Tensor           # (P, N) bool good matches
    thr_sq: torch.Tensor         # (P, 1, 1) squared inlier threshold
    score_sq: torch.Tensor       # (P, 1, 1) MSAC truncation after full-set scoring
    winner: Winner
    num_hypotheses: torch.Tensor  # (P,) int32


def search_pair(prev: ORBFeatures, cur: ORBFeatures, cfg: VOConfig,
                generators: Optional[Sequence[torch.Generator]] = None,
                idx: Optional[torch.Tensor] = None) -> PairSearch:
    """estimate_pair up to RANSAC's full-set scoring: match P feature-set
    pairs (leading dim P), normalize, draw (one generator per pair, or
    explicit `idx` (P, max_iters, 5, or 8 for 8-point samples)) and run
    RANSAC's phases before its refit. Each pair's result is its own,
    however many pairs the call holds."""
    rcfg = cfg.ransac
    with span("pair.match"):
        if cfg.match.use_ratio_test:
            good = ratio_test_match(prev.desc32, cur.desc32, prev.valid, cur.valid,
                                    cfg.match.ratio)
            stats = match_statistics(good, cfg.match)
        else:
            raw = mutual_nearest_match(prev.desc32, cur.desc32, prev.valid, cur.valid)
            good, stats = adaptive_threshold_filter(raw, cfg.match)
        n_good = good.valid.sum(-1).to(torch.int32)

    with span("pair.prep"):
        K = _intrinsics(cfg.intrinsics, prev.xy.device, prev.xy.dtype)
        p1 = prev.xy
        p2 = torch.gather(cur.xy, 1, good.train_idx[..., None].expand(-1, -1, 2))
        mask = good.valid
        x1n = normalize_points(p1, K)
        x2n = normalize_points(p2, K)
        thr = pixel_threshold_to_normalized(rcfg.threshold_px, K)
        ransac = Phases(
            x1n, x2n, mask, thr,
            max_iters=rcfg.max_iters,
            use_five_point=rcfg.use_five_point,
            score=rcfg.score_method,
            score_sigma_scale=rcfg.score_sigma_scale,
            adaptive_sigma=rcfg.adaptive_sigma,
            cheirality_gate=rcfg.cheirality_gate,
            cheirality_min_frac=rcfg.cheirality_min_frac,
            distance_thresh=rcfg.distance_thresh,
        )

    # find_essential_ransac, split so that its thresholds are computed in
    # pair.prep and its refit in finish_pair
    winner, score_sq, num_hypotheses = ransac.search(
        ransac.draw(generators) if idx is None else idx)
    return PairSearch(cur.valid.sum(-1).to(torch.int32), n_good, stats, good.train_idx, p1,
                      p2, x1n, x2n, mask, ransac.thr_sq, score_sq, winner, num_hypotheses)


def finish_pair(s: PairSearch, cfg: VOConfig) -> dict:
    """estimate_pair from search_pair's result on: RANSAC's LO refit, the
    pose (recover_pose and the failure ladder's gates) and F with its
    residual, for all P pairs at once.

    The refit's normal matrices (A^T A over each pair's inliers, one
    batched GEMM) round differently on the card with the number of pairs
    in the batch, and so can its accept decision; the chunked runners
    join their chunks' searches and finish every pair of a call in one
    batch, so that a call's output does not depend on its chunks."""
    rcfg = cfg.ransac
    with span("ransac.refit"):
        res = lo_refit(s.winner, s.x1n, s.x2n, s.mask, s.thr_sq, s.score_sq,
                       s.num_hypotheses, 5 if rcfg.use_five_point else 8)
    with span("pair.pose"):
        rec = recover_pose_from_essential(res.E, s.x1n, s.x2n, res.inliers,
                                          rcfg.distance_thresh)

        n_good = s.n_good
        attempted = n_good >= rcfg.min_matches_for_pose
        pose_ok = (attempted
                   & (n_good >= rcfg.min_matches_attempt)
                   & res.success
                   & (rec.num_valid >= rcfg.min_valid_points)
                   & (res.num_inliers >= rcfg.min_inliers))
        have_rt = attempted & res.success
        if rcfg.min_valid_fraction > 0.0:
            # A near-split cheirality vote (possibly the twisted pair): no
            # pose, and no rotation-only fallback either.
            frac_ok = (rec.num_valid.to(torch.float32)
                       >= rcfg.min_valid_fraction
                       * torch.clamp(res.num_inliers, min=1).to(torch.float32))
            pose_ok = pose_ok & frac_ok
            have_rt = have_rt & frac_ok

    with span("pair.residual"):
        F = fundamental_from_essential(res.E, _intrinsics(cfg.intrinsics, s.p1.device,
                                                          s.p1.dtype))
        resid = algebraic_residual(F, s.p1, s.p2)
        inl = res.inliers
        n_inl = torch.clamp(inl.sum(-1), min=1)
        mean_resid = torch.where(inl, resid, torch.zeros_like(resid)).sum(-1) / n_inl

        return dict(
            n_keypoints=s.n_keypoints,
            n_good=n_good,
            stats=s.stats,
            R=rec.R,
            t=rec.t,
            have_rt=have_rt,
            pose_ok=pose_ok,
            n_inliers=res.num_inliers,
            n_valid_points=rec.num_valid,
            F=F,
            mean_residual=mean_resid,
            match_train_idx=s.train_idx,
            match_mask=res.inliers,
        )


def estimate_pair(prev: ORBFeatures, cur: ORBFeatures, cfg: VOConfig,
                  generators: Optional[Sequence[torch.Generator]] = None,
                  idx: Optional[torch.Tensor] = None) -> dict:
    """Match P feature-set pairs (leading dim P) and estimate each relative
    motion (c2 <- c1): search_pair, then finish_pair. RANSAC samples come
    from one generator per pair or from explicit `idx` (P, max_iters, 5,
    or 8 for 8-point samples)."""
    return finish_pair(search_pair(prev, cur, cfg, generators, idx), cfg)


class VOState(NamedTuple):
    """Carried frame to frame, on the host apart from the tensors."""

    pose: Pose           # current camera->world pose T_wc, (3, 3) and (3,)
    prev: ORBFeatures    # previous frame's features, (N, ...)
    initialized: bool    # a frame has been processed
    frame_idx: int       # frames processed; the next frame draws from (seed, frame_idx)
    seed: int            # the sequence's RANSAC seed


class VOStepOutput(NamedTuple):
    """Per-frame record mirroring the reference's debug prints (tensors
    on the state's device; leading dim T when stacked)."""

    pose: Pose                      # pose after this frame
    num_keypoints: torch.Tensor     # () int32
    num_matches: torch.Tensor       # () int32 good matches
    num_inliers: torch.Tensor       # () int32 RANSAC inliers
    num_valid_points: torch.Tensor  # () int32 cheirality-valid
    pose_ok: torch.Tensor           # () bool
    scale: torch.Tensor             # () float32 0.3 / 0.0
    epipolar_residual: torch.Tensor  # () float32 mean |x2^T F x1| over inliers
    F: torch.Tensor                 # (3, 3) float32 last fundamental
    has_F: torch.Tensor             # () bool


def initial_state(cfg: VOConfig, seed: int = 0, device=None) -> VOState:
    """Identity pose, no previous features (all-invalid, all-zero slots),
    frame 0, on `device`."""
    n = cfg.orb.n_features
    z = functools.partial(torch.zeros, device=device)
    empty = ORBFeatures(
        xy=z((n, 2), dtype=torch.float32),
        response=z((n,), dtype=torch.float32),
        angle=z((n,), dtype=torch.float32),
        octave=z((n,), dtype=torch.int32),
        size=z((n,), dtype=torch.float32),
        desc=z((n, 32), dtype=torch.uint8),
        desc32=z((n, 8), dtype=torch.int32),
        valid=z((n,), dtype=torch.bool),
    )
    return VOState(pose=Pose.identity(device=device), prev=empty, initialized=False,
                   frame_idx=0, seed=int(seed))


def apply_motion(prev_pose: Pose, R_c2_c1: torch.Tensor, t_c2_c1: torch.Tensor,
                 have_rt: torch.Tensor, pose_ok: torch.Tensor, cfg: VOConfig):
    """World-pose update with the reference's scale/fallback ladder."""
    scale = torch.where(pose_ok, cfg.trajectory_scale, 0.0).to(torch.float32)
    R_inv, t_inv = se3.invert_relative(R_c2_c1, t_c2_c1)
    candidate = se3.compose_next_pose(prev_pose, R_inv, t_inv, scale)
    new_R = torch.where(have_rt[..., None, None], candidate.R, prev_pose.R)
    new_t = torch.where(have_rt[..., None], candidate.t, prev_pose.t)
    return Pose(new_R, new_t), scale


def vo_step(state: VOState, frame: torch.Tensor,
            cfg: VOConfig) -> tuple[VOState, VOStepOutput]:
    """Process one (H, W) grayscale frame on the state's device."""
    feats = detect_and_compute(frame, cfg.orb)
    with span("vo.seeds"):
        gens = pair_generators(state.seed, [state.frame_idx])
    est = estimate_pair(ORBFeatures(*(f[None] for f in state.prev)),
                        ORBFeatures(*(f[None] for f in feats)), cfg, generators=gens)
    est = {k: v[0] for k, v in est.items() if k != "stats"}
    moved, scale = apply_motion(state.pose, est["R"], est["t"], est["have_rt"],
                                est["pose_ok"], cfg)

    # First frame: identity pose, nothing estimated.
    first = not state.initialized

    def masked(x):
        return torch.zeros_like(x) if first else x

    new_pose = Pose.identity(device=frame.device) if first else moved
    new_state = VOState(pose=new_pose, prev=feats, initialized=True,
                        frame_idx=state.frame_idx + 1, seed=state.seed)
    out = VOStepOutput(
        pose=new_pose,
        num_keypoints=est["n_keypoints"],
        num_matches=masked(est["n_good"]),
        num_inliers=masked(est["n_inliers"]),
        num_valid_points=masked(est["n_valid_points"]),
        pose_ok=masked(est["pose_ok"]),
        scale=masked(scale),
        epipolar_residual=masked(est["mean_residual"]),
        F=est["F"],
        has_F=masked(est["have_rt"]),
    )
    return new_state, out
