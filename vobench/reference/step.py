# Frozen copy of tpu_vo_torch/pipeline/step.py (plain parts only): the benchmark's reference.
"""The pair estimation, batched over consecutive pairs: match by Hamming
distance (cross-check and adaptive threshold, or the ratio test),
normalize, run the batched RANSAC, recover the pose and compute F. Every
gate of the failure ladder comes back as a boolean tensor, never a
branch. Pair i of a sequence draws its RANSAC samples from
`pair_generators(seed, [i])`.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from vobench.reference.configs import VOConfig
from vobench.reference.ransac import (
    find_essential_ransac,
    pixel_threshold_to_normalized,
)
from vobench.reference.recover_pose import recover_pose_from_essential
from vobench.reference.orb import ORBFeatures
from vobench.reference.camera import intrinsics, normalize_points
from vobench.reference.epipolar import algebraic_residual, fundamental_from_essential
from vobench.reference.filter import adaptive_threshold_filter, match_statistics
from vobench.reference.hamming import mutual_nearest_match, ratio_test_match


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


def estimate_pair(prev: ORBFeatures, cur: ORBFeatures, cfg: VOConfig,
                  generators: Optional[Sequence[torch.Generator]] = None,
                  idx: Optional[torch.Tensor] = None) -> dict:
    """Match P feature-set pairs (leading dim P) and estimate each relative
    motion (c2 <- c1). RANSAC samples come from one generator per pair or
    from explicit `idx` (P, max_iters, 5, or 8 for 8-point samples)."""
    K = _intrinsics(cfg.intrinsics, prev.xy.device, prev.xy.dtype)
    rcfg = cfg.ransac

    if cfg.match.use_ratio_test:
        good = ratio_test_match(prev.desc32, cur.desc32, prev.valid, cur.valid,
                                cfg.match.ratio)
        stats = match_statistics(good, cfg.match)
    else:
        raw = mutual_nearest_match(prev.desc32, cur.desc32, prev.valid, cur.valid)
        good, stats = adaptive_threshold_filter(raw, cfg.match)
    n_good = good.valid.sum(-1).to(torch.int32)

    p1 = prev.xy
    p2 = torch.gather(cur.xy, 1, good.train_idx[..., None].expand(-1, -1, 2))
    mask = good.valid
    x1n = normalize_points(p1, K)
    x2n = normalize_points(p2, K)
    thr = pixel_threshold_to_normalized(rcfg.threshold_px, K)

    res = find_essential_ransac(
        x1n, x2n, mask, thr, generators=generators, idx=idx,
        max_iters=rcfg.max_iters,
        use_five_point=rcfg.use_five_point,
        score=rcfg.score_method,
        score_sigma_scale=rcfg.score_sigma_scale,
        adaptive_sigma=rcfg.adaptive_sigma,
        cheirality_gate=rcfg.cheirality_gate,
        cheirality_min_frac=rcfg.cheirality_min_frac,
        distance_thresh=rcfg.distance_thresh,
    )
    rec = recover_pose_from_essential(res.E, x1n, x2n, res.inliers,
                                      rcfg.distance_thresh)

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

    F = fundamental_from_essential(res.E, K)
    resid = algebraic_residual(F, p1, p2)
    inl = res.inliers
    n_inl = torch.clamp(inl.sum(-1), min=1)
    mean_resid = torch.where(inl, resid, torch.zeros_like(resid)).sum(-1) / n_inl

    return dict(
        n_keypoints=cur.valid.sum(-1).to(torch.int32),
        n_good=n_good,
        stats=stats,
        R=rec.R,
        t=rec.t,
        have_rt=have_rt,
        pose_ok=pose_ok,
        n_inliers=res.num_inliers,
        n_valid_points=rec.num_valid,
        F=F,
        mean_residual=mean_resid,
        match_train_idx=good.train_idx,
        match_mask=res.inliers,
    )
