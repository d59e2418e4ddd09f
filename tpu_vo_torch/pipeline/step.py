"""Pair estimation, batched over consecutive pairs (port of
tpu_vo/pipeline/step.py `estimate_pair`).

Match by Hamming distance with a cross-check, apply the adaptive
threshold, normalize, run the batched 5-point RANSAC, recover the pose
and compute F. Every gate of the reference's failure ladder comes back
as a boolean tensor, never a branch.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.estimation.ransac import (
    find_essential_ransac,
    pixel_threshold_to_normalized,
)
from tpu_vo_torch.estimation.recover_pose import recover_pose_from_essential
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry.camera import intrinsics, normalize_points
from tpu_vo_torch.geometry.epipolar import algebraic_residual, fundamental_from_essential
from tpu_vo_torch.matching.filter import adaptive_threshold_filter
from tpu_vo_torch.matching.hamming import mutual_nearest_match


@functools.lru_cache(maxsize=None)
def _intrinsics(fx_fy_cx_cy, device: torch.device) -> torch.Tensor:
    """K on `device`, built once per calibration (a copy from pageable
    host memory waits for the stream to drain)."""
    return intrinsics(*fx_fy_cx_cy, device=device)


def check_supported(cfg: VOConfig) -> None:
    """The port runs the default estimator; raise on the options whose
    paths are not ported yet (ROADMAP.md Queue A)."""
    r = cfg.ransac
    unported = [name for name, on in (
        ("match.use_ratio_test", cfg.match.use_ratio_test),
        ("ransac.use_five_point=False", not r.use_five_point),
        ("ransac.score_method != 'msac'", r.score_method != "msac"),
        ("ransac.min_valid_fraction > 0", r.min_valid_fraction > 0.0),
    ) if on]
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")


def estimate_pair(prev: ORBFeatures, cur: ORBFeatures, cfg: VOConfig,
                  generators: Optional[Sequence[torch.Generator]] = None,
                  idx: Optional[torch.Tensor] = None) -> dict:
    """Match P feature-set pairs (leading dim P) and estimate each relative
    motion (c2 <- c1). RANSAC samples come from one generator per pair or
    from explicit `idx` (P, max_iters, 5)."""
    check_supported(cfg)
    dev = prev.xy.device
    K = _intrinsics(cfg.intrinsics, dev)
    rcfg = cfg.ransac

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
