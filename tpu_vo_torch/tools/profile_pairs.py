"""Pair estimation split by substage (port of tools/profile_pairs.py).

On bench.py's configuration (T=64 frames of make_sequence(64, 1241, 376,
seed=0), 1200 keypoints, 256 hypotheses; features at frame_chunk 8) at
the runner's pair tiling (pc pairs a call over the 63 pairs), it times:

  match+filter        Hamming matching with the cross-check and the
                      adaptive threshold (the ratio test where configured)
  +gather+normalize   the same, then the matched points gathered and
                      normalized by K
  ransac              estimation/ransac.find_essential_ransac
  recover_pose        estimation/recover_pose.recover_pose_from_essential
  F+residual diag     F from E and the mean algebraic residual of the inliers
  full estimate_pair  pipeline/step.estimate_pair (runner.estimate_pairs)

each chunk-mapped at pc; the row "composed_equal" says whether the
substages chained give estimate_pair's outputs bit for bit on this
device. Rows as tools/profile_rows says (torch.profiler's figures on
every row: all are stage 2).

    python -m tpu_vo_torch.tools.profile_pairs [--pc 9 --reps 16]
"""

from __future__ import annotations

import sys

import torch

from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.estimation.ransac import find_essential_ransac, pixel_threshold_to_normalized
from tpu_vo_torch.estimation.recover_pose import recover_pose_from_essential
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry.camera import normalize_points
from tpu_vo_torch.geometry.epipolar import algebraic_residual, fundamental_from_essential
from tpu_vo_torch.matching.filter import adaptive_threshold_filter, match_statistics
from tpu_vo_torch.matching.hamming import mutual_nearest_match, ratio_test_match
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import _intrinsics, pair_generators
from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(T=64, width=1241, height=376, features=1200, hyps=256, fc=8, pc=9,
                reps=16, iters=5)
COMPARED = ("n_good", "match_train_idx", "n_inliers", "match_mask", "R", "t",
            "n_valid_points", "F", "mean_residual")


def match_stage(prev: ORBFeatures, cur: ORBFeatures, cfg: VOConfig):
    """(good matches, match statistics), as estimate_pair matches."""
    if cfg.match.use_ratio_test:
        good = ratio_test_match(prev.desc32, cur.desc32, prev.valid, cur.valid, cfg.match.ratio)
        return good, match_statistics(good, cfg.match)
    raw = mutual_nearest_match(prev.desc32, cur.desc32, prev.valid, cur.valid)
    return adaptive_threshold_filter(raw, cfg.match)


def prep_stage(prev: ORBFeatures, cur: ORBFeatures, good, K: torch.Tensor):
    """(p1, p2, x1n, x2n, mask): the matched pixels and their normalized
    coordinates."""
    p1 = prev.xy
    p2 = torch.gather(cur.xy, 1, good.train_idx[..., None].expand(-1, -1, 2))
    return p1, p2, normalize_points(p1, K), normalize_points(p2, K), good.valid


def ransac_options(rcfg: RansacConfig) -> dict:
    """find_essential_ransac's keyword arguments as estimate_pair passes
    them from `rcfg`."""
    return dict(max_iters=rcfg.max_iters, use_five_point=rcfg.use_five_point,
                score=rcfg.score_method, score_sigma_scale=rcfg.score_sigma_scale,
                adaptive_sigma=rcfg.adaptive_sigma, cheirality_gate=rcfg.cheirality_gate,
                cheirality_min_frac=rcfg.cheirality_min_frac,
                distance_thresh=rcfg.distance_thresh)


def ransac_stage(x1n, x2n, mask, K, cfg: VOConfig, generators):
    return find_essential_ransac(
        x1n, x2n, mask, pixel_threshold_to_normalized(cfg.ransac.threshold_px, K),
        generators=generators, **ransac_options(cfg.ransac))


def recover_stage(res, x1n, x2n, cfg: VOConfig):
    return recover_pose_from_essential(res.E, x1n, x2n, res.inliers, cfg.ransac.distance_thresh)


def diag_stage(E, K, p1, p2, inliers):
    """(F, mean algebraic residual over the inliers)."""
    F = fundamental_from_essential(E, K)
    resid = algebraic_residual(F, p1, p2)
    n_inl = torch.clamp(inliers.sum(-1), min=1)
    return F, torch.where(inliers, resid, torch.zeros_like(resid)).sum(-1) / n_inl


def composed(prev: ORBFeatures, cur: ORBFeatures, cfg: VOConfig, generators) -> dict:
    """The substages chained on one batch of pairs: estimate_pair's
    outputs named in COMPARED."""
    K = _intrinsics(cfg.intrinsics, prev.xy.device, prev.xy.dtype)
    good, _ = match_stage(prev, cur, cfg)
    p1, p2, x1n, x2n, mask = prep_stage(prev, cur, good, K)
    res = ransac_stage(x1n, x2n, mask, K, cfg, generators)
    rec = recover_stage(res, x1n, x2n, cfg)
    F, resid = diag_stage(res.E, K, p1, p2, res.inliers)
    return dict(n_good=good.valid.sum(-1).to(torch.int32), match_train_idx=good.train_idx,
                n_inliers=res.num_inliers, match_mask=res.inliers, R=rec.R, t=rec.t,
                n_valid_points=rec.num_valid, F=F, mean_residual=resid)


def _part(f: ORBFeatures, a: int, e: int) -> ORBFeatures:
    return ORBFeatures(*(x[a:e] for x in f))


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("profile_pairs", o)
    T = o.T
    cfg = VOConfig(image_width=o.width, image_height=o.height,
                   orb=ORBConfig(n_features=o.features), ransac=RansacConfig(max_iters=o.hyps))
    frames = torch.from_numpy(profile_rows.sequence(T, o.width, o.height).copy()).to(o.device)
    n1 = profile_rows.frame_launches(T, o.fc)
    feats = rows.run(lambda: runner.detect_frames(frames, cfg, o.fc), (n1, n1))
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    K = _intrinsics(cfg.intrinsics, prev.xy.device, prev.xy.dtype)
    spans = runner._spans(T - 1, o.pc)
    P = [(_part(prev, a, e), _part(cur, a, e)) for a, e in spans]

    def gens():
        g = pair_generators(0, range(1, T))
        return [g[a:e] for a, e in spans]

    def match_fn():
        return [match_stage(p, c, cfg) for p, c in P]

    def prep_fn():
        return [prep_stage(p, c, match_stage(p, c, cfg)[0], K) for p, c in P]

    preps = rows.run(prep_fn)

    def ransac_fn():
        return [ransac_stage(x1, x2, m, K, cfg, g)
                for (_, _, x1, x2, m), g in zip(preps, gens())]

    res = rows.run(ransac_fn)

    def recover_fn():
        return [recover_stage(r, x1, x2, cfg) for r, (_, _, x1, x2, _) in zip(res, preps)]

    def diag_fn():
        return [diag_stage(r.E, K, p1, p2, r.inliers) for r, (p1, p2, _, _, _) in zip(res, preps)]

    def full_fn():
        return runner.estimate_pairs(prev, cur, cfg, pair_generators(0, range(1, T)), o.pc)

    t = dict(reps=o.reps, iters=o.iters, profile=True, per=("pair", T - 1))
    rows.add("tiling", {"pairs": T - 1, "pc": o.pc, "calls": len(spans), "hyps": o.hyps})
    rows.time("match+filter", match_fn, **t)
    rows.time("+gather+normalize", prep_fn, **t)
    rows.time("ransac", ransac_fn, **t)
    rows.time("recover_pose", recover_fn, **t)
    rows.time("F+residual diag", diag_fn, **t)
    rows.time("full estimate_pair", full_fn, **t)
    a = runner._cat([composed(p, c, cfg, g) for (p, c), g in zip(P, gens())])
    b = rows.run(full_fn)
    rows.add("composed_equal", all(torch.equal(a[k], b[k]) for k in COMPARED))
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
