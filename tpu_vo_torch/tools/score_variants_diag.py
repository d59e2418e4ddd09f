"""Nine ways to rank RANSAC hypotheses on one fixed pool a pair (port of
tools/score_variants_diag.py).

For each consecutive pair and RANSAC seed, one pool of hypotheses: 256
five-point samples drawn as RANSAC draws them (estimation/ransac.
draw_samples, pair i from pipeline/step.pair_generators(seed, [i])),
their candidates from the SoA solver (five_point_candidates_batched).
Each hypothesis is scored against every match with geometry/epipolar.
sampson_error, and the pool is ranked under each variant; the winner's
pose (recover_pose_from_essential on its inliers) is compared with the
ground truth: rotation error and translation-direction error (deg).

Variants (thr: 2 px in normalized units):
  count       inlier count at thr
  msac1       MSAC sum, sigma = thr
  msac1n      MSAC per inlier, sigma = thr
  msac05n     MSAC per inlier, sigma = thr/2
  msac025n    MSAC per inlier, sigma = thr/4
  ladder      sum over sigma in {thr, thr/2, thr/4} of loss(sigma)/sigma^2
  laddern     ladder per inlier
  lex         count, ties broken by the thr/4 loss
  adapt       msac05n's winner's median inlier residual r sets sigma^2 =
              clip(9 r, (thr/2)^2, thr^2); all re-ranked per inlier at it

Defaults as the JAX tool's: the corridor (seed 0) at 1241x376, 16
frames, 2000 keypoints, seeds (0, 1); --scene pan uses the pan (seed 3);
--nuisance blur blurs the frames first (utils/synthetic.
apply_photometric_nuisances(seed=17, blur_len_px=5.0, which=("blur",))).
Rows: one a variant (rotation mean, p90, max; translation mean, max) and
`config`. Stage 1 runs once for all frames (one launch of B1 and of B2).

    python -m tpu_vo_torch.tools.score_variants_diag [--frames 16] [--scene pan]
        [--nuisance blur]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.estimation.five_point import five_point_candidates_batched
from tpu_vo_torch.estimation.ransac import _take, draw_samples, pixel_threshold_to_normalized
from tpu_vo_torch.estimation.recover_pose import recover_pose_from_essential
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry.camera import intrinsics_from_image_size
from tpu_vo_torch.geometry.epipolar import sampson_error
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import pair_generators
from tpu_vo_torch.tools import diag_common, profile_pairs, profile_rows
from tpu_vo_torch.utils import synthetic

DEFAULTS = dict(width=1241, height=376, frames=16, features=2000, seeds=(0, 1), scene="corridor",
                nuisance="none", hyps=256)
VARIANTS = ("count", "msac1", "msac1n", "msac05n", "msac025n", "ladder", "laddern", "lex",
            "adapt")
SCENE_SEED = {"corridor": 0, "pan": 3}


def _errors(Es, x1n, x2n):
    """(H, N) Sampson errors of hypotheses Es (H, 3, 3), inf if not finite."""
    err = sampson_error(Es, x1n[None], x2n[None])
    return torch.where(torch.isfinite(err), err, torch.full_like(err, float("inf")))


def pool_scores(Es, x1n, x2n, mask, thr_sq: float):
    """(inliers (H, N), count, broad, half, tight (H,)) of hypotheses Es
    (H, 3, 3) on one pair's matches: the inlier count at thr_sq and the
    truncated Sampson sums at thr_sq, thr_sq/4 and thr_sq/16."""
    err = _errors(Es, x1n, x2n)
    inl = (err < thr_sq) & mask
    zero = torch.zeros((), dtype=err.dtype, device=err.device)

    def loss(s_sq):
        return torch.where(mask, torch.minimum(err, torch.full_like(err, s_sq)), zero).sum(-1)

    return inl, inl.sum(-1), loss(thr_sq), loss(thr_sq * 0.25), loss(thr_sq * 0.0625)


def ranks(cnts, broads, halfs, tights, thr_sq: float, n: int) -> dict:
    """The first eight variants' ranks (float64 numpy, larger is better)."""
    half_sq, tight_sq = thr_sq * 0.25, thr_sq * 0.0625
    c, b, h, t = (np.asarray(x.cpu(), np.float64) for x in (cnts, broads, halfs, tights))
    ladder = b / thr_sq + h / half_sq + t / tight_sq
    per = np.maximum(c, 1)
    return {"count": c, "msac1": -b, "msac1n": -b / per, "msac05n": -h / per,
            "msac025n": -t / per, "ladder": -ladder, "laddern": -ladder / per,
            "lex": c - t / (tight_sq * n)}


def winners(Es, vm, x1n, x2n, mask, thr_sq: float):
    """({variant: index of its winner}, inliers (H, N)) of one pool: Es
    (H, 3, 3), valid vm (H,), one pair's x1n, x2n (N, 2) and mask (N,)."""
    inls, cnts, broads, halfs, tights = pool_scores(Es, x1n, x2n, mask, thr_sq)
    r = ranks(cnts, broads, halfs, tights, thr_sq, int(mask.shape[0]))
    vm_np = vm.cpu().numpy()
    w05 = int(np.argmax(np.where(vm_np, r["msac05n"], -np.inf)))
    # adapt: sigma from the msac05n winner's inlier residuals
    err = _errors(Es[w05:w05 + 1], x1n, x2n)[0]
    med = float(np.median(err[inls[w05]].cpu().numpy())) if bool(inls[w05].any()) else np.nan
    s_sq = float(np.float32(np.clip(9.0 * med, 0.25 * thr_sq, thr_sq)))  # as f32, as JAX's
    zero = torch.zeros((), dtype=x1n.dtype, device=x1n.device)
    e_all = _errors(Es, x1n, x2n)
    al = torch.where(mask, torch.minimum(e_all, torch.full_like(e_all, s_sq)), zero).sum(-1)
    r["adapt"] = -np.asarray(al.cpu(), np.float64) / np.maximum(
        np.asarray(cnts.cpu(), np.float64), 1)
    return {v: int(np.argmax(np.where(vm_np, r[v], -np.inf))) for v in VARIANTS}, inls


def frames_of(scene: str, T: int, W: int, H: int, nuisance: str):
    """(frames, Rs, ts) of the tool's scene."""
    frames, Rs, ts, _ = diag_common.scene(scene, T, W, H, SCENE_SEED[scene])
    if nuisance == "blur":
        frames = synthetic.apply_photometric_nuisances(frames, seed=17, blur_len_px=5.0,
                                                       which=("blur",))
    elif nuisance not in (None, "none"):  # --nuisance none parses to None
        raise ValueError(f"nuisance must be 'none' or 'blur', got {nuisance!r}")
    return frames, Rs, ts


def main(argv=None, device=None, **sizes) -> dict:
    if "T" in sizes:  # the JAX tool's main names the frames T, its command line --frames
        sizes["frames"] = sizes.pop("T")
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("score_variants_diag", o)
    dev = o.device
    frames, Rs, ts = frames_of(o.scene, o.frames, o.width, o.height, o.nuisance)
    cfg = VOConfig(image_width=o.width, image_height=o.height,
                   orb=ORBConfig(n_features=o.features))
    K = intrinsics_from_image_size(o.width, o.height, device=dev)
    thr = float(pixel_threshold_to_normalized(2.0, K))
    thr_sq = thr ** 2
    feats = rows.run(lambda: runner.detect_frames(torch.from_numpy(np.stack(frames)).to(dev), cfg),
                     (1, 1))
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    good, _ = profile_pairs.match_stage(prev, cur, cfg)
    _, _, x1n, x2n, mask = profile_pairs.prep_stage(prev, cur, good, K)
    rot = {v: [] for v in VARIANTS}
    terr = {v: [] for v in VARIANTS}
    for i in range(o.frames - 1):
        R_gt, t_gt = diag_common.gt_relative(Rs, ts, i + 1)
        for seed in o.seeds:
            idx = draw_samples(pair_generators(seed, [i + 1]), mask[i:i + 1], o.hyps, 5)
            Es, vm = five_point_candidates_batched(_take(x1n[i:i + 1], idx),
                                                   _take(x2n[i:i + 1], idx))
            Es, vm = Es.reshape(-1, 3, 3), vm.reshape(-1)
            win, inls = winners(Es, vm, x1n[i], x2n[i], mask[i], thr_sq)
            b = torch.tensor([win[v] for v in VARIANTS], device=dev)
            rec = recover_pose_from_essential(Es[b], x1n[i].expand(len(b), -1, -1),
                                              x2n[i].expand(len(b), -1, -1), inls[b],
                                              cfg.ransac.distance_thresh)
            Rw, tw = rec.R.double().cpu().numpy(), rec.t.double().cpu().numpy()
            for j, v in enumerate(VARIANTS):
                rot[v].append(diag_common.rot_err_deg(Rw[j], R_gt))
                terr[v].append(diag_common.dir_err_deg(tw[j], t_gt))
    for v in VARIANTS:
        r, te = np.array(rot[v]), np.array(terr[v])
        rows.add(v, {"rot_mean": float(r.mean()), "rot_p90": float(np.percentile(r, 90)),
                     "rot_max": float(r.max()), "t_mean": float(te.mean()),
                     "t_max": float(te.max()), "rot": rot[v], "terr": terr[v]})
    rows.add("config", {"W": o.width, "H": o.height, "T": o.frames, "n_feat": o.features,
                        "scene": o.scene, "nuisance": o.nuisance or "none", "seeds": list(o.seeds)})
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
