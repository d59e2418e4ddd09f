"""The pan's harsh nuisance level split into its four nuisances, ours
against the reference (port of tools/pan_harsh_ablation.py).

The pan (seed 0, 32 frames, 320x240) clean, with each nuisance alone at
the harsh level's amplitude (noise, exposure, blur, jpeg; utils/
synthetic.apply_photometric_nuisances, seed 17), and with all four
(HARSH): the batched runner (frame_chunk 8, pair_chunk the first of 9,
7, 11, 13 that divides the pairs, else all) with 1200 keypoints, and the
OpenCV reference on the same frames. The reference's side comes from the
committed legs (reference="committed"; each leg's frames rendered and
degraded here, their sha256 checked): config6_pan_clean, diag_pan_only_
<nuisance> and config6_pan_harsh; or from utils/cv_reference.ReferenceVO
here (reference="cv2"). --knobs also runs ours alone on the blurred pan
with four candidate fixes (MSAC sigma scale 1.5 and 2.0, FAST threshold
5, both).

Rows, one a case (clean, only_noise, only_exposure, only_blur,
only_jpeg, harsh_all, and the knobs'): ours_ate_vs_gt_rel, the median
matches and inliers, the pose_ok share and RPE (utils/metrics.rpe) as
ours_*, and the reference's ATE and RPE as ref_*. (The JAX tool names
our side tpu_vo_*.)

    python -m tpu_vo_torch.tools.pan_harsh_ablation [--knobs] [--reference committed|cv2]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.tools import diag_common, profile_rows
from tpu_vo_torch.utils import synthetic
from tpu_vo_torch.utils.metrics import rpe, scale_matched_gt

DEFAULTS = dict(width=320, height=240, frames=32, features=1200, knobs=False,
                reference="committed")
HARSH = synthetic.NUISANCE_LEVELS["harsh"]  # the four nuisances' amplitudes


def cases():
    """[(case, its leg's degradation label, apply_photometric_nuisances
    keywords or None)]."""
    out = [("clean", None, None)]
    out += [(f"only_{n}", f"only_{n}", dict(HARSH, which=(n,))) for n in synthetic.NUISANCES]
    return out + [("harsh_all", "harsh", dict(HARSH))]


def knob_configs(W: int, H: int, n: int) -> dict:
    return {
        "blur_sigma1.5": VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=n),
                                  ransac=RansacConfig(score_sigma_scale=1.5)),
        "blur_sigma2.0": VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=n),
                                  ransac=RansacConfig(score_sigma_scale=2.0)),
        "blur_fast5": VOConfig(image_width=W, image_height=H,
                               orb=ORBConfig(n_features=n, fast_threshold=5)),
        "blur_fast5_sigma1.5": VOConfig(image_width=W, image_height=H,
                                        orb=ORBConfig(n_features=n, fast_threshold=5),
                                        ransac=RansacConfig(score_sigma_scale=1.5)),
    }


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    how = diag_common.check_reference(o.reference)
    rows = profile_rows.Rows("pan_harsh_ablation", o)
    W, H, T = o.width, o.height, o.frames
    spec = ("pan", T, W, H, 0)
    frames_np, Rs, ts, _ = diag_common.scene(*spec)
    gt_R, gt_t = np.stack(Rs), scale_matched_gt(np.stack(ts))
    pc = diag_common.pair_chunk(T)
    calls = profile_rows.frame_launches(T, 8)

    def ours(deg, cfg):
        poses, diags = rows.run(lambda: runner.run_sequence_batched(
            torch.from_numpy(np.stack(deg)), cfg, device=o.device, frame_chunk=8,
            pair_chunk=pc), (calls, calls))
        t, R = poses.t.double().cpu().numpy(), poses.R.double().cpu().numpy()
        entry = {"ours_ate_vs_gt_rel": diag_common.ate_vs_gt_rel(t, ts),
                 "ours_matches_median": int(np.median(diags["num_matches"].cpu().numpy())),
                 "ours_inliers_median": int(np.median(diags["num_inliers"].cpu().numpy())),
                 "ours_pose_ok_frac": float(diags["pose_ok"].float().mean())}
        entry.update({"ours_" + k: v for k, v in rpe(t, gt_t, R, gt_R).items()})
        return entry

    base = VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=o.features))
    for tag, label, kwargs in cases():
        name = diag_common.leg_for(spec, label)
        if how == "committed" and name is not None:
            deg = diag_common.leg_frames(name)[0]
        else:
            deg = (list(frames_np) if kwargs is None else synthetic.apply_photometric_nuisances(
                frames_np, seed=synthetic.NUISANCE_SEED, **kwargs))
        entry = ours(deg, base)
        t_ref, R_ref, _ = diag_common.reference(how, name, deg, W, H)
        entry["ref_ate_vs_gt_rel"] = diag_common.ate_vs_gt_rel(t_ref, ts)
        entry.update({"ref_" + k: v for k, v in rpe(t_ref, gt_t, R_ref, gt_R).items()})
        entry["reference"] = how if how == "cv2" else f"committed leg {name}"
        rows.add(tag, entry)

    if o.knobs:
        deg = synthetic.apply_photometric_nuisances(frames_np, seed=synthetic.NUISANCE_SEED,
                                                    **dict(HARSH, which=("blur",)))
        for tag, cfg in knob_configs(W, H, o.features).items():
            rows.add(tag, ours(deg, cfg))
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
