"""Per-pair errors of the production path on the blurred pan (port of
tools/pan_blur_pair_probe.py).

The pan (seed 0, 32 frames, 320x240) with the harsh level's motion blur
(utils/synthetic.apply_photometric_nuisances(seed=17, blur_len_px=5.0,
which=("blur",))), ORB with 1200 keypoints; then pipeline/step.
estimate_pair (matcher, RANSAC with its refit, recover_pose) on every
consecutive pair, pair i drawing from pair_generators(0, [i]), under
three RANSAC configurations: `adaptive` (the defaults), `fixed0.5`
(adaptive_sigma off) and `fixed1.0` (adaptive_sigma off,
score_sigma_scale 1.0). Rows, one a configuration: rotation and
translation-direction errors against ground truth (deg), mean, p90 and
max. Stage 1 runs once for all frames; each configuration's pairs in one
estimate_pair call (a pair's draws and result do not depend on the
batch).

    python -m tpu_vo_torch.tools.pan_blur_pair_probe
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import estimate_pair, pair_generators
from tpu_vo_torch.tools import diag_common, profile_rows
from tpu_vo_torch.utils import synthetic

DEFAULTS = dict(width=320, height=240, T=32, features=1200)


def configs(W: int, H: int, n: int) -> dict:
    orb = ORBConfig(n_features=n)
    return {
        "adaptive": VOConfig(image_width=W, image_height=H, orb=orb),
        "fixed0.5": VOConfig(image_width=W, image_height=H, orb=orb,
                             ransac=RansacConfig(adaptive_sigma=False)),
        "fixed1.0": VOConfig(image_width=W, image_height=H, orb=orb,
                             ransac=RansacConfig(adaptive_sigma=False, score_sigma_scale=1.0)),
    }


def pair_errors(R, t, Rs, ts):
    """(rotation errors, direction errors) (deg) of relative motions R
    (P, 3, 3), t (P, 3) of pairs (i-1, i), i = 1..P, against the truth."""
    rot, terr = [], []
    for i in range(R.shape[0]):
        R_gt, t_gt = diag_common.gt_relative(Rs, ts, i + 1)
        rot.append(diag_common.rot_err_deg(R[i], R_gt))
        terr.append(diag_common.dir_err_deg(t[i], t_gt))
    return np.asarray(rot), np.asarray(terr)


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("pan_blur_pair_probe", o)
    frames, Rs, ts, _ = diag_common.scene("pan", o.T, o.width, o.height, 0)
    frames = synthetic.apply_photometric_nuisances(frames, seed=17, blur_len_px=5.0,
                                                   which=("blur",))
    cfgs = configs(o.width, o.height, o.features)
    batch = torch.from_numpy(np.stack(frames)).to(o.device)
    # the same ORB configuration for every variant
    feats = rows.run(lambda: runner.detect_frames(batch, cfgs["adaptive"]), (1, 1))
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    for name, cfg in cfgs.items():
        est = estimate_pair(prev, cur, cfg, generators=pair_generators(0, range(1, o.T)))
        r, te = pair_errors(est["R"].double().cpu().numpy(), est["t"].double().cpu().numpy(),
                            Rs, ts)
        rows.add(name, {"rot_mean": float(r.mean()), "rot_p90": float(np.percentile(r, 90)),
                        "rot_max": float(r.max()), "terr_mean": float(te.mean()),
                        "terr_p90": float(np.percentile(te, 90)), "terr_max": float(te.max()),
                        "pose_ok": float(est["pose_ok"].float().mean())})
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
