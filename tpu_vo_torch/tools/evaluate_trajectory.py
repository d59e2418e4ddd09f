"""Trajectory evaluation: ATE / RPE between two trajectory files (port of
tools/evaluate_trajectory.py).

Accepts TUM format (8 columns: timestamp + translation + quaternion) and
KITTI odometry format (12 columns: T_wc[:3,:4] row-major), auto-detected
per file — so estimates evaluate directly against KITTI poses/<NN>.txt.

Usage: python -m tpu_vo_torch.tools.evaluate_trajectory EST.txt GT.txt
       [--align none|rigid|scale]

Computes RMS absolute trajectory error (optionally with Umeyama similarity
alignment — monocular trajectories have arbitrary scale) and mean relative
pose errors over consecutive frames. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from tpu_vo_torch.utils.metrics import load_trajectory_any, rpe, umeyama_alignment


def evaluate(est_t, gt_t, est_R=None, gt_R=None, align="none"):
    n = min(len(est_t), len(gt_t))
    est_t, gt_t = est_t[:n], gt_t[:n]
    est_al = est_t
    if align in ("rigid", "scale") and n >= 3:
        s, R, t = umeyama_alignment(est_t, gt_t, align == "scale")
        est_al = (s * (R @ est_t.T)).T + t
    ate = float(np.sqrt(np.mean(np.sum((est_al - gt_t) ** 2, axis=1))))
    out = {"ate_rmse": round(ate, 6), "frames": n, "align": align}
    # RPE on per-step motions; scale-match the estimate's steps to GT's
    # mean step (the two files may use different/arbitrary scales).
    if n >= 2:
        step_e = float(np.linalg.norm(np.diff(est_t, axis=0), axis=1).mean())
        step_g = float(np.linalg.norm(np.diff(gt_t, axis=0), axis=1).mean())
        est_s = est_t * (step_g / step_e) if step_e > 0 else est_t
        out.update(rpe(est_s, gt_t,
                       None if est_R is None else est_R[:n],
                       None if gt_R is None else gt_R[:n]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("estimate")
    p.add_argument("groundtruth")
    p.add_argument("--align", choices=["none", "rigid", "scale"],
                   default="scale")
    args = p.parse_args(argv)

    est_R, est_t = load_trajectory_any(args.estimate)
    gt_R, gt_t = load_trajectory_any(args.groundtruth)
    result = evaluate(
        np.asarray(est_t, dtype=np.float64),
        np.asarray(gt_t, dtype=np.float64),
        None if est_R is None else np.asarray(est_R, dtype=np.float64),
        None if gt_R is None else np.asarray(gt_R, dtype=np.float64),
        args.align,
    )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
