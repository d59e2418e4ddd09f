"""Per-pair errors of the reference, ours and the two crosses against
ground truth (port of tools/diagnose_ate.py).

For every consecutive pair of the planes scene (utils/synthetic.
make_sequence, 640x480, 30 frames, seed 0) or of the corridor
(--scene corridor, seed 0), the rotation error (geodesic, deg) and the
translation-direction error (deg, sign-agnostic) of the motion
c_i <- c_{i-1} against ground truth, for:

  A  the OpenCV reference: its relative motion as its trajectory holds it
     (utils/cv_reference.ReferenceVO composes R and, where it kept a
     pose, the direction of t), from the committed leg diag_planes_640x480
     (reference="committed"; frames' sha256 checked; the corridor has no
     committed leg at this length) or from ReferenceVO run here
     (reference="cv2");
  B  ours: ORB (stage 1 once for all frames), mutual nearest matches with
     the adaptive threshold, then estimation/ransac.find_essential_ransac
     (max_iters and use_five_point from the config, the other options
     its defaults, pair i drawing from pair_generators(0, [i])) and
     recover_pose_from_essential on the matches padded to n_features;
  C  cv2.findEssentialMat (RANSAC, 0.999, 2 px) and cv2.recoverPose on
     our matches;
  D  our estimator, as in B, on the reference's matches (cv2's ORB and
     cross-checked BFMatcher with the reference's distance threshold).

C against B isolates the estimator; D against A the frontend. C and D
need cv2 at run time: they run where cv2 imports and the device is the
CPU; elsewhere (the card's host has no cv2) each is the string row
"needs cv2: ...", never a value from another device.

Rows: `pair<i>` with A-D as [rotation, direction] (a string where that
side failed), our inliers and matches; `mean` with each side's mean
over all pairs, a failed pair counting 0, as the JAX tool sums.

    python -m tpu_vo_torch.tools.diagnose_ate [--scene planes|corridor] [--frames 30]
        [--reference committed|cv2] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.estimation.ransac import find_essential_ransac, pixel_threshold_to_normalized
from tpu_vo_torch.estimation.recover_pose import recover_pose_from_essential
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry.camera import normalize_points
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import pair_generators
from tpu_vo_torch.tools import diag_common, profile_pairs, profile_rows

DEFAULTS = dict(scene="planes", frames=30, width=640, height=480, reference="committed")
SIDES = ("A", "B", "C", "D")


def cv_estimate(p1, p2, K):
    """(R, t, inliers, cheirality count) of cv2's estimator, else None."""
    import cv2

    E, mask = cv2.findEssentialMat(p1, p2, K, cv2.RANSAC, 0.999, 2.0)
    if E is None or E.shape != (3, 3):
        return None
    ninl = int(mask.sum())
    nval, R, t, _ = cv2.recoverPose(E, p1, p2, K, mask=mask.copy())
    return R, t, ninl, nval


def our_estimate(p1, p2, K, cfg: VOConfig, generator: torch.Generator, device):
    """(R, t, inliers, cheirality count) of our estimator on pixel matches
    p1, p2 (n, 2), padded (or cut) to n_features slots."""
    n = cfg.orb.n_features
    p1, p2 = p1[:n], p2[:n]
    pad = n - len(p1)
    p1p = np.pad(np.asarray(p1, np.float32), ((0, pad), (0, 0)))
    p2p = np.pad(np.asarray(p2, np.float32), ((0, pad), (0, 0)))
    mask = torch.from_numpy(np.arange(n) < len(p1)).to(device)[None]
    Kt = torch.as_tensor(K, dtype=torch.float32, device=device)
    x1n = normalize_points(torch.from_numpy(p1p).to(device), Kt)[None]
    x2n = normalize_points(torch.from_numpy(p2p).to(device), Kt)[None]
    thr = pixel_threshold_to_normalized(cfg.ransac.threshold_px, Kt)
    res = find_essential_ransac(x1n, x2n, mask, thr, generators=[generator],
                                max_iters=cfg.ransac.max_iters,
                                use_five_point=cfg.ransac.use_five_point)
    rec = recover_pose_from_essential(res.E, x1n, x2n, res.inliers, cfg.ransac.distance_thresh)
    return (rec.R[0].double().cpu().numpy(), rec.t[0].double().cpu().numpy(),
            int(res.num_inliers[0]), int(rec.num_valid[0]))


def reference_matches(orb, bf, f1, f2):
    """The reference's matched pixels (float32 (n, 2) each) of two frames."""
    k1, d1 = orb.detectAndCompute(f1, None)
    k2, d2 = orb.detectAndCompute(f2, None)
    ms = bf.match(d1, d2)
    dists = sorted(m.distance for m in ms)
    thr = min(max(3.0 * dists[0], 0.7 * dists[len(dists) // 2]), 35.0)
    good = [m for m in ms if m.distance < thr]
    return (np.float32([k1[m.queryIdx].pt for m in good]).reshape(-1, 2),
            np.float32([k2[m.trainIdx].pt for m in good]).reshape(-1, 2))


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    how = diag_common.check_reference(o.reference)
    if o.scene not in ("planes", "corridor"):
        raise ValueError(f"scene must be planes or corridor, got {o.scene!r}")
    rows = profile_rows.Rows("diagnose_ate", o)
    w, h, dev = o.width, o.height, o.device
    spec = (o.scene, o.frames, w, h, 0)
    frames, Rs, ts, K = diag_common.scene(*spec)
    cfg = VOConfig(image_width=w, image_height=h)
    Kf = np.asarray(K, np.float64)
    leg = diag_common.leg_for(spec)
    t_ref, R_ref, _ = diag_common.reference(how, leg, frames, w, h)
    crosses = dev.type == "cpu" and diag_common.cv2_available()
    if crosses:
        import cv2

        orb = cv2.ORB_create(nfeatures=1200, scaleFactor=1.2, nlevels=8, edgeThreshold=31,
                             firstLevel=0, WTA_K=2, scoreType=cv2.ORB_HARRIS_SCORE,
                             patchSize=31, fastThreshold=10)
        bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)

    feats = rows.run(lambda: runner.detect_frames(torch.from_numpy(np.stack(frames)).to(dev),
                                                  cfg), (1, 1))
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    good, _ = profile_pairs.match_stage(prev, cur, cfg)
    valid = good.valid.cpu().numpy()
    tidx = good.train_idx.cpu().numpy()
    xy_prev, xy_cur = prev.xy.cpu().numpy(), cur.xy.cpu().numpy()

    sums = {s: np.zeros(2) for s in SIDES}
    for i in range(1, len(frames)):
        R_rel, t_rel = diag_common.gt_relative(Rs, ts, i)

        def err(R, t):
            return [diag_common.rot_err_deg(R_rel, R), diag_common.dir_err_deg(t_rel, t)]

        row = {}
        Ra, ta = diag_common.pair_motion(t_ref, R_ref, i)
        row["A"] = [diag_common.rot_err_deg(R_rel, Ra),
                    "no translation: the reference held its position" if ta is None
                    else diag_common.dir_err_deg(t_rel, ta)]
        op1 = xy_prev[i - 1][valid[i - 1]]
        op2 = xy_cur[i - 1][tidx[i - 1][valid[i - 1]]]
        gen = pair_generators(0, [i])[0]
        B = our_estimate(op1, op2, Kf, cfg, gen, dev)
        row["B"] = err(B[0], B[1])
        if crosses:
            C = cv_estimate(op1.astype(np.float32), op2.astype(np.float32), Kf)
            rp1, rp2 = reference_matches(orb, bf, frames[i - 1], frames[i])
            D = our_estimate(rp1.astype(np.float64), rp2.astype(np.float64), Kf, cfg,
                             pair_generators(0, [i])[0], dev)
            row["C"] = "fail" if C is None else err(C[0], C[1])
            row["D"] = err(D[0], D[1])
            row["matches_reference"] = len(rp1)
        else:
            row["C"] = row["D"] = diag_common.NEEDS_CV2
        row["inliers_B"] = B[2]
        row["matches_B"] = int(valid[i - 1].sum())
        for s in SIDES:
            if isinstance(row[s], list):
                sums[s] += [v if isinstance(v, float) else 0.0 for v in row[s]]
        rows.add(f"pair{i}", row)
    n = len(frames) - 1
    rows.add("mean", {s: (sums[s] / n).tolist() if s in ("A", "B") or crosses
                      else diag_common.NEEDS_CV2 for s in SIDES}
             | {"reference": how if how == "cv2" else f"committed leg {leg}"})
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
