"""Why the keep-ties stage-1 cut (ORBConfig.retain_best_keep_ties) moves
ATE at one resolution one way and at another the other (port of
tools/keepties_diag.py).

On the corridor (seed 0) at 640x480 with 1000 keypoints (96 frames,
pair_chunk 95) and at 1241x376 with 2000 (64 frames, pair_chunk 9):

  A  frame 0's keypoint set of each mode against cv2's ORB at the same
     settings, each keypoint as (round(4x), round(4y), octave): the share
     of cv2's set ours holds. cv2's sets come from the committed
     data/diagnostic_reference.json (reference="committed": frame 0's
     sha256 checked), or from cv2 here (reference="cv2");
  B  the stage-1 tie plateau per level: FAST corners inside the border
     (features/fast.detect, kernel B3 on the card), and how many score at
     least the 2n-th score, against the 2n cut and the 4n capacity;
  C  ATE against ground truth over its extent of the batched runner in
     both modes, and the reference's: from the committed legs config1 and
     config2 (these scenes; frames' sha256 checked) or from
     utils/cv_reference.ReferenceVO here;
  D  of frame 0's keypoints, those only one mode keeps and those both
     keep: how many, and the share with a mutual nearest match in frame 1.

Rows: one a resolution, `<W>x<H>`, with the JAX tool's keys. Launches:
B1 and B2 once a detect_and_compute call and a runner's frame chunk, B3
once a level in B.

    python -m tpu_vo_torch.tools.keepties_diag [--reference committed|cv2]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.features import fast
from tpu_vo_torch.features.orb import detect_and_compute, features_per_level
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.matching.hamming import mutual_nearest_match
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.tools import diag_common, profile_rows, reference_band
from tpu_vo_torch.utils import synthetic

DEFAULTS = dict(fc=8, reference="committed",
                lo_width=640, lo_height=480, lo_features=1000, lo_T=96, lo_pc=95,
                hi_width=1241, hi_height=376, hi_features=2000, hi_T=64, hi_pc=9)
KERNELS = ("select_maps", "extract_patches", "fast_margin")


def kp_sets_cv2(img, n, levels=8):
    """cv2's ORB keypoints of img as a set of (round(4x), round(4y), octave)."""
    return reference_band.cv2_keypoints(img, n, levels)


def kp_sets_ours(img, cfg: ORBConfig, device="cpu"):
    """(set of (round(4x), round(4y), octave), features) of one frame."""
    f = detect_and_compute(torch.from_numpy(np.asarray(img))[None].to(device), cfg)
    f = type(f)(*(x[0] for x in f))
    valid = f.valid.cpu().numpy()
    xy = f.xy.cpu().numpy()
    oct_ = f.octave.cpu().numpy()
    return {(int(round(xy[j, 0] * 4)), int(round(xy[j, 1] * 4)), int(oct_[j]))
            for j in np.nonzero(valid)[0]}, f


def plateau_stats(img, cfg: ORBConfig, device="cpu"):
    """Per level with keypoints: (corners, the 2n-th score, corners at or
    above it, 2n, 4n)."""
    levels = build_pyramid(torch.from_numpy(np.asarray(img)).to(device).to(torch.float32),
                           cfg.n_levels, cfg.scale_factor)
    budgets = features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    out = []
    for lvl, n_level in zip(levels, budgets):
        if n_level <= 0:
            continue
        h, w = lvl.shape
        score, keep = fast.detect(lvl, cfg.fast_threshold)
        keep = keep & fast._border_mask(h, w, cfg.edge_threshold, lvl.device)
        s = torch.where(keep, score, torch.zeros_like(score)).cpu().numpy().ravel()
        s_sorted = np.sort(s)[::-1]
        n2 = min(2 * n_level, s.size)
        cut = s_sorted[n2 - 1]
        n_corners = int((s > 0).sum())
        plateau = int((s >= cut).sum()) if cut > 0 else n_corners
        out.append({"n_level": int(n_level), "corners": n_corners, "cut_score": float(cut),
                    "kept_keepties": plateau, "cap_2n": n2, "cap_4n": min(4 * n_level, s.size)})
    return out


def match_rate(f0, f1, subset_idx) -> float:
    """Share of f0[subset_idx] with a mutual nearest match in f1."""
    if len(subset_idx) == 0:
        return float("nan")
    m = mutual_nearest_match(f0.desc32[None], f1.desc32[None], f0.valid[None], f1.valid[None])
    return float(m.valid[0].cpu().numpy()[subset_idx].mean())


def cv2_set(img, n, how: str, W: int, H: int):
    """cv2's keypoint set of frame 0: committed (its sha256 checked) or cv2's."""
    if how == "cv2":
        return kp_sets_cv2(img, n)
    sets = reference_band.load_diagnostics()
    key = reference_band.diag_key(W, H, n)
    if key not in sets:
        raise ValueError(f"no committed keypoint set for {W}x{H}, {n} features; use "
                         f"reference='cv2' where cv2 is installed")
    rec = sets[key]
    sha = synthetic.frames_sha256([img])
    if sha != rec["frame_sha256"]:
        raise AssertionError(f"{key}: frame 0 rendered here hashes to {sha}, the committed "
                             f"set's to {rec['frame_sha256']}")
    return rec["keypoints"]


def run_resolution(rows, W, H, n_feat, T, pc, fc, how, device) -> dict:
    spec = ("corridor", T, W, H, 0)
    frames_np, _, ts, _ = diag_common.scene(*spec)
    img = frames_np[0]
    res = {"resolution": f"{W}x{H}", "n_features": n_feat}

    # A
    cv_set = cv2_set(img, n_feat, how, W, H)
    feats = {}
    for kt in (False, True):
        cfg_o = ORBConfig(n_features=n_feat, retain_best_keep_ties=kt)
        ours, feats[kt] = rows.run(lambda: kp_sets_ours(img, cfg_o, device), (1, 1, 0))
        res[f"overlap_vs_cv2_keepties_{kt}"] = len(ours & cv_set) / max(len(cv_set), 1)

    # B
    base = ORBConfig(n_features=n_feat)
    n_b3 = sum(n > 0 for n in features_per_level(n_feat, base.n_levels, base.scale_factor))
    res["plateau_per_level"] = rows.run(lambda: plateau_stats(img, base, device), (0, 0, n_b3))

    # D
    def xy_set(f):
        return {tuple(v) for v in f.xy.cpu().numpy()[f.valid.cpu().numpy()].round(2).tolist()}

    for kt, other in ((False, xy_set(feats[True])), (True, xy_set(feats[False]))):
        fset = feats[kt]
        _, f1 = rows.run(lambda: kp_sets_ours(frames_np[1], ORBConfig(
            n_features=n_feat, retain_best_keep_ties=kt), device), (1, 1, 0))
        xy = fset.xy.cpu().numpy().round(2)
        valid = np.nonzero(fset.valid.cpu().numpy())[0]
        uniq = [j for j in valid if tuple(xy[j].tolist()) not in other]
        shared = [j for j in valid if tuple(xy[j].tolist()) in other]
        res[f"match_rate_unique_to_{kt}"] = match_rate(fset, f1, np.array(uniq, int))
        res[f"match_rate_shared_{kt}"] = match_rate(fset, f1, np.array(shared, int))
        res[f"n_unique_to_{kt}"] = len(uniq)

    # C
    frames = torch.from_numpy(np.stack(frames_np)).to(device)
    calls = profile_rows.frame_launches(T, fc)
    for kt in (False, True):
        cfg = VOConfig(image_width=W, image_height=H,
                       orb=ORBConfig(n_features=n_feat, retain_best_keep_ties=kt))
        poses, _ = rows.run(lambda: runner.run_sequence_batched(
            frames, cfg, device=device, frame_chunk=fc, pair_chunk=pc or T - 1),
            (calls, calls, 0))
        res[f"ate_vs_gt_rel_keepties_{kt}"] = diag_common.ate_vs_gt_rel(
            poses.t.double().cpu().numpy(), ts)
    traj_ref, _, _ = diag_common.reference(how, diag_common.leg_for(spec), frames_np, W, H)
    res["ref_ate_vs_gt_rel"] = diag_common.ate_vs_gt_rel(traj_ref, ts)
    res["reference"] = how
    return res


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    how = diag_common.check_reference(o.reference)
    rows = profile_rows.Rows("keepties_diag", o, kernels=KERNELS)
    for p in ("lo", "hi"):
        W, H = getattr(o, f"{p}_width"), getattr(o, f"{p}_height")
        rows.add(f"{W}x{H}", run_resolution(
            rows, W, H, getattr(o, f"{p}_features"), getattr(o, f"{p}_T"), getattr(o, f"{p}_pc"),
            o.fc, how, o.device))
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
