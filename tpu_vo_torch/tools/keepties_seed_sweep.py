"""The keep-ties stage-1 cut under several RANSAC seeds: a systematic
effect or draw noise (port of tools/keepties_seed_sweep.py).

Both ORBConfig.retain_best_keep_ties modes, each under seeds 0-4 of the
batched runner (run_sequence_batched, frame_chunk 8), on the corridor
(seed 0) at 1241x376 with 2000 keypoints (64 frames, pair_chunk 9) and at
640x480 with 1000 (96 frames, pair_chunk 95). Disjoint ATE bands of the
two modes mean a systematic effect; overlapping bands, a scene that
moves with any change to its keypoint set. Rows, one a resolution: per
mode the ATE against ground truth over its extent (diag_common.
ate_vs_gt_rel, trajectory_report's ate_vs_gt_rel unrounded) per seed, and
its min, max and median.

    python -m tpu_vo_torch.tools.keepties_seed_sweep
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.tools import diag_common, profile_rows

DEFAULTS = dict(seeds=(0, 1, 2, 3, 4), fc=8,
                hi_width=1241, hi_height=376, hi_features=2000, hi_T=64, hi_pc=9,
                lo_width=640, lo_height=480, lo_features=1000, lo_T=96, lo_pc=95)


def run_resolution(rows, W, H, n_feat, T, pc, seeds, fc, device) -> dict:
    frames_np, _, ts, _ = diag_common.scene("corridor", T, W, H, 0)
    frames = torch.from_numpy(np.stack(frames_np)).to(device)
    calls = profile_rows.frame_launches(T, fc)
    res = {"resolution": f"{W}x{H}", "n_features": n_feat, "T": T, "seeds": list(seeds)}
    for kt in (False, True):
        cfg = VOConfig(image_width=W, image_height=H,
                       orb=ORBConfig(n_features=n_feat, retain_best_keep_ties=kt))
        ates = []
        for s in seeds:
            poses, _ = rows.run(lambda: runner.run_sequence_batched(
                frames, cfg, seed=s, device=device, frame_chunk=fc, pair_chunk=pc or T - 1),
                (calls, calls))
            ates.append(diag_common.ate_vs_gt_rel(poses.t.double().cpu().numpy(), ts))
        res[f"ate_band_keepties_{kt}"] = {"per_seed": ates, "min": min(ates), "max": max(ates),
                                          "median": float(np.median(ates))}
    return res


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("keepties_seed_sweep", o)
    for p in ("hi", "lo"):
        W, H = getattr(o, f"{p}_width"), getattr(o, f"{p}_height")
        rows.add(f"{W}x{H}", run_resolution(
            rows, W, H, getattr(o, f"{p}_features"), getattr(o, f"{p}_T"),
            getattr(o, f"{p}_pc"), o.seeds, o.fc, o.device))
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
