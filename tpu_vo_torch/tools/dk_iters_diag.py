"""The 5-point solver's root budgets against its baseline (port of
tools/dk_iters_diag.py).

Real samples: make_sequence(16, 1241, 376, seed 0), ORB with 1200
keypoints (stage 1 in chunks of 8 frames), each of the 15 pairs matched
and filtered as estimate_pair does (in chunks of 5 pairs), and 256
five-point samples a pair drawn as RANSAC draws them (pair i from
pipeline/step.pair_generators(0, [i])): 3,840 samples. On them,
estimation/five_point.five_point_candidates_batched at the baseline,
Durand-Kerner with 100 iterations, and at each trial budget (DK 60, 40;
Aberth 40, 30, 24, 16, 12). Slots come out in an order that depends on
the iteration, so candidate SETS are compared per sample: a baseline
candidate is lost when no valid trial slot matches it (up to sign, every
entry within 1e-2), a trial candidate is spurious when no valid
baseline slot matches it.

Rows: `baseline_dk100` (valid slots, their share of all slots, ms) and `dk_<it>`,
`aberth_<it>` (valid, lost, lost over the baseline's valid, spurious,
ms); ms is the CUDA-event time of one call on all samples (reps x
iters), as tools/profile_rows says.

    python -m tpu_vo_torch.tools.dk_iters_diag [--reps 16 --iters 5]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.estimation.five_point import five_point_candidates_batched
from tpu_vo_torch.estimation.ransac import _take, draw_samples
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry.camera import intrinsics_from_image_size
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import pair_generators
from tpu_vo_torch.tools import diag_common, profile_pairs, profile_rows

DEFAULTS = dict(width=1241, height=376, T=16, features=1200, hyps=256, fc=8, pc=5, reps=16,
                iters=5)
BASELINE = 100                                      # DK iterations of the baseline
TRIALS = (("dk", (60, 40)), ("aberth", (40, 30, 24, 16, 12)))
TOL = 1e-2  # max entry difference of two matching candidates


def samples(frames: torch.Tensor, cfg: VOConfig, hyps: int, fc, pc, seed: int = 0):
    """(s1, s2) (S, 5, 2): `hyps` five-point samples a pair of the
    frames' consecutive pairs, matched and drawn as the pipeline does."""
    feats = runner.detect_frames(frames, cfg, fc)
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    K = intrinsics_from_image_size(cfg.image_width, cfg.image_height, device=frames.device)
    parts = []
    for a, e in runner._spans(prev.xy.shape[0], pc):
        p = ORBFeatures(*(f[a:e] for f in prev))
        c = ORBFeatures(*(f[a:e] for f in cur))
        good, _ = profile_pairs.match_stage(p, c, cfg)
        parts.append(profile_pairs.prep_stage(p, c, good, K)[2:])
    x1n, x2n, mask = (torch.cat(x) for x in zip(*parts))
    idx = draw_samples(pair_generators(seed, range(1, frames.shape[0])), mask, hyps, 5)
    return _take(x1n, idx).reshape(-1, 5, 2), _take(x2n, idx).reshape(-1, 5, 2)


def set_match(Es, v, Es_ref, v_ref, tol: float = TOL):
    """(lost, spurious) of candidate sets Es (S, 10, 3, 3), valid v (S, 10)
    against the baseline's (numpy)."""
    S = Es.shape[0]
    a = Es.reshape(S, 10, 1, 9)
    b = Es_ref.reshape(S, 1, 10, 9)
    d = np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))   # (S, trial, ref)
    pair_ok = d < tol
    ref_found = (pair_ok & v[:, :, None]).any(1)
    new_found = (pair_ok & v_ref[:, None, :]).any(2)
    return int((v_ref & ~ref_found).sum()), int((v & ~new_found).sum())


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("dk_iters_diag", o)
    cfg = VOConfig(image_width=o.width, image_height=o.height,
                   orb=ORBConfig(n_features=o.features))
    frames = torch.from_numpy(np.stack(diag_common.scene("planes", o.T, o.width, o.height, 0)[0]))
    n_calls = profile_rows.frame_launches(o.T, o.fc)
    s1, s2 = rows.run(lambda: samples(frames.to(o.device), cfg, o.hyps, o.fc, o.pc),
                      (n_calls, n_calls))
    t = dict(reps=o.reps, iters=o.iters)

    def run(it, method):
        return lambda: five_point_candidates_batched(s1, s2, dk_iters=it, root_method=method)

    Es_ref, v_ref = (x.cpu().numpy() for x in run(BASELINE, "dk")())
    n_ref = int(v_ref.sum())
    rows.time(f"baseline_dk{BASELINE}", run(BASELINE, "dk"), **t, samples=int(s1.shape[0]),
              valid=n_ref, valid_per_slot=float(v_ref.mean()))
    for method, its in TRIALS:
        for it in its:
            Es, v = (x.cpu().numpy() for x in run(it, method)())
            lost, spurious = set_match(Es, v, Es_ref, v_ref)
            rows.time(f"{method}_{it}", run(it, method), **t, valid=int(v.sum()), lost=lost,
                      lost_frac=lost / max(n_ref, 1), spurious=spurious)
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
