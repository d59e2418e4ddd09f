"""The headline run split by stage (port of tools/profile_headline.py).

On bench.py's configuration (run_sequence_batched at T=64, 1241x376,
1200 keypoints, 256 hypotheses, frame_chunk 8, pair_chunk 9; frames
make_sequence(64, 1241, 376, seed=0)) it times:

  features  runner.detect_frames, fc frames a launch of B1 and B2
  pairs     runner.estimate_pairs over the T-1 pairs, pc a call
  chain     runner.chain_relative_poses
  sum       the three added
  full      the whole run_sequence_batched

and the gap between the sum and the whole, which is what the split is
for. Rows as tools/profile_rows says (CUDA events, and torch.profiler's
busy time for the pairs, the chain and the whole run).

    python -m tpu_vo_torch.tools.profile_headline [--fc 8 --pc 9 --reps 8]
"""

from __future__ import annotations

import sys

import torch

from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import pair_generators
from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(T=64, width=1241, height=376, features=1200, hyps=256, fc=8, pc=9,
                reps=8, iters=5)


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("profile_headline", o)
    T = o.T
    cfg = VOConfig(image_width=o.width, image_height=o.height,
                   orb=ORBConfig(n_features=o.features), ransac=RansacConfig(max_iters=o.hyps))
    frames = torch.from_numpy(profile_rows.sequence(T, o.width, o.height).copy()).to(o.device)
    n1 = profile_rows.frame_launches(T, o.fc)

    def feats_fn():
        return runner.detect_frames(frames, cfg, o.fc)

    feats = rows.run(feats_fn, (n1, n1))
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))

    def pairs_fn():
        return runner.estimate_pairs(prev, cur, cfg, pair_generators(0, range(1, T)), o.pc)

    est = rows.run(pairs_fn)

    def chain_fn():
        return runner.chain_relative_poses(est["R"], est["t"], est["have_rt"], est["pose_ok"],
                                           cfg)

    def full_fn():
        return runner.run_sequence_batched(frames, cfg, device=o.device, frame_chunk=o.fc,
                                           pair_chunk=o.pc)

    t = dict(reps=o.reps, iters=o.iters)
    f = rows.time("features", feats_fn, launches=(n1, n1), per=("frame", T), **t)
    p = rows.time("pairs", pairs_fn, profile=True, per=("pair", T - 1), **t)
    c = rows.time("chain", chain_fn, profile=True, **t)
    w = rows.time("full", full_fn, launches=(n1, n1), profile=True, per=("frame", T), **t)
    if rows.on_card:
        total = f["ms"] + p["ms"] + c["ms"]
        rows.add("sum", {"ms": total, "ms_per_frame": total / T})
        rows.add("gap", {"ms": w["ms"] - total, "share_of_full": (w["ms"] - total) / w["ms"],
                         "fps": 1000.0 * T / w["ms"]})
    else:
        total = f["host_ms"] + p["host_ms"] + c["host_ms"]
        rows.add("sum", {"ms": profile_rows.NOT_ON_CARD, "host_ms": total})
        rows.add("gap", {"ms": profile_rows.NOT_ON_CARD, "host_ms": w["host_ms"] - total})
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
