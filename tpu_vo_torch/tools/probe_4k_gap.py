"""Config 3's run split by stage (port of tools/probe_4k_gap.py).

Config 3's program: run_sequence_batched on 8 frames of 3840x2160
(numpy.random.default_rng(0) uint8: the shapes set the cost), 8000
keypoints, the ratio test, frame_chunk 2, pair_chunk 7. It times:

  frontend_ms_per_frame  runner.detect_frames at fc (B1 and B2 once a chunk)
  pairs_ms_per_pair      runner.estimate_pairs over the T-1 pairs at pc
  chain_ms               runner.chain_relative_poses
  whole_ms_per_frame     the whole run_sequence_batched
  stagesum_ms_per_frame  the three stages added, per frame

Rows as tools/profile_rows says (torch.profiler's busy time beside the
pairs, the chain and the whole run).

    python -m tpu_vo_torch.tools.probe_4k_gap [--reps 8 --iters 3]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import MatchConfig, ORBConfig, VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import pair_generators
from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(T=8, width=3840, height=2160, features=8000, fc=2, pc=7, reps=8, chain_reps=32,
                iters=3)


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("probe_4k_gap", o)
    T = o.T
    cfg = VOConfig(image_width=o.width, image_height=o.height,
                   orb=ORBConfig(n_features=o.features), match=MatchConfig(use_ratio_test=True))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 255, (T, o.height, o.width),
                                           dtype=np.uint8)).to(o.device)
    n1 = profile_rows.frame_launches(T, o.fc)

    def frontend():
        return runner.detect_frames(frames, cfg, o.fc)

    feats = rows.run(frontend, (n1, n1))
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))

    def pairs():
        return runner.estimate_pairs(prev, cur, cfg, pair_generators(0, range(1, T)), o.pc)

    est = rows.run(pairs)

    def chain():
        return runner.chain_relative_poses(est["R"], est["t"], est["have_rt"], est["pose_ok"],
                                           cfg)

    def whole():
        return runner.run_sequence_batched(frames, cfg, device=o.device, frame_chunk=o.fc,
                                           pair_chunk=o.pc)

    t = dict(reps=o.reps, iters=o.iters)
    f = rows.time("frontend", frontend, launches=(n1, n1), per=("frame", T), **t)
    p = rows.time("pairs", pairs, profile=True, per=("pair", T - 1), **t)
    c = rows.time("chain", chain, profile=True, reps=o.chain_reps, iters=o.iters)
    w = rows.time("whole", whole, launches=(n1, n1), profile=True, per=("frame", T), **t)
    key = "ms" if rows.on_card else "host_ms"
    res = {"frontend_ms_per_frame": f[key] / T, "pairs_ms_per_pair": p[key] / (T - 1),
           "chain_ms": c[key], "whole_ms_per_frame": w[key] / T}
    res["stagesum_ms_per_frame"] = (res["frontend_ms_per_frame"]
                                    + res["pairs_ms_per_pair"] * (T - 1) / T
                                    + res["chain_ms"] / T)
    rows.add("per_frame", {k if rows.on_card else "host_" + k: v for k, v in res.items()})
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
