"""Config 4's batching on one card by tiling variant (port of
tools/profile_batch8.py).

Config 4 at 640x480 with 1000 keypoints, on numpy.random.default_rng(0)
uint8 frames (drawn in the JAX tool's order: one 96-frame sequence, then
8 x 16 and 8 x 64 sequences; the shapes set the cost), through
run_sequence_batched (one sequence) and parallel/sharding.
run_batch_of_sequences(mesh=None) (the B sequences flattened on one
card). Its variants, under the JAX tool's names (`vmap8_`: the JAX runner
vmapped the 8 sequences; the port flattens them):

  single_T96_fc8_pc95   one 96-frame sequence, config 1's tiling
  single_T96_fc8_pc5    the same, 5 pairs a call
  vmap8_T16_fc8_pc15    8 x 16 frames, fc 8, pc 15
  vmap8_T16_fc1_pc1     8 x 16 frames, one frame and one pair a call
  vmap8_T16_fc2_pc3     8 x 16 frames, fc 2, pc 3
  vmap8_T64_fc8_pc9     8 x 64 frames, fc 8, pc 9
  vmap8_T64_fc1_pc1     8 x 64 frames, one frame and one pair a call

each with frames/s and torch.profiler's busy time (tools/profile_rows).
`variants` picks some of them by name.

    python -m tpu_vo_torch.tools.profile_batch8 [--reps 1 --iters 3]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.parallel.sharding import run_batch_of_sequences
from tpu_vo_torch.pipeline.runner import run_sequence_batched
from tpu_vo_torch.tools import profile_rows

# name: (B sequences, or 0 for one sequence through run_sequence_batched;
# T, frame_chunk, pair_chunk)
VARIANTS = {
    "single_T96_fc8_pc95": (0, 96, 8, 95),
    "single_T96_fc8_pc5": (0, 96, 8, 5),
    "vmap8_T16_fc8_pc15": (8, 16, 8, 15),
    "vmap8_T16_fc1_pc1": (8, 16, 1, 1),
    "vmap8_T16_fc2_pc3": (8, 16, 2, 3),
    "vmap8_T64_fc8_pc9": (8, 64, 8, 9),
    "vmap8_T64_fc1_pc1": (8, 64, 1, 1),
}
DEFAULTS = dict(width=640, height=480, features=1000, hyps=256, variants=tuple(VARIANTS),
                reps=1, iters=3)


def frames_of(width: int, height: int, device):
    """{(B, T): frames} in the JAX tool's draw order; B 0 is one (T, H, W)
    sequence, else (B, T, H, W)."""
    rng = np.random.default_rng(0)
    out = {}
    for B, T in ((0, 96), (8, 16), (8, 64)):
        shape = (T, height, width) if B == 0 else (B, T, height, width)
        out[(B, T)] = torch.from_numpy(rng.integers(0, 255, size=shape, dtype=np.uint8)).to(device)
    return out


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("profile_batch8", o)
    unknown = set(o.variants) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}")
    cfg = VOConfig(image_width=o.width, image_height=o.height, orb=ORBConfig(n_features=o.features),
                   ransac=RansacConfig(max_iters=o.hyps))
    frames = frames_of(o.width, o.height, o.device)
    for name in o.variants:
        B, T, fc, pc = VARIANTS[name]
        f = frames[(B, T)]
        n = T * max(B, 1)
        launches = profile_rows.frame_launches(n, fc)
        if B == 0:
            def fn(f=f, fc=fc, pc=pc):
                return run_sequence_batched(f, cfg, device=o.device, frame_chunk=fc, pair_chunk=pc)
        else:
            def fn(f=f, fc=fc, pc=pc):
                return run_batch_of_sequences(f, cfg, frame_chunk=fc, pair_chunk=pc,
                                              device=o.device)
        row = rows.time(name, fn, reps=o.reps, iters=o.iters, launches=(launches, launches),
                        profile=True, frames=n, frame_chunk=fc, pair_chunk=pc)
        if rows.on_card:
            row["fps"] = n / row["ms"] * 1e3
            rows.add(name, row)
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
