"""Config 4's flattened batch by tiling (port of tools/profile_batch8_flat.py).

Config 4: B = 8 sequences of T = 64 frames at 640x480 with 1000
keypoints, on numpy.random.default_rng(0) uint8 frames (the shapes set
the cost), through parallel/sharding.run_batch_of_sequences(mesh=None):
the 8 sequences flattened on one card, so frame_chunk and pair_chunk are
the true per-call batch sizes. The sweep: pc in (9, 56, 84, 126, 252) at
fc 8, then fc in (16, 32) at pc 84; rows `flat_B8_T64_fc{fc}_pc{pc}`
with frames/s and torch.profiler's busy time (tools/profile_rows).

Memory, reckoned first: one MSAC score tensor of a 252-pair call is 252
pairs x 256 hypotheses x 1000 keypoints x 4 B = 258 MB, which fits on an
80 GB card; a variant that does not fit raises torch's out-of-memory
error naming the row, and stops the tool.

    python -m tpu_vo_torch.tools.profile_batch8_flat [--reps 1 --iters 3]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.parallel.sharding import run_batch_of_sequences
from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(B=8, T=64, width=640, height=480, features=1000, hyps=256,
                pcs=(9, 56, 84, 126, 252),
                fc=8, fcs=(16, 32), fc_pc=84, reps=1, iters=3)


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("profile_batch8_flat", o)
    cfg = VOConfig(image_width=o.width, image_height=o.height, orb=ORBConfig(n_features=o.features),
                   ransac=RansacConfig(max_iters=o.hyps))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 255, size=(o.B, o.T, o.height, o.width),
                                           dtype=np.uint8)).to(o.device)
    n = o.B * o.T
    for fc, pc in [(o.fc, pc) for pc in o.pcs] + [(fc, o.fc_pc) for fc in o.fcs]:
        name = f"flat_B{o.B}_T{o.T}_fc{fc}_pc{pc}"
        launches = profile_rows.frame_launches(n, fc)

        def fn(fc=fc, pc=pc):
            return run_batch_of_sequences(frames, cfg, frame_chunk=fc, pair_chunk=pc,
                                          device=o.device)
        try:
            row = rows.time(name, fn, reps=o.reps, iters=o.iters, launches=(launches, launches),
                            profile=True, frames=n, frame_chunk=fc, pair_chunk=pc)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(f"profile_batch8_flat: {name} does not fit on the card") from e
        if rows.on_card:
            row["fps"] = n / row["ms"] * 1e3
            rows.add(name, row)
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
