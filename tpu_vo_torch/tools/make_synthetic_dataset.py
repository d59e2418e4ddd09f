"""Generate a synthetic VO dataset (PNG frames + ground-truth poses) (port
of tools/make_synthetic_dataset.py, numpy-rendered).

Usage: python -m tpu_vo_torch.tools.make_synthetic_dataset OUT_DIR
       [--frames N] [--width W] [--height H] [--seed S]
       [--scene corridor|planes]

Writes zero-padded PNGs (the reference's dataset layout) through
utils/synthetic.write_dataset and io/dataset.write_png, a TUM-format
ground-truth trajectory (groundtruth_tum.txt), and K.txt with the
rendering intrinsics.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.io.trajectory_io import save_trajectory_tum
from tpu_vo_torch.utils.synthetic import make_corridor_sequence, make_sequence, write_dataset


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene", choices=["corridor", "planes"],
                   default="corridor",
                   help="corridor = well-conditioned forward motion "
                        "(strong parallax; the accuracy benchmark scene); "
                        "planes = the legacy weak-parallax two-plane scene")
    args = p.parse_args(argv)

    gen = make_corridor_sequence if args.scene == "corridor" else make_sequence
    frames, Rs, ts, K = gen(
        n_frames=args.frames, width=args.width, height=args.height,
        seed=args.seed,
    )
    write_dataset(args.out_dir, frames)
    poses = Pose(torch.from_numpy(np.stack(Rs)), torch.from_numpy(np.stack(ts)))
    save_trajectory_tum(os.path.join(args.out_dir, "groundtruth_tum.txt"),
                        poses)
    np.savetxt(os.path.join(args.out_dir, "K.txt"), K)
    print(f"wrote {args.frames} frames ({args.width}x{args.height}) + "
          f"groundtruth to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
