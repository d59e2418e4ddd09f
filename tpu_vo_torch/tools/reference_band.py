"""The OpenCV reference's trajectories and RANSAC scatter bands, rendered
and computed on the CPU and committed as data/reference_trajectories.json
(the card's host has no cv2).

    python -m tpu_vo_torch.tools.reference_band [--legs name,...] [--workers N]

needs cv2 (the reference, utils/cv_reference.ReferenceVO). Each leg
renders its scene with utils/synthetic (numpy and scipy, the frames the
port sees) and records: scene, W, H, T, seed; the sha256 of the uint8
frames; the legacy ReferenceVO trajectory (centres t and rotations R);
the band, the largest Umeyama-aligned ATE over the trajectory's extent
of ReferenceVO with ransac_state = 12345 + s, s < 5, against the legacy
trajectory (`rels` holds the five); the extent; cv2's version. A port
trajectory within the band is indistinguishable from the reference's
own sampling scatter. With --legs only those legs are recomputed and
the others kept.

The legs: the CPU tests' corridor and pan at 320x240 (T 16, seed 3);
the card's corridor at 640x480 and 1241x376 (T 24, seed 3); the
benchmark's configs 1, 2, 3, 4 (sequence 0) and 5 at their own T, W and
H, seed 0; and config 7's five dynamic scenes (640x480, T 48, seed 0;
tools/run_benchmarks). The scenes are rendered in the pool by frame
ranges (utils/synthetic.submit_render), so config 3's 4K frames spread
over the workers.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys

import numpy as np

from tpu_vo_torch.utils import synthetic
from tpu_vo_torch.utils.metrics import ate_rmse_aligned, extent

PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                    "reference_trajectories.json")
SEEDS = 5          # reference reruns that make the band
STATE0 = 12345     # their ransac_state is STATE0 + s
# name -> (scene, T, W, H, seed)
LEGS = {
    "cpu_corridor_320x240": ("corridor", 16, 320, 240, 3),
    "cpu_pan_320x240": ("pan", 16, 320, 240, 3),
    "card_corridor_640x480": ("corridor", 24, 640, 480, 3),
    "card_corridor_1241x376": ("corridor", 24, 1241, 376, 3),
    "config1": ("corridor", 96, 640, 480, 0),
    "config2": ("corridor", 64, 1241, 376, 0),
    "config4_seq0": ("corridor", 64, 640, 480, 0),
    "config5": ("corridor", 32, 640, 480, 0),
    "config3": ("corridor", 8, 3840, 2160, 0),
    **{f"config7_{k}": (f"dynamic_{k}", 48, 640, 480, 0) for k in synthetic.DYNAMIC_SCENES},
}
CPU_LEGS = ("cpu_corridor_320x240", "cpu_pan_320x240")


def ref_with_band(W: int, H: int, frames, k: int = SEEDS):
    """(legacy trajectory t (T, 3), its rotations (T, 3, 3), band, rels,
    extent): the reference's trajectory and how far it wanders when only
    its RANSAC sampling changes."""
    from tpu_vo_torch.utils.cv_reference import ReferenceVO

    ref = ReferenceVO(W, H)
    traj = ref.run(frames)
    ext = extent(traj)
    rels = [ate_rmse_aligned(ReferenceVO(W, H, ransac_state=STATE0 + s).run(frames), traj) / ext
            for s in range(k)]
    return traj, ref.rotations(), max(rels, default=0.0), rels, ext


def make_leg(name: str, frames=None) -> dict:
    """One leg's record; `frames` (the leg's rendered frames) saves the
    render where the caller has them."""
    import cv2

    scene, T, W, H, seed = LEGS[name]
    if frames is None:
        frames = synthetic.render(scene, T, W, H, seed)[0]
    traj, rots, band, rels, ext = ref_with_band(W, H, frames)
    return {"scene": scene, "W": W, "H": H, "T": T, "seed": seed,
            "frames_sha256": synthetic.frames_sha256(frames),
            "t": np.asarray(traj, np.float64).tolist(),
            "R": np.asarray(rots, np.float64).tolist(),
            "band": float(band), "rels": [float(r) for r in rels], "extent": float(ext),
            "cv2": cv2.__version__}


def load(path: str = PATH) -> dict:
    """{leg name: record} from the committed file."""
    with open(path) as f:
        return json.load(f)["legs"]


def leg_arrays(rec: dict):
    """(t (T, 3), R (T, 3, 3)) float64 arrays of a leg's reference."""
    return np.asarray(rec["t"], np.float64), np.asarray(rec["R"], np.float64)


def parity_tolerance(band: float) -> float:
    """The parity bar: 15% over the band (both the band and the port's
    worst seed are maxima of five), and never below 1% of the extent."""
    return max(1.15 * band, 0.01)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", default=",".join(LEGS), help="comma-separated leg names")
    ap.add_argument("--workers", type=int, default=2, help="processes")
    ap.add_argument("--out", default=PATH)
    args = ap.parse_args(argv)
    names = [n for n in args.legs.split(",") if n]
    unknown = set(names) - set(LEGS)
    if unknown:
        ap.error(f"unknown legs {sorted(unknown)}; known: {list(LEGS)}")
    legs = load(args.out) if os.path.exists(args.out) else {}
    with concurrent.futures.ProcessPoolExecutor(
            args.workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        renders = {n: synthetic.submit_render(pool, *LEGS[n]) for n in names}
        made = [pool.submit(make_leg, n, synthetic.join_ranges([f.result() for f in renders[n]])[0])
                for n in names]
        for name, fut in zip(names, made):
            rec = legs[name] = fut.result()
            print(f"{name}: band {rec['band']:.6f}, extent {rec['extent']:.4f}, "
                  f"sha256 {rec['frames_sha256'][:16]}", flush=True)
    legs = {n: legs[n] for n in LEGS if n in legs}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"legs": legs}, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
