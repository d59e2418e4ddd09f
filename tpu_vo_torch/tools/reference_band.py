"""The OpenCV reference's trajectories and RANSAC scatter bands, rendered
and computed on the CPU and committed as data/reference_trajectories.json
(the card's host has no cv2).

    python -m tpu_vo_torch.tools.reference_band [--legs name,...] [--workers N]
                                                [--diagnostics]

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
H, seed 0; config 6's corridor (640x480, T 48) and pan (320x240, T 32),
seed 0, each at the four nuisance levels (utils/synthetic.nuisance_level,
seed 17; the record's `nuisance` names the level, and its frames and
sha256 are the degraded ones); and config 7's five dynamic scenes
(640x480, T 48, seed 0; tools/run_benchmarks); and the accuracy
diagnostics' own legs (`diag_*`): the parity matrix's pan and corridor at
320x240 (T 48, seed 0), the pan ablation's four single nuisances at the
harsh level's amplitudes (pan 320x240, T 32, seed 0, nuisance seed 17;
`nuisance` is `only_<name>`), and diagnose_ate's planes (make_sequence's
scene) at 640x480, T 30, seed 0. The scenes are rendered
in the pool by frame ranges (utils/synthetic.submit_render), each scene
once for all the legs that share it, so config 3's 4K frames spread over
the workers.

--diagnostics also writes data/diagnostic_reference.json: cv2's ORB
keypoint sets of frame 0 of the corridor (seed 0) at 640x480 with 1000
features (config 1's T 96) and at 1241x376 with 2000 (config 2's T 64),
as tools/keepties_diag's part A compares them, each keypoint as
(round(4x), round(4y), octave), with frame 0's sha256 and cv2's version.

    python -m tpu_vo_torch.tools.reference_band --speed [--workers N]

times the reference instead (no leg is recomputed) and writes
data/reference_speed.json, the baseline of tools/bench's vs_baseline and
of tools/run_benchmarks' reference-speed fields. Its entries: `bench`,
bench.py:47-58 (ReferenceVO(W, H) built outside the timed window, then
run over the first min(T, 32) frames of make_sequence(64, 1241, 376,
seed=0), 5 times; cpu_baseline_fps the median); `config1` and `config3`,
the legs' frames timed as benchmarks/run_benchmarks.py:100-103 times
them (the construction and the legacy run in the window), 3 times, fps
the median. Each entry holds its samples, T, W, H, seed, the sha256 of
the timed frames, the host (CPU model, CPU count, cv2's version and
threads, the platform) and the date. The scenes are rendered in the pool
first; the timings run one at a time in this process, after the pool has
ended.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import datetime
import json
import multiprocessing
import os
import platform
import statistics
import sys
import time

import numpy as np

from tpu_vo_torch.utils import synthetic
from tpu_vo_torch.utils.metrics import ate_rmse_aligned, extent

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
PATH = os.path.join(DATA, "reference_trajectories.json")
DIAG_PATH = os.path.join(DATA, "diagnostic_reference.json")
SPEED_PATH = os.path.join(DATA, "reference_speed.json")
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
    **{f"config6_{scene}_{level}": spec for scene, spec in (
        ("corridor", ("corridor", 48, 640, 480, 0)), ("pan", ("pan", 32, 320, 240, 0)))
       for level in synthetic.NUISANCE_LEVELS},
    "diag_pan_320x240": ("pan", 48, 320, 240, 0),
    "diag_corridor_320x240": ("corridor", 48, 320, 240, 0),
    **{f"diag_pan_only_{n}": ("pan", 32, 320, 240, 0) for n in synthetic.NUISANCES},
    "diag_planes_640x480": ("planes", 30, 640, 480, 0),
}
# keepties_diag's part A: (W, H, n_features, the corridor's T) of each
# keypoint set in the diagnostics file
DIAG_KEYPOINTS = ((640, 480, 1000, 96), (1241, 376, 2000, 64))

CPU_LEGS = ("cpu_corridor_320x240", "cpu_pan_320x240")

# The reference's speed: bench.py's baseline (its make_sequence scene,
# T W H seed; the first BENCH_TIMED frames timed BENCH_SAMPLES times) and
# the legs whose speed tools/run_benchmarks reports, each timed LEG_SAMPLES
# times (the JAX harness times one run; the median damps a shared host)
BENCH = ("planes", 64, 1241, 376, 0)
BENCH_TIMED, BENCH_SAMPLES = 32, 5
SPEED_LEGS, LEG_SAMPLES = ("config1", "config3"), 3


def nuisance(name: str):
    """The nuisance level of a config 6 leg (its name's last part), else None."""
    return name.rsplit("_", 1)[1] if name.startswith("config6_") else None


def degradation(name: str):
    """(label, apply_photometric_nuisances keywords) of a leg's degraded
    frames: a config 6 level, or `only_<name>`, one nuisance at the harsh
    level's amplitudes; (None, None) for a clean leg."""
    if name.startswith("diag_pan_only_"):
        only = name[len("diag_pan_only_"):]
        return f"only_{only}", dict(synthetic.NUISANCE_LEVELS["harsh"], which=(only,))
    level = nuisance(name)
    if level is None:
        return None, None
    return level, synthetic.NUISANCE_LEVELS[level]


def leg_frames(name: str, frames):
    """A leg's frames from its scene's clean frames (degraded where the
    leg is, with synthetic.NUISANCE_SEED)."""
    _, kwargs = degradation(name)
    if kwargs is None:
        return list(frames)
    return synthetic.apply_photometric_nuisances(frames, seed=synthetic.NUISANCE_SEED, **kwargs)


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
    level, _ = degradation(name)
    frames = leg_frames(name, frames)
    traj, rots, band, rels, ext = ref_with_band(W, H, frames)
    return {"scene": scene, "W": W, "H": H, "T": T, "seed": seed,
            **({"nuisance": level, "nuisance_seed": synthetic.NUISANCE_SEED}
               if level is not None else {}),
            "frames_sha256": synthetic.frames_sha256(frames),
            "t": np.asarray(traj, np.float64).tolist(),
            "R": np.asarray(rots, np.float64).tolist(),
            "band": float(band), "rels": [float(r) for r in rels], "extent": float(ext),
            "cv2": cv2.__version__}


def cv2_keypoints(img, n: int, levels: int = 8):
    """cv2's ORB keypoints of one frame (the reference's detector at n
    features), as a set of (round(4x), round(4y), octave)."""
    import cv2

    orb = cv2.ORB_create(n, 1.2, levels, 31, 0, 2, cv2.ORB_HARRIS_SCORE, 31, 10)
    return {(int(round(k.pt[0] * 4)), int(round(k.pt[1] * 4)), k.octave)
            for k in orb.detect(img, None)}


def diag_key(W: int, H: int, n: int) -> str:
    return f"corridor_{W}x{H}_n{n}"


def make_diagnostics(frames0) -> dict:
    """The diagnostics file's object from frame 0 of each DIAG_KEYPOINTS
    corridor ({(W, H): frame})."""
    import cv2

    sets = {}
    for W, H, n, T in DIAG_KEYPOINTS:
        img = frames0[(W, H)]
        sets[diag_key(W, H, n)] = {
            "scene": "corridor", "W": W, "H": H, "T": T, "seed": 0, "frame": 0,
            "n_features": n, "frame_sha256": synthetic.frames_sha256([img]),
            "keypoints": sorted(cv2_keypoints(img, n))}
    return {"cv2": cv2.__version__, "keypoint_sets": sets}


def load_diagnostics(path: str = DIAG_PATH) -> dict:
    """{key: record} of the committed keypoint sets (diag_key names them);
    each record's keypoints as a set of tuples."""
    with open(path) as f:
        sets = json.load(f)["keypoint_sets"]
    return {k: dict(v, keypoints={tuple(p) for p in v["keypoints"]}) for k, v in sets.items()}


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


def host() -> dict:
    """The host a timing ran on: CPU model, CPU count, cv2's version and
    threads, the platform."""
    import cv2

    model = "unknown"
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), model)
    return {"cpu": model, "cpu_count": os.cpu_count(), "cv2": cv2.__version__,
            "cv2_threads": cv2.getNumThreads(), "platform": platform.platform()}


def bench_baseline(frames, W: int, H: int, samples: int = BENCH_SAMPLES):
    """(median, samples) of bench.py's baseline in frames/s: ReferenceVO(W,
    H) built outside the window, then run over the first min(T, 32) frames
    (bench.py:47-58)."""
    from tpu_vo_torch.utils.cv_reference import ReferenceVO

    n = min(len(frames), BENCH_TIMED)
    fps = []
    for _ in range(samples):
        ref = ReferenceVO(W, H)
        t0 = time.perf_counter()
        ref.run(frames[:n])
        fps.append(n / (time.perf_counter() - t0))
    return statistics.median(fps), fps


def leg_speed(frames, W: int, H: int, samples: int = LEG_SAMPLES):
    """(median, samples) of the reference's frames/s on a leg, timed as
    ref_with_band's legacy run is in benchmarks/run_benchmarks.py:100-103:
    the construction and the run in the window."""
    from tpu_vo_torch.utils.cv_reference import ReferenceVO

    fps = []
    for _ in range(samples):
        t0 = time.perf_counter()
        ReferenceVO(W, H).run(frames)
        fps.append(len(frames) / (time.perf_counter() - t0))
    return statistics.median(fps), fps


def speed_entry(T: int, W: int, H: int, seed: int, frames, timed: dict) -> dict:
    """One entry of the speed file: sizes, the timed frames' sha256, the
    timing (`timed`), the host and the date."""
    return {"T": T, "W": W, "H": H, "seed": seed,
            "frames_sha256": synthetic.frames_sha256(frames), **timed, "host": host(),
            "date": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds")}


def make_speed(scenes: dict) -> dict:
    """The speed file's object from the rendered frames ({"bench": frames,
    leg name: frames}); one timing at a time, in this process."""
    scene, T, W, H, seed = BENCH
    frames = scenes["bench"]
    fps, samples = bench_baseline(frames, W, H)
    out = {"bench": speed_entry(T, W, H, seed, frames[:BENCH_TIMED], {
        "scene": scene, "timed_frames": min(T, BENCH_TIMED), "cpu_baseline_fps": fps,
        "samples_fps": samples})}
    for name in SPEED_LEGS:
        scene, T, W, H, seed = LEGS[name]
        fps, samples = leg_speed(scenes[name], W, H)
        out[name] = speed_entry(T, W, H, seed, scenes[name], {
            "scene": scene, "fps": fps, "samples_fps": samples})
    return {"entries": out}


def load_speed() -> dict:
    """{entry name: record} of the committed reference speeds."""
    with open(SPEED_PATH) as f:
        return json.load(f)["entries"]


def committed_fps(name: str, frames):
    """The committed reference frames/s of leg `name` (an entry of the
    speed file) where `frames` are the ones it timed, else None."""
    rec = load_speed().get(name)
    if rec is None or rec["frames_sha256"] != synthetic.frames_sha256(frames):
        return None
    return rec["fps"]


def speed_main(workers: int, out: str) -> int:
    """--speed: render the scenes in the pool, then time each in turn here."""
    specs = {"bench": BENCH, **{n: LEGS[n] for n in SPEED_LEGS}}
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: synthetic.submit_render(pool, *spec) for k, spec in specs.items()}
        scenes = {k: synthetic.join_ranges([f.result() for f in fs])[0]
                  for k, fs in futures.items()}
    for name in SPEED_LEGS:
        want = load(PATH)[name]["frames_sha256"]
        if synthetic.frames_sha256(scenes[name]) != want:
            raise ValueError(f"{name}: the rendered frames are not the committed leg's")
    obj = make_speed(scenes)
    for name, rec in obj["entries"].items():
        fps = rec.get("cpu_baseline_fps", rec.get("fps"))
        print(f"{name}: {fps:.3f} frames/s (samples {[round(x, 3) for x in rec['samples_fps']]}),"
              f" sha256 {rec['frames_sha256'][:16]}", flush=True)
    with open(out, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    print(f"wrote {out} ({os.path.getsize(out)} bytes) on {obj['entries']['bench']['host']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", default=",".join(LEGS), help="comma-separated leg names")
    ap.add_argument("--workers", type=int, default=2, help="processes")
    ap.add_argument("--out", default=PATH)
    ap.add_argument("--diagnostics", action="store_true",
                    help=f"also write {os.path.relpath(DIAG_PATH)} (cv2's keypoint sets)")
    ap.add_argument("--diagnostics-out", default=DIAG_PATH)
    ap.add_argument("--speed", action="store_true",
                    help=f"time the reference into {os.path.relpath(SPEED_PATH)} instead")
    ap.add_argument("--speed-out", default=SPEED_PATH)
    args = ap.parse_args(argv)
    if args.speed:
        return speed_main(args.workers, args.speed_out)
    names = [n for n in args.legs.split(",") if n]
    unknown = set(names) - set(LEGS)
    if unknown:
        ap.error(f"unknown legs {sorted(unknown)}; known: {list(LEGS)}")
    legs = load(args.out) if os.path.exists(args.out) else {}
    with concurrent.futures.ProcessPoolExecutor(
            args.workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        renders = {spec: synthetic.submit_render(pool, *spec) for spec in {LEGS[n] for n in names}}
        firsts = {(W, H): pool.submit(synthetic.render_range, "corridor", T, W, H, 0, 0, 1)
                  for W, H, _, T in DIAG_KEYPOINTS} if args.diagnostics else {}
        made = [pool.submit(make_leg, n,
                            synthetic.join_ranges([f.result() for f in renders[LEGS[n]]])[0])
                for n in names]
        for name, fut in zip(names, made):
            rec = legs[name] = fut.result()
            print(f"{name}: band {rec['band']:.6f}, extent {rec['extent']:.4f}, "
                  f"sha256 {rec['frames_sha256'][:16]}", flush=True)
        if firsts:
            diag = make_diagnostics({k: f.result()[0][0] for k, f in firsts.items()})
            with open(args.diagnostics_out, "w") as f:
                json.dump(diag, f, separators=(",", ":"))
                f.write("\n")
            print(f"wrote {args.diagnostics_out} ({os.path.getsize(args.diagnostics_out)} bytes)")
    legs = {n: legs[n] for n in LEGS if n in legs}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"legs": legs}, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
