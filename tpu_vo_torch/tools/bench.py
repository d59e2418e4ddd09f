"""VO frames/sec/chip on a KITTI-style sequence (port of bench.py).

    python -m tpu_vo_torch.tools.bench [--reference committed|live] [--device cpu]
        [--T 64 --repeats 8 --fc 8 --pc 9 --width 1241 --height 376
         --features 1200 --hyps 256]

Prints ONE JSON line on stdout, bench.py's (:127-136): metric, value,
unit, vs_baseline, cpu_baseline_fps and, where measured, e2e_decode_fps.
Everything else goes to stderr.

It times bench.py's configuration of the main path:
run_sequence_batched(frames, cfg, frame_chunk=fc, pair_chunk=pc) on
make_sequence(T, 1241, 376, seed=0) already on the device, with 1200
keypoints and 256 hypotheses (bench.py:41-45, :61-69). A window is
`repeats` back-to-back calls; after 2 warm-up windows, value = repeats *
T / the median of 3 windows (bench.py:102-111), by CUDA events on the
card (one before the first call, one after the last call's poses), by
the host clock on the CPU. T, repeats, fc and pc default to BENCH_FRAMES
(64), BENCH_REPEATS (8), BENCH_FRAME_CHUNK (8) and BENCH_PAIR_CHUNK (9)
from the environment, as bench.py reads them, and can be given as sizes.

vs_baseline = value / cpu_baseline_fps, the OpenCV reference's frames/s
over the first min(T, 32) frames (median of 5 runs, bench.py:47-58):

  committed  (default) the `bench` entry of data/reference_speed.json,
             measured on a CPU host with cv2 (tools/reference_band
             --speed); it raises where T, W or H differ from the entry's
             or the timed frames' sha256 does not match. On the card it
             compares the card with that other host's CPU.
  live       utils/cv_reference.ReferenceVO on this host's CPU; it raises
             without cv2 (the card's host has none).

A stderr line names the baseline's source and its host, and on the card
the card's name and power limit. e2e_decode_fps is bench.py's IO leg
(:113-124, :140-191; tools/io_bench.e2e_decode_fps over the frames
written as PNG by io/dataset.write_png); it is omitted where the native
loader's build failed, saying why on stderr, and omitted with a warning
where the leg raises.

main(argv=None, device=None, **sizes) returns the line's dict; last_run()
returns the last timed call's poses and diagnostics, and the B1 and B2
launches that main's calls imply. device None is the card
(pipeline/runner.entry_device), which raises without one.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.io import native_loader
from tpu_vo_torch.io.dataset import write_png
from tpu_vo_torch.pipeline.runner import run_sequence_batched
from tpu_vo_torch.tools import io_bench, profile_rows, reference_band
from tpu_vo_torch.utils import profiling, synthetic

METRIC = "VO frames/sec/chip (1241x376, 1200 kps, 5pt RANSAC)"
UNIT = "frames/sec/chip"
WARMUP_WINDOWS, WINDOWS = 2, 3   # bench.py:102-111
REFERENCES = ("committed", "live")

_LAST: dict = {}
_SCENES: dict = {}   # (T, W, H) -> scene()


def defaults() -> dict:
    """bench.py's sizes, with its four environment knobs read now."""
    env = os.environ.get
    return dict(T=int(env("BENCH_FRAMES", "64")), width=1241, height=376, features=1200,
                hyps=256, repeats=int(env("BENCH_REPEATS", "8")),
                fc=int(env("BENCH_FRAME_CHUNK", "8")), pc=int(env("BENCH_PAIR_CHUNK", "9")),
                reference="committed")


def scene(T: int, W: int, H: int):
    """(frames (T, H, W) uint8 read-only, ground-truth rotations) of
    make_sequence(T, W, H, seed=0), rendered once per process (or handed
    over by prefill)."""
    if (T, W, H) not in _SCENES:
        prefill(synthetic.make_sequence(n_frames=T, width=W, height=H, seed=0))
    return _SCENES[(T, W, H)]


def prefill(seq) -> None:
    """Hand over make_sequence(T, W, H, seed=0)'s tuple rendered elsewhere
    (synthetic.render("planes", T, W, H, 0) in a worker process)."""
    frames, Rs = seq[0], seq[1]
    arr = np.stack(frames)
    arr.setflags(write=False)
    T, H, W = arr.shape
    _SCENES[(T, W, H)] = (arr, Rs)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def committed_baseline(frames: np.ndarray) -> float:
    """The `bench` entry's cpu_baseline_fps, where its T, W, H and the
    sha256 of the first min(T, 32) frames are these frames'; else raises."""
    path = reference_band.SPEED_PATH
    rec = reference_band.load_speed()["bench"]
    T, H, W = frames.shape
    if (rec["T"], rec["W"], rec["H"]) != (T, W, H):
        raise ValueError(f"the committed baseline ({path}) is for T {rec['T']}, {rec['W']}x"
                         f"{rec['H']}, not T {T}, {W}x{H}: use --reference live where cv2 is")
    timed = frames[:reference_band.BENCH_TIMED]
    if synthetic.frames_sha256(timed) != rec["frames_sha256"]:
        raise ValueError(f"the committed baseline ({path}) timed other frames than these "
                         f"{len(timed)} (sha256 differs)")
    _log(f"baseline: committed, {path} entry 'bench': {rec['cpu_baseline_fps']:.3f} frames/s "
         f"over {rec['timed_frames']} frames (median of {len(rec['samples_fps'])}), measured "
         f"{rec['date']} on {json.dumps(rec['host'])}")
    return float(rec["cpu_baseline_fps"])


def live_baseline(frames: np.ndarray) -> float:
    """bench.py's baseline on this host's CPU (needs cv2)."""
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise RuntimeError("--reference live needs cv2, which this host lacks; use "
                           "--reference committed") from e
    _, H, W = frames.shape
    fps, samples = reference_band.bench_baseline(list(frames), W, H)
    _log(f"baseline: live, ReferenceVO on this host: {fps:.3f} frames/s (samples "
         f"{[round(s, 3) for s in samples]}) on {json.dumps(reference_band.host())}")
    return fps


def _window_s(run, repeats: int, on_card: bool) -> float:
    """Seconds of `repeats` back-to-back calls of run(): CUDA events
    around them on the card (the end recorded after the last call's
    poses are enqueued), the host clock on the CPU."""
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(repeats):
        run()
    return time.perf_counter() - t0


def e2e_decode(frames: np.ndarray, cfg: VOConfig, dev: torch.device):
    """bench.py's e2e_decode_fps (:140-191): the frames written as PNG
    files, then io_bench.e2e_decode_fps over them; None, saying why, where
    the native loader does not build."""
    if not native_loader.available():
        _log(f"e2e_decode_fps omitted: the native loader does not build "
             f"({native_loader.unavailable_reason()})")
        return None
    tmp = tempfile.mkdtemp(prefix="vo_bench_")
    try:
        for i, f in enumerate(frames):
            write_png(os.path.join(tmp, f"{i:06d}.png"), f)
        return io_bench.e2e_decode_fps(tmp, len(frames), cfg, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, defaults(), device, sizes, __doc__.split("\n\n")[0])
    if o.reference not in REFERENCES:
        raise ValueError(f"reference must be one of {REFERENCES}, got {o.reference!r}")
    dev = o.device
    on_card = dev.type == "cuda"
    if on_card:
        _log(f"card: {profiling.card()}")
    T, W, H = o.T, o.width, o.height
    frames_np, _ = scene(T, W, H)

    # the baseline first, on the host, before anything runs on the device
    base_fps = (committed_baseline(frames_np) if o.reference == "committed"
                else live_baseline(frames_np))

    cfg = VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=o.features),
                   ransac=RansacConfig(max_iters=o.hyps))
    frames = torch.from_numpy(frames_np.copy()).to(dev)
    out = {}

    def run():
        out["last"] = run_sequence_batched(frames, cfg, frame_chunk=o.fc, pair_chunk=o.pc,
                                           device=dev)

    # bench.py threads a carry-scaled epsilon through its repeats (:84-95)
    # so that XLA neither hoists nor merges the identical calls of one
    # dispatch; eager PyTorch does neither, so each call here launches all
    # of its own work and needs no such guard.
    for _ in range(WARMUP_WINDOWS):
        _window_s(run, o.repeats, on_card)
    times = [_window_s(run, o.repeats, on_card) for _ in range(WINDOWS)]
    fps = o.repeats * T / statistics.median(times)
    poses, diags = out["last"]
    profiling.fence(poses)
    calls = (WARMUP_WINDOWS + WINDOWS) * o.repeats
    launches = calls * profile_rows.frame_launches(T, o.fc)
    _log(f"bench: {calls} calls of run_sequence_batched (T {T}, {W}x{H}, fc {o.fc}, pc {o.pc}); "
         f"windows of {o.repeats}: {[round(t * 1e3, 3) for t in times]} ms "
         f"({'CUDA events' if on_card else 'host clock, CPU'})")

    e2e = None
    try:
        e2e = e2e_decode(frames_np, cfg, dev)
        if e2e is not None:
            launches += io_bench.e2e_decode_launches(T)
    except Exception as e:  # bench.py:118-123: omit it, visibly
        _log(f"warning: e2e decode bench failed, omitting e2e_decode_fps "
             f"({type(e).__name__}: {e})")

    line = {"metric": METRIC, "value": round(fps, 2), "unit": UNIT,
            "vs_baseline": round(fps / base_fps, 2), "cpu_baseline_fps": round(base_fps, 2)}
    if e2e:
        line["e2e_decode_fps"] = round(e2e, 2)
    _LAST.clear()
    _LAST.update(poses=poses, diagnostics=diags, fps=fps, cpu_baseline_fps=base_fps,
                 expected_launches={k: launches if on_card else 0
                                    for k in profile_rows.KERNELS})
    text = json.dumps(line)
    print(text, flush=True)
    if o.out:
        with open(o.out, "w") as f:
            f.write(text + "\n")
    return line


def last_run() -> dict:
    """The last main call's poses and diagnostics (of its last timed
    run), its unrounded fps and cpu_baseline_fps, and expected_launches:
    the B1 (select_maps) and B2 (extract_patches) launches its calls imply
    on the card (0 on the CPU, where the plain versions run)."""
    return dict(_LAST)


if __name__ == "__main__":
    main(sys.argv[1:])
