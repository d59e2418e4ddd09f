"""Where the end-to-end frames/s go between decode, upload and compute
(port of tools/io_bench.py, with bench.py's e2e_decode_fps leg).

    python -m tpu_vo_torch.tools.io_bench [--frames 64] [--chunk 16]
        [--width 1241] [--height 376] [--features 1200] [--levels 8]
        [--compute-frames 64] [--reps 3] [--device cpu]

On the card unless given --device cpu. It writes make_sequence(frames,
width, height, seed=0) as Paeth-filtered PNG files (io/dataset.write_png)
into a temporary directory, then prints one JSON line with these rows,
frames per second unless named otherwise, tagged with the card's name and
power limit:

  upload_only_mbps, upload_only_fps  the frames through
      pipeline/upload.upload_ahead (pinned ring, side stream) in chunks,
      each chunk summed on the device (CUDA events on the consumer's
      stream, from before the first chunk to after the last sum);
  compute_only_fps          run_sequence_batched on compute_frames frames
      already on the device, frame_chunk 8, pair_chunk 9 (CUDA events);
  streamed_host_chunks_fps  run_sequence_streamed over decoded host chunks;
  decode_only_fps           the native loader alone (4 threads, depth 32);
  decode_only_1thread_fps   the same on 1 thread;
  native_paeth_ms, native_jpeg_ms  NativeDataset.read of one frame alone:
      the first Paeth PNG, and the same frame as a quality-90 baseline
      JPEG (io/jpeg.encode_gray);
  decode_only_python_fps    io/dataset.load_frame alone, on min(8, frames)
      frames;
  e2e_png_fps               native decode, upload and compute overlapped:
      run_sequence_streamed over the native loader's chunks;
  e2e_packed_fps            the same from a packed .vobin file;
  e2e_decode_fps            bench.py's leg (bench.py:141-183): chunks of
      min(64, frames), 8 threads, depth 32, the larger of two runs after
      one warm-up;
  e2e_png_python_fps        run_sequence_streamed over chunks that the
      Python decoder makes on the uploader thread (one run).

Device rows are medians of --reps runs after one warm-up; the streamed
and e2e rows are host wall time, ending when the last pose is on the
host. With --device cpu every row is host wall time on the CPU. Native
rows are null, and `native` holds the reason, where the native loader's
build failed.
"""

from __future__ import annotations

import argparse
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
from tpu_vo_torch.io.dataset import list_image_paths, load_frame, write_png
from tpu_vo_torch.io.jpeg import encode_gray
from tpu_vo_torch.pipeline.runner import (STREAM_FRAME_CHUNK, entry_device,
                                          run_sequence_batched, run_sequence_streamed)
from tpu_vo_torch.pipeline.upload import upload_ahead
from tpu_vo_torch.utils.profiling import card, cuda_times
from tpu_vo_torch.utils.synthetic import make_sequence

PAETH = 4
COMPUTE_FRAME_CHUNK, COMPUTE_PAIR_CHUNK = 8, 9   # bench.py:66-67
DECODE_THREADS, DECODE_DEPTH = 4, 32
PYTHON_DECODE_FRAMES = 8
JPEG_QUALITY = 90
E2E_CHUNK, E2E_THREADS = 64, 8                    # bench.py:161, :173


def chunks_of(frames, chunk: int, limit=None):
    """(n, H, W) stacks of `chunk` frames from an iterator of (i, frame),
    the last one shorter; at most `limit` frames."""
    buf = []
    for i, frame in frames:
        buf.append(frame)
        if len(buf) == chunk:
            yield np.stack(buf)
            buf = []
        if limit is not None and i + 1 >= limit:
            break
    if buf:
        yield np.stack(buf)


def _wall_fps(n: int, fn) -> float:
    """n / host seconds of fn(), which returns poses; the time ends when
    the last position is on the host."""
    t0 = time.perf_counter()
    poses = fn()
    poses.t[-1].cpu()
    return n / (time.perf_counter() - t0)


def _median_fps(n: int, fn, reps: int) -> float:
    fn()
    return statistics.median(_wall_fps(n, fn) for _ in range(reps))


def e2e_decode_fps(root: str, T: int, cfg: VOConfig, dev: torch.device) -> float:
    """bench.py's e2e leg (bench.py:141-183) over the first T image files
    in `root`: run_sequence_streamed over the native loader's chunks of
    min(64, T) frames (E2E_THREADS threads, depth DECODE_DEPTH), the
    larger of two runs after one warm-up, host wall time to the last
    pose on the host. B1 and B2 launch as e2e_decode_launches says."""
    c = min(E2E_CHUNK, T)
    n = (T // c) * c

    def e2e_decode():
        with native_loader.NativeDataset(root, E2E_THREADS, DECODE_DEPTH) as ds:
            return run_sequence_streamed(chunks_of(ds, c, limit=n), cfg, c, device=dev)[0]

    _wall_fps(n, e2e_decode)
    return max(_wall_fps(n, e2e_decode), _wall_fps(n, e2e_decode))


def e2e_decode_launches(T: int) -> int:
    """B1's (and B2's) launches of one e2e_decode_fps call over T frames:
    3 runs of T // c chunks of c = min(64, T) frames, each chunk
    STREAM_FRAME_CHUNK frames a launch where that divides c, else one."""
    c = min(E2E_CHUNK, T)
    per_chunk = c // STREAM_FRAME_CHUNK if c % STREAM_FRAME_CHUNK == 0 else 1
    return 3 * (T // c) * per_chunk


def _frame_ms(root: str, reps: int) -> float:
    """Median host ms of NativeDataset.read(0) on `root`'s first file,
    after one read."""
    with native_loader.NativeDataset(root, 1) as ds:
        ds.read(0)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            ds.read(0)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="io_bench", description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--width", type=int, default=1241)
    p.add_argument("--height", type=int, default=376)
    p.add_argument("--features", type=int, default=1200)
    p.add_argument("--levels", type=int, default=8)
    p.add_argument("--compute-frames", type=int, default=64,
                   help="frames of the compute-only row: 64, or at most 8")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    dev = entry_device(args.device)
    on_card = dev.type == "cuda"
    T, W, H, chunk = args.frames, args.width, args.height, args.chunk
    cfg = VOConfig(image_width=W, image_height=H,
                   orb=ORBConfig(n_features=args.features, n_levels=args.levels),
                   ransac=RansacConfig(max_iters=256))
    frames_np = make_sequence(n_frames=max(T, args.compute_frames), width=W, height=H,
                              seed=0)[0]
    arr = np.stack(frames_np[:T])
    mb = arr.nbytes / 1e6
    out = {"frames": T, "shape": [H, W], "features": args.features, "levels": args.levels,
           "chunk": chunk, "payload_mb": mb, "host_cpus": os.cpu_count(), "png_filter": "Paeth",
           "device": card() if on_card else "cpu",
           "clock": "CUDA events (device rows), host (the rest)" if on_card else "host"}
    host_chunks = [arr[i:i + chunk] for i in range(0, T, chunk)]

    # upload only: the pinned ring in chunks, each summed on the device
    def upload_once() -> float:
        def run():
            for _, t in upload_ahead(((None, c) for c in host_chunks), dev):
                t.sum(dtype=torch.int32)
        if not on_card:
            t0 = time.perf_counter()
            run()
            return (time.perf_counter() - t0) * 1e3
        return cuda_times(run, warmup=0, reps=1)[0]

    upload_once()
    ms = statistics.median(upload_once() for _ in range(args.reps))
    out["upload_only_mbps"] = mb / (ms / 1e3)
    out["upload_only_fps"] = T / (ms / 1e3)

    # compute only: the batched runner on frames already on the device
    Tc = args.compute_frames
    frames_dev = torch.from_numpy(np.stack(frames_np[:Tc])).to(dev)

    def compute():
        return run_sequence_batched(frames_dev, cfg, frame_chunk=COMPUTE_FRAME_CHUNK,
                                    pair_chunk=COMPUTE_PAIR_CHUNK, device=dev)[0]

    if on_card:
        out["compute_only_fps"] = Tc * 1e3 / statistics.median(
            cuda_times(compute, warmup=1, reps=args.reps))
    else:
        out["compute_only_fps"] = _median_fps(Tc, compute, args.reps)
    del frames_dev

    # the streamed runner over decoded host chunks (runner + upload)
    out["streamed_host_chunks_fps"] = _median_fps(
        T, lambda: run_sequence_streamed(iter(host_chunks), cfg, device=dev)[0], args.reps)

    tmp = tempfile.mkdtemp(prefix="io_bench_")
    try:
        for i, f in enumerate(arr):
            write_png(os.path.join(tmp, f"{i:06d}.png"), f, filter_type=PAETH)
        paths = list_image_paths(tmp)
        n_py = min(PYTHON_DECODE_FRAMES, T)
        t0 = time.perf_counter()
        for path in paths[:n_py]:
            load_frame(path)
        out["decode_only_python_fps"] = n_py / (time.perf_counter() - t0)
        out["e2e_png_python_fps"] = _wall_fps(T, lambda: run_sequence_streamed(
            chunks_of(((i, load_frame(path)) for i, path in enumerate(paths)), chunk),
            cfg, device=dev)[0])

        out["native"] = "built" if native_loader.available() else \
            native_loader.unavailable_reason()
        rows = ("decode_only_fps", "decode_only_1thread_fps", "native_paeth_ms",
                "native_jpeg_ms", "e2e_png_fps", "e2e_packed_fps", "e2e_decode_fps")
        out.update(dict.fromkeys(rows))
        if out["native"] == "built":
            def decode_once(threads: int) -> float:
                with native_loader.NativeDataset(tmp, threads, DECODE_DEPTH) as ds:
                    t0 = time.perf_counter()
                    n = sum(1 for _ in ds)
                    return n / (time.perf_counter() - t0)

            for key, threads in (("decode_only_fps", DECODE_THREADS),
                                 ("decode_only_1thread_fps", 1)):
                out[key] = statistics.median(decode_once(threads) for _ in range(args.reps))

            jpeg_dir = os.path.join(tmp, "jpeg")
            os.makedirs(jpeg_dir)
            with open(os.path.join(jpeg_dir, "000000.jpg"), "wb") as f:
                f.write(encode_gray(arr[0], JPEG_QUALITY))
            for key, d in (("native_paeth_ms", tmp), ("native_jpeg_ms", jpeg_dir)):
                out[key] = _frame_ms(d, args.reps)

            def e2e_png():
                with native_loader.NativeDataset(tmp, DECODE_THREADS, DECODE_DEPTH) as ds:
                    return run_sequence_streamed(chunks_of(ds, chunk), cfg, device=dev)[0]

            out["e2e_png_fps"] = _median_fps(T, e2e_png, args.reps)

            pack = os.path.join(tmp, "seq.vobin")
            native_loader.pack_dataset(tmp, pack, n_threads=DECODE_THREADS)

            def e2e_packed():
                with native_loader.PackedSequence(pack) as ps:
                    return run_sequence_streamed(
                        (ps.read(i, min(chunk, T - i)) for i in range(0, T, chunk)), cfg,
                        device=dev)[0]

            out["e2e_packed_fps"] = _median_fps(T, e2e_packed, args.reps)

            out["e2e_decode_fps"] = e2e_decode_fps(tmp, T, cfg, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
