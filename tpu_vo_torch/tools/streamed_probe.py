"""The streamed step's time by tiling (port of tools/streamed_probe.py).

The JAX tool asked whether each streamed step blocked on the remote
TPU's dispatch round trip (its `:1-16`); a card on this host has no such
round trip, so that question has no counterpart here. What carries over
is the sweep: for each (chunk, frame_chunk, pair_chunk) of (16, None,
None), (16, 8, 8), (64, None, None) and (64, 8, 8) on make_sequence(64,
1241, 376, seed=0) (1200 keypoints, 256 hypotheses), through
pipeline/runner._streamed_step(..., frame_chunk, pair_chunk) (None: the
whole chunk in one call; (8, 8) is the streamed runner's default), it
reports

  wall_one_ms              one step and a scalar fetched to the host
                           (host clock, median of `reps`)
  wall_chain8_per_step_ms  8 steps chained through their carry, one fetch
                           at the end, per step (median of `iters`)
  fps_one, fps_chain8      chunk / those times
  ms                       CUDA events around the 8 chained steps, per
                           step (median of the `iters` chains)
  busy_ms ...              torch.profiler over `reps` steps
                           (tools/profile_rows)

    python -m tpu_vo_torch.tools.streamed_probe [--chunks 16,64 --reps 3]
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.tools import profile_rows
from tpu_vo_torch.utils.profiling import busy_profile

DEFAULTS = dict(T=64, width=1241, height=376, features=1200, hyps=256, chunks=(16, 64),
                fc=8, pc=8, reps=3, iters=3)
CHAIN = 8  # steps chained through their carry


def stream(frames: torch.Tensor, chunk: int, cfg: VOConfig, frame_chunk, pair_chunk, seed=0):
    """run_sequence_streamed's result on `frames` cut into chunks of
    `chunk`, each a _streamed_step at (frame_chunk, pair_chunk): (poses,
    pose_ok per pair)."""
    carry = runner._empty_features(cfg, frames.device)
    ests = []
    for a in range(0, frames.shape[0], chunk):
        carry, est = runner._streamed_step(carry, frames[a:a + chunk], cfg, seed, a,
                                           frame_chunk, pair_chunk)
        ests.append(est)
    est = {k: v[1:] for k, v in runner._cat(ests).items() if k != "stats"}
    poses = runner.chain_relative_poses(est["R"], est["t"], est["have_rt"], est["pose_ok"], cfg)
    return poses, est["pose_ok"]


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("streamed_probe", o)
    cfg = VOConfig(image_width=o.width, image_height=o.height,
                   orb=ORBConfig(n_features=o.features), ransac=RansacConfig(max_iters=o.hyps))
    frames = torch.from_numpy(profile_rows.sequence(o.T, o.width, o.height).copy()).to(o.device)
    carry0 = runner._empty_features(cfg, o.device)
    for chunk in o.chunks:
        payload = frames[:chunk]
        for fc, pc in ((None, None), (o.fc, o.pc)):
            n1 = profile_rows.frame_launches(chunk, runner._stream_chunk(chunk, fc))
            step = rows.counted(
                lambda carry, fc=fc, pc=pc, payload=payload: runner._streamed_step(
                    carry, payload, cfg, 0, 0, fc, pc), (n1, n1))

            def one():
                t0 = time.perf_counter()
                _, est = step(carry0)
                est["n_good"][-1].item()
                return (time.perf_counter() - t0) * 1e3

            events = []  # (start, end) of each chain8 call on the card

            def chain8():
                carry = carry0
                t0 = time.perf_counter()
                if rows.on_card:
                    events.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
                    events[-1][0].record()
                for _ in range(CHAIN):
                    carry, est = step(carry)
                if rows.on_card:
                    events[-1][1].record()
                est["n_good"][-1].item()
                return (time.perf_counter() - t0) * 1e3 / CHAIN

            one()  # warm-up
            w1 = statistics.median(one() for _ in range(o.reps))
            w8 = statistics.median(chain8() for _ in range(o.iters))
            row = {"wall_one_ms": w1, "wall_chain8_per_step_ms": w8,
                   "fps_one": chunk / w1 * 1e3, "fps_chain8": chunk / w8 * 1e3,
                   "frames": chunk, "frame_chunk": fc, "pair_chunk": pc,
                   "b1_b2_launches_a_step": n1}
            if rows.on_card:
                torch.cuda.synchronize()
                row["ms"] = statistics.median(a.elapsed_time(b) / CHAIN for a, b in events)
                p = busy_profile(lambda: step(carry0), o.reps, 0, name="step")
                row.update(host_ms=p["host_ms"], busy_ms=p["busy_ms"],
                           busy_share=p["busy_share"], device_ops=p["device_ops"],
                           waits=p["waits_total"])
            else:
                row.update(dict.fromkeys(("ms", "busy_ms", "device_ops", "waits"),
                                         profile_rows.NOT_ON_CARD))
            rows.add(f"streamed_c{chunk}_fc{fc}_pc{pc}", row)
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
