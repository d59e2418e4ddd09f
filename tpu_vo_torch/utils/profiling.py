"""Tracing, fences and timers (port of tpu_vo/utils/profiling.py, with
torch.profiler in place of jax.profiler and a CUDA-event timer beside
its host clock).

  trace(log_dir)        torch.profiler (CPU and CUDA activities) around a
                        block, a Chrome trace written into log_dir or
                        $TPU_VO_TRACE_DIR; a no-op when neither is set;
  StageTimer            wall-clock totals per named stage, with fences;
  benchmark(fn, *args)  first-call and steady-state seconds of fn(*args);
  fence(tree)           wait for the CUDA tensors of a nested structure;
  cuda_times(fn, ...)   milliseconds of each call of fn() by CUDA events;
  card()                the card's "name, power.limit" from nvidia-smi,
                        the tag beside every number taken on it.

Unlike tpu_vo's trace, which swallows an exception raised in its body
when a trace directory is set (and then fails in contextlib with "generator
didn't stop after throw()"), an exception in the body propagates unchanged.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional

import torch


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def fence(tree: Any) -> None:
    """Wait for the devices of the CUDA tensors in a tree of lists,
    tuples, dicts and tensors; nothing for CPU tensors, which are ready."""
    devices = {t.device for t in _leaves(tree) if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler around the body, writing a Chrome trace
    (trace_<pid>_<ns>.json) into log_dir or $TPU_VO_TRACE_DIR; a no-op
    when neither is set. CUDA activity is recorded where a card exists."""
    log_dir = log_dir or os.environ.get("TPU_VO_TRACE_DIR")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Accumulates per-stage wall times with device fences.

    Usage:
        timer = StageTimer()
        with timer.stage("features"):
            out = feature_fn(x)
            timer.sync(out)
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def sync(self, tree: Any) -> None:
        fence(tree)

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total*1000:10.2f} ms total "
                         f"({total/n*1000:8.2f} ms/call x {n})")
        return "\n".join(lines)


def benchmark(fn: Callable, *args, repeats: int = 3,
              warmup: int = 2) -> Dict[str, float]:
    """Measure fn(*args): returns dict with first-call and steady seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    fence(out)
    first = time.perf_counter() - t0

    for _ in range(max(warmup - 1, 0)):
        fence(fn(*args))

    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    fence(out)
    steady = (time.perf_counter() - t0) / repeats
    return {"first_call_s": first, "steady_s": steady}


def cuda_times(fn: Callable[[], Any], warmup: int = 2, reps: int = 5,
               iters: int = 1) -> List[float]:
    """Milliseconds per call of fn(), by CUDA events on the current
    stream, for each of `reps` runs of `iters` calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def card() -> str:
    """The first card's "name, power.limit" as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]
