"""Fences and timers on the card (port of the fence of
tpu_vo/utils/profiling.py, with a CUDA-event timer in place of its host
clock).

  fence(tree)           wait for the CUDA tensors of a nested structure;
  cuda_times(fn, ...)   milliseconds of each call of fn() by CUDA events;
  card()                the card's "name, power.limit" from nvidia-smi,
                        the tag beside every number taken on it.
"""

from __future__ import annotations

import subprocess
from typing import Any, Callable, List

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
