"""Tracing, fences and timers (port of tpu_vo/utils/profiling.py, with
torch.profiler in place of jax.profiler and a CUDA-event timer beside
its host clock).

  trace(log_dir)        torch.profiler (CPU and CUDA activities) around a
                        block, a Chrome trace written into log_dir or
                        $TPU_VO_TRACE_DIR; a no-op when neither is set;
  span(name)            the program's span at a layer boundary: recorded
                        (and a record_function in the profiler's trace)
                        while any torch.profiler session records, and
                        host side only in the process's first call of
                        an entry point; spans() returns the record,
                        reset_spans() clears it;
  StageTimer            wall-clock totals per named stage, with fences;
  benchmark(fn, *args)  first-call and steady-state seconds of fn(*args);
  fence(tree)           wait for the CUDA tensors of a nested structure;
  cuda_times(fn, ...)   milliseconds of each call of fn() by CUDA events;
  busy_profile(fn, ...) torch.profiler over calls of fn() on the card: host
                        ms a call, device busy ms (the union of device
                        intervals), device ops, copies and the runtime
                        calls that wait for the card;
  kernel_alone_ms(fn, name, calls)  a kernel's own device time (the
                        profiler's durations), without its wrapper's host work;
  card()                the card's "name, power.limit" from nvidia-smi,
                        the tag beside every number taken on it.

Unlike tpu_vo's trace, which swallows an exception raised in its body
when a trace directory is set (and then fails in contextlib with "generator
didn't stop after throw()"), an exception in the body propagates unchanged.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import statistics
import subprocess
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

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


# The program's spans. Every entry point opens CALL_SPAN (the outermost
# only); inside it each layer boundary opens a span named vo.*, orb.*,
# pair.*, ransac.* or kernels.*. A span is recorded while a torch.profiler
# session records (torch._C._autograd._profiler_enabled(), checked at each
# entry), as a record_function of its name and in the in-memory record
# below, with the CUDA events of its device interval where CUDA is
# initialized; and during the process's first entry-point call, on the
# host only. Otherwise span() returns one shared null context.
CALL_SPAN = "vo.call"
SPAN_LIMIT = 65536          # spans kept: the newest, in order of their ends


class Span(NamedTuple):
    """One recorded span. Host times are time.time_ns(), the clock that
    torch.profiler stamps its host events with; start_ns is taken just
    before the span's start event is recorded, end_ns just before its end
    event. The device interval, where there is one, is in ns after the
    first CUDA event that its call recorded on `device` (dev_start,
    dev_end): a reader aligns it to the profiler's clock with one offset
    per call and device."""

    name: str
    id: int
    parent: Optional[int]     # the id of the span it opened in
    call: Optional[int]       # the number of its vo.call (0: the process's first)
    start_ns: int
    end_ns: int
    device: Optional[int]     # CUDA device index of the events
    dev_start: Optional[float]
    dev_end: Optional[float]


class _Open:
    """A span while it is open, and until spans() resolves its events."""

    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns", "device",
                 "base", "ev0", "ev1", "bases", "dev_start", "dev_end")

    def __init__(self, name, parent, call):
        self.name, self.id = name, next(_ids)
        self.parent, self.call = parent, call
        self.device = self.base = self.ev0 = self.ev1 = self.dev_start = self.dev_end = None
        self.bases = {}      # a root's first event per device: its call's time zero


_records: "collections.deque[Any]" = collections.deque(maxlen=SPAN_LIMIT)
_ids = itertools.count()
_calls = itertools.count()
_local = threading.local()   # .stack: this thread's open spans, outermost first
_first_call = [True]         # the process's first entry-point call is still to come
_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def _timing_event(device: int):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Recorded:
    """span()'s context when on: `traced` (a profiler records) adds the
    record_function and the CUDA events; else host times only."""

    __slots__ = ("name", "traced", "rf", "rec")

    def __init__(self, name: str, traced: bool):
        self.name, self.traced, self.rf = name, traced, None

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        if self.traced:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if stack:
            rec = _Open(self.name, stack[-1].id, stack[-1].call)
        else:
            rec = _Open(self.name, None, next(_calls) if self.name == CALL_SPAN else None)
        root = stack[0] if stack else rec
        rec.start_ns = time.time_ns()
        if self.traced and torch.cuda.is_initialized():
            rec.device = torch.cuda.current_device()
            rec.ev0 = _timing_event(rec.device)
            rec.base = root.bases.setdefault(rec.device, rec.ev0)
        stack.append(rec)
        self.rec = rec

    def __exit__(self, *exc):
        rec = self.rec
        _local.stack.pop()
        rec.end_ns = time.time_ns()
        if rec.ev0 is not None:
            rec.ev1 = _timing_event(rec.device)
        rec.bases = None
        _records.append(rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around the work of one layer boundary: a
    record_function(name) and a record (see Span) while a torch.profiler
    session records; host times only during the process's first call of
    an entry point (CALL_SPAN, opened by the outermost entry alone); else
    a shared null context that records nothing."""
    stack = _local.__dict__.get("stack")
    if name == CALL_SPAN:
        if stack:
            return _NULL
        traced = _profiler_enabled()
        if _first_call[0]:
            _first_call[0] = False
            return _Recorded(name, traced)
        return _Recorded(name, True) if traced else _NULL
    if _profiler_enabled():
        return _Recorded(name, True)
    if stack and stack[0].call == 0:
        return _Recorded(name, False)        # inside the first call, host only
    return _NULL


def spans() -> List[Span]:
    """The recorded spans, at most SPAN_LIMIT, the newest last, each
    device interval resolved from its CUDA events (which waits for the
    devices that recorded them: call it after the traced work)."""
    recs = list(_records)
    devices = {r.device for r in recs if r.ev1 is not None}
    for d in devices:
        torch.cuda.synchronize(d)
    out = []
    for r in recs:
        if r.ev1 is not None:
            r.dev_start = r.base.elapsed_time(r.ev0) * 1e6
            r.dev_end = r.base.elapsed_time(r.ev1) * 1e6
            r.base = r.ev0 = r.ev1 = None
        out.append(Span(r.name, r.id, r.parent, r.call, r.start_ns, r.end_ns, r.device,
                        r.dev_start, r.dev_end))
    return out


def reset_spans() -> None:
    """Forget every recorded span."""
    _records.clear()


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


# CUDA runtime calls that make the host wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def interval_union(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_profile(fn: Callable[[], Any], runs: int, warmup: int, rows: int = 0,
                 name: str = "run") -> Dict[str, Any]:
    """torch.profiler (CPU and CUDA activities) over `runs` calls of fn(),
    each in a record_function(name), after `warmup` calls. Returns per
    call: host_ms (host clock, profiler on), busy_ms (the union of the
    device intervals) and busy_share (busy over host time), device_ops,
    htod and dtoh copies, waits ({runtime call: count}, SYNC_CALLS) and
    waits_total; with rows, "table", the top rows by device time. It
    measures the card and raises without one."""
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        raise RuntimeError("busy_profile: no CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            with record_function(name):
                fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the profiler's raw events: building its Python event tree (prof.events())
    # takes minutes for runs of a million launches
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    dev_ops, host = [], collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if e.name() != name and not e.is_user_annotation():
                dev_ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.device_type() == cpu:
            host[e.name()] += 1
    busy = interval_union([(a, b) for a, b, _ in dev_ops]) / 1e6
    waits = {c: host[c] / runs for c in SYNC_CALLS}
    out = {"host_ms": wall_ms / runs, "busy_ms": busy / runs, "busy_share": busy / wall_ms,
           "device_ops": len(dev_ops) / runs,
           "htod": sum("HtoD" in n for _, _, n in dev_ops) / runs,
           "dtoh": sum("DtoH" in n for _, _, n in dev_ops) / runs,
           "waits": waits, "waits_total": sum(waits.values())}
    if rows:
        out["table"] = prof.key_averages().table(sort_by="cuda_time_total", row_limit=rows,
                                                 max_name_column_width=60)
    return out


def kernel_alone_ms(fn: Callable[[], Any], name, calls: int, attempts: int = 3) -> Optional[float]:
    """Median device duration (ms) of the kernels whose name holds `name`
    (or one of a tuple of names) over `calls` calls of fn() (after one),
    from torch.profiler: the kernel without its wrapper's host work. A
    profiler session on the card sometimes records no device event at
    all: up to `attempts` sessions are made; None where none recorded it."""
    from torch.profiler import ProfilerActivity, profile

    names = (name,) if isinstance(name, str) else tuple(name)
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        d = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(n in e.name for n in names)]
        if d:
            return statistics.median(d) / 1e3
    return None


def card() -> str:
    """The first card's "name, power.limit" as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]
