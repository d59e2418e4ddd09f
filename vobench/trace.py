"""The traced window reduced to what the per-layer metrics read.

Device busy time is the union of the device operations' intervals, and
the host's waits are the runtime calls of SYNC_CALLS, as
tpu_vo_torch/utils/profiling.py `busy_profile` and `interval_union`
count them (copied). A device operation belongs to the harness span that was open on
the host when its launch (the runtime call with its correlation id) was
made, and keeps that launch's host time; a CUDA graph's kernels carry
the correlation id of their cudaGraphLaunch. An idle gap on the device
is named by the innermost span the host was in when the gap began."""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, NamedTuple, Optional, Tuple

# CUDA runtime calls that make the host wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
CALL_SPAN = "vobench.call"
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
TOP = 10


class Op(NamedTuple):
    start: int      # ns, the host's clock
    end: int
    name: str
    span: Optional[str]  # the harness span its launch came from
    launch: Optional[int]  # ns, the host's clock: its launch; None where the trace names none


class Summary(NamedTuple):
    ops: List[Op]                    # device operations inside the window
    window: Tuple[int, int]          # first call's start, last call's end (ns)
    busy_ns: int                     # union of the ops' intervals
    host_counts: Dict[str, int]      # host events by name inside the window
    gaps: List[Tuple[str, float]]    # the longest idle gaps: (span, seconds)
    top_ops: List[Tuple[str, float]]  # device time by operation name (seconds)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9


def merged(intervals) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Spans:
    """The span the host was in at a time: a stage span if one was open,
    else the call span, else None (stage spans do not overlap, nor do
    call spans)."""

    def __init__(self, spans):
        self.levels = []
        for inner in (True, False):
            level = sorted((s, e, n) for s, e, n in spans if (n != CALL_SPAN) == inner)
            self.levels.append(([s for s, _, _ in level], level))

    def at(self, t: int) -> Optional[str]:
        for starts, level in self.levels:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < level[i][1]:
                return level[i][2]
        return None


def summarize(events, span_names) -> Summary:
    """Reduce the profiler's raw events (prof.profiler.kineto_results.events())
    of a window of calls, each in a CALL_SPAN span, their stage functions
    in spans named by `span_names`."""
    names = set(span_names) | {CALL_SPAN}
    dev, spans, launch, host = [], [], {}, []
    for e in events:
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if e.device_type().name == "CUDA":
            if not e.is_user_annotation() and kind != "gpu_user_annotation":
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                            e.correlation_id()))
            continue
        name = e.name()
        if name in names and e.is_user_annotation():
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif kind in RUNTIME_KINDS or name.startswith("cuda"):
            launch[e.correlation_id()] = e.start_ns()
        host.append((e.start_ns(), name))
    calls = [s for s in spans if s[2] == CALL_SPAN]
    if not calls:
        raise ValueError("the trace holds no call span")
    window = (min(s[0] for s in calls), max(s[1] for s in calls))
    index = _Spans(spans)
    ops = []
    for s, e, name, cid in dev:
        if e <= window[0] or s >= window[1]:
            continue
        t = launch.get(cid)
        ops.append(Op(max(s, window[0]), min(e, window[1]), name,
                      index.at(t) if t is not None else None, t))
    counts = collections.Counter(n for t, n in host if window[0] <= t < window[1])
    busy = merged((o.start, o.end) for o in ops)
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    gaps = sorted(((index.at(a) or "outside calls", (b - a) / 1e9)
                   for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  key=lambda g: -g[1])[:TOP]
    by_name = collections.Counter()
    for o in ops:
        by_name[o.name] += o.end - o.start
    top = [(n[:160], ns / 1e9) for n, ns in by_name.most_common(TOP)]
    return Summary(ops, window, sum(e - s for s, e in busy), dict(counts), gaps, top)
