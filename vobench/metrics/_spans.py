"""The program's own spans (tpu_vo_torch.utils.profiling.spans()) in the
traced window, for the readers of the metrics that read them.

A span's host interval is on the profiler's clock already (time.time_ns()),
and so is the host time of each device operation's launch
(vobench.trace.Op.launch): the device time launched inside a span needs
no second clock. A program without spans() (an older one) and a run that
recorded none give no view."""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import numpy as np

from vobench.trace import merged


def _program_spans() -> list:
    try:
        from tpu_vo_torch.utils import profiling
    except ImportError:
        return []
    get = getattr(profiling, "spans", None)
    return get() if get is not None else []


class View:
    """The window's spans and device busy intervals, in ns from the
    window's start."""

    def __init__(self, ctx, recs: list, every: list):
        self.ctx, self.recs, self.every = ctx, recs, every
        self.w0, w1 = ctx.trace.window
        self.length = w1 - self.w0
        busy = merged((o.start - self.w0, o.end - self.w0) for o in ctx.trace.ops)
        self.starts = np.array([s for s, _ in busy], dtype=np.float64)
        self.ends = np.array([e for _, e in busy], dtype=np.float64)
        self.cum = np.concatenate([[0.0], np.cumsum(self.ends - self.starts)])

    def _busy_before(self, t: np.ndarray) -> np.ndarray:
        """Device busy ns in [0, t) for each t."""
        if not len(self.starts):
            return np.zeros_like(t)
        i = np.searchsorted(self.starts, t, side="right")
        full = self.cum[np.maximum(i - 1, 0)]
        part = np.clip(t - self.starts[np.maximum(i - 1, 0)], 0.0,
                       self.ends[np.maximum(i - 1, 0)] - self.starts[np.maximum(i - 1, 0)])
        return np.where(i > 0, full + part, 0.0)

    def named(self, name: str) -> list:
        return [r for r in self.recs if r.name == name]

    def host(self, recs: list) -> List[Tuple[float, float]]:
        """The records' host intervals."""
        return merged((r.start_ns - self.w0, r.end_ns - self.w0) for r in recs)

    def busy_in(self, intervals) -> float:
        """Device busy ns inside the union of `intervals`."""
        if not intervals:
            return 0.0
        a = np.array([s for s, _ in intervals], dtype=np.float64)
        b = np.array([e for _, e in intervals], dtype=np.float64)
        return float((self._busy_before(b) - self._busy_before(a)).sum())

    def idle_in(self, intervals) -> float:
        """Device idle ns inside the union of `intervals`, within the window."""
        clipped = [(max(s, 0.0), min(e, self.length)) for s, e in intervals]
        clipped = [(s, e) for s, e in clipped if e > s]
        return sum(e - s for s, e in clipped) - self.busy_in(clipped)

    def first_call(self):
        """The process's first vo.call, wherever it lies (the warm-up)."""
        return next((r for r in self.every if r.name == "vo.call" and r.call == 0), None)


_last: list = [None, None]


def view(ctx) -> Optional[View]:
    """The View of ctx's traced window, or None where the program
    recorded no span inside it."""
    if _last[0] is ctx:
        return _last[1]
    out = None
    if ctx.trace is not None:
        every = _program_spans()
        lo, hi = ctx.trace.window
        recs = [r for r in every if lo <= r.start_ns and r.end_ns <= hi]
        if recs:
            out = View(ctx, recs, every)
    _last[:] = [ctx, out]
    return out


def launched_ms_per_call(ctx, name: str) -> Optional[float]:
    """Device ms of the operations launched while the host was inside the
    program's spans `name` (a CUDA graph's kernels where its
    cudaGraphLaunch was made), per call of the window; None without a
    device trace, such a span, or an operation launched inside one."""
    v = view(ctx)
    if v is None or not ctx.trace.ops:
        return None
    iv = v.host(v.named(name))
    starts = [s for s, _ in iv]
    inside = []
    for o in ctx.trace.ops:
        if o.launch is not None:
            i = bisect.bisect_right(starts, o.launch - v.w0) - 1
            if i >= 0 and o.launch - v.w0 < iv[i][1]:
                inside.append(o.end - o.start)
    return sum(inside) / 1e6 / len(ctx.calls) if inside else None
