"""The program's own spans (tpu_vo_torch.utils.profiling.spans()) in the
traced window, for the readers of the metrics that read them.

A span's host interval is on the profiler's clock already (time.time_ns()).
Its device interval is in ns after its call's first CUDA event, and is
put on the profiler's clock with one offset per call and device: the
offset at which none of the call's span boundaries cuts a device
operation of the trace (on one stream an event completes between two
operations), the nearest such to the least offset the host allows (an
event cannot complete before the host recorded it). A call where no
offset within SEARCH_NS of that leaves the boundaries uncut by more than
CUT_NS each (the profiler's device clock drifting from the events', as
in a process's later profiler sessions) gives no device intervals, and
the device readers count the calls that fit. A program without spans()
(an older one) and a run that recorded none give no view."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from vobench.trace import merged

SEARCH_NS = 200_000     # how far from the host's least offset the fit looks
CUT_NS = 1_000          # the most a fitted boundary may cut into an operation, on average


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
        self.offsets: Dict[Tuple[int, int], float] = {}    # the calls that fit
        self.misfits: Dict[Tuple[int, int], float] = {}    # the rest: ns cut at their best
        groups: Dict[Tuple[int, int], list] = {}
        for r in recs:
            if r.dev_start is not None and r.call is not None:
                groups.setdefault((r.call, r.device), []).append(r)
        for key, group in groups.items():
            offset, cut = self._fit(group)
            if cut <= CUT_NS * 2 * len(group):
                self.offsets[key] = offset
            else:
                self.misfits[key] = cut
        self.fitted_calls = len({call for call, _ in self.offsets})

    def _busy_before(self, t: np.ndarray) -> np.ndarray:
        """Device busy ns in [0, t) for each t."""
        if not len(self.starts):
            return np.zeros_like(t)
        i = np.searchsorted(self.starts, t, side="right")
        full = self.cum[np.maximum(i - 1, 0)]
        part = np.clip(t - self.starts[np.maximum(i - 1, 0)], 0.0,
                       self.ends[np.maximum(i - 1, 0)] - self.starts[np.maximum(i - 1, 0)])
        return np.where(i > 0, full + part, 0.0)

    def _cut(self, t: np.ndarray) -> np.ndarray:
        """How far each time t lies inside a busy interval (0 in a gap)."""
        i = np.maximum(np.searchsorted(self.starts, t, side="right") - 1, 0)
        s, e = self.starts[i], self.ends[i]
        return np.where((t > s) & (t < e), np.minimum(t - s, e - t), 0.0)

    def _fit(self, group: list) -> Tuple[float, float]:
        """(offset, ns that the boundaries cut into operations at it)."""
        rel = np.array([x for r in group for x in (r.dev_start, r.dev_end)])
        host = np.array([x - self.w0 for r in group for x in (r.start_ns, r.end_ns)],
                        dtype=np.float64)
        least = float(np.max(host - rel))
        if not len(self.starts):
            return least, 0.0
        edges = np.sort(np.concatenate([self.starts, self.ends]))
        cands = [np.array([least])]
        for b in rel:
            lo, hi = np.searchsorted(edges, [b + least - SEARCH_NS, b + least + SEARCH_NS])
            cands.append(edges[lo:hi] - b)
        cands = np.unique(np.concatenate(cands))
        cost = self._cut(cands[:, None] + rel[None, :]).sum(1)
        best = cands[cost == cost.min()]
        return float(best[np.argmin(np.abs(best - least))]), float(cost.min())

    def named(self, name: str) -> list:
        return [r for r in self.recs if r.name == name]

    def host(self, recs: list) -> List[Tuple[float, float]]:
        """The records' host intervals."""
        return merged((r.start_ns - self.w0, r.end_ns - self.w0) for r in recs)

    def device(self, recs: list) -> List[Tuple[float, float]]:
        """The device intervals on the profiler's clock of the records of
        the calls that fit."""
        out = []
        for r in recs:
            d = self.offsets.get((r.call, r.device))
            if d is not None and r.dev_start is not None:
                out.append((r.dev_start + d, r.dev_end + d))
        return merged(out)

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


def device_ms_per_call(ctx, name: str) -> Optional[float]:
    """Device busy ms inside the device intervals of the spans `name`,
    per call that fits, or None without a device trace or such a span."""
    v = view(ctx)
    if v is None or not ctx.trace.ops:
        return None
    iv = v.device(v.named(name))
    return v.busy_in(iv) / 1e6 / v.fitted_calls if iv else None


def stage_sums(ctx) -> List[dict]:
    """Per call that fits and stage (the span_role roles stage1 and
    stage2): the harness's device time of the stage (its operations by
    launch), that of the operations inside the program's stage span whose
    launch the harness did not find, and the device busy time inside the
    program's stage span and inside each of its children's spans, in ms;
    the check that the spans account for the stage."""
    v = view(ctx)
    calls = sorted((r for r in v.recs if r.name == "vo.call"), key=lambda r: r.start_ns)
    bounds = [c.start_ns for c in calls[1:]] + [ctx.trace.window[1] + 1]
    out = []
    for role, name in (("stage1", "vo.stage1"), ("stage2", "vo.stage2")):
        spans = {s for s, r in ctx.span_role.items() if r == role}
        for c, end in zip(calls, bounds):
            harness = sum(o.end - o.start for o in ctx.trace.ops
                          if o.span in spans and c.start_ns <= o.start < end)
            stage = [r for r in v.recs if r.name == name and r.call == c.call]
            iv = v.device(stage)
            if not iv:
                continue
            unfound = sum(min(o.end - v.w0, b) - max(o.start - v.w0, a)
                          for o in ctx.trace.ops if o.span is None for a, b in iv
                          if o.start - v.w0 < b and o.end - v.w0 > a)
            ids = {r.id for r in stage}
            kids = {}
            for r in v.recs:
                if r.parent in ids:
                    kids[r.name] = kids.get(r.name, 0.0) + v.busy_in(v.device([r])) / 1e6
            out.append({"call": c.call, "role": role, "harness_ms": harness / 1e6,
                        "unfound_ms": unfound / 1e6, "span_ms": v.busy_in(iv) / 1e6,
                        "children_ms": sum(kids.values()), "children": kids})
    return out
