"""The roofline's work counts, the order statistics and the trace's
reduction, on made-up numbers."""

import statistics
from types import SimpleNamespace

import pytest

from vobench import roofline, stats, trace

MAIN = dict(n_features=1200, n_levels=8, scale_factor=1.2, edge_threshold=31)
UHD = dict(n_features=8000, n_levels=8, scale_factor=1.2, edge_threshold=31)


def test_b1_b2_work_at_the_main_path():
    """PERF.md's kernel table: B1 462 MB and B2 284 MB at 32 frames of
    1241x376 with 1200 keypoints; B1 513.6 MB at config 3's first chunk."""
    nbytes, instr = roofline.b1_work(32, 376, 1241, MAIN)
    assert nbytes == 462_358_528
    assert instr == roofline.SELECT_OPS_PER_PIXEL * 32 * sum(
        max(h - 62, 0) * max(w - 62, 0) for h, w, _ in roofline.used_levels(376, 1241, MAIN))
    assert roofline.b2_work(32, 376, 1241, MAIN) == 284_313_600
    assert roofline.b1_work(2, 2160, 3840, UHD)[0] == 513_572_944
    # bytes bound both kernels at the main path
    assert roofline.least_seconds(nbytes, instr) == pytest.approx(nbytes / 3.35e12)


def test_level_budgets_sum_to_the_keypoints():
    for orb in (MAIN, UHD):
        assert sum(roofline.level_budgets(orb["n_features"], 8, 1.2)) == orb["n_features"]
    assert roofline.level_sizes(376, 1241, 8, 1.2)[1] == (313, 1034)


def test_p95_and_spread():
    calls = [100.0] * 99 + [1000.0]                 # one stall among 100 calls
    assert stats.percentile(calls, 95) == 100.0
    assert stats.percentile(calls, 100) == 1000.0
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 95) == pytest.approx(3.85)
    stalls = [100.0] * 90 + [1000.0] * 10           # ten stalls reach the p95
    assert stats.percentile(stalls, 95) == 1000.0
    vals = [10.0, 11.0, 9.0, 10.5, 9.5, 10.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


class _Ev:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, start, dur, device="CPU", kind="cpu_op", cid=0, user=False):
        self._n, self._s, self._d, self._dev, self._k, self._c, self._u = (
            name, start, dur, device, kind, cid, user)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return SimpleNamespace(name=self._dev)

    def activity_type(self):
        return self._k

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._u


def _span(name, s, e):
    return _Ev(name, s, e - s, kind="user_annotation", user=True)


def test_summarize_busy_idle_gaps_and_attribution():
    """Two calls of 100 ns; kernels launched from stage spans; one stall
    of 40 ns in the second call while the host was in stage 2."""
    ev = [
        _span(trace.CALL_SPAN, 0, 100), _span("runner.detect_frames", 0, 50),
        _span("runner.estimate_pairs", 50, 100),
        _span(trace.CALL_SPAN, 100, 200), _span("runner.detect_frames", 100, 130),
        _span("runner.estimate_pairs", 130, 200),
        _Ev("cudaLaunchKernel", 5, 1, kind="cuda_runtime", cid=1),
        _Ev("cudaLaunchKernel", 55, 1, kind="cuda_runtime", cid=2),
        _Ev("cudaLaunchKernel", 105, 1, kind="cuda_runtime", cid=3),
        _Ev("cudaLaunchKernel", 135, 1, kind="cuda_runtime", cid=4),
        _Ev("cudaStreamSynchronize", 190, 5, kind="cuda_runtime", cid=5),
        _Ev("select_kernel", 10, 40, device="CUDA", kind="kernel", cid=1),
        _Ev("gemm", 50, 50, device="CUDA", kind="kernel", cid=2),
        _Ev("select_kernel", 110, 20, device="CUDA", kind="kernel", cid=3),
        _Ev("gemm", 170, 30, device="CUDA", kind="kernel", cid=4),
    ]
    s = trace.summarize(ev, {"runner.detect_frames": "stage1", "runner.estimate_pairs": "stage2"})
    assert s.window == (0, 200) and s.window_s == 200e-9
    assert s.busy_ns == 40 + 50 + 20 + 30
    assert [o.span for o in s.ops] == ["runner.detect_frames", "runner.estimate_pairs"] * 2
    assert s.host_counts["cudaStreamSynchronize"] == 1
    assert s.gaps[0] == ("runner.estimate_pairs", pytest.approx(40e-9))
    assert dict(s.gaps)["runner.detect_frames"] == pytest.approx(10e-9)
    assert dict(s.top_ops) == {"gemm": pytest.approx(80e-9), "select_kernel": pytest.approx(60e-9)}
    assert trace.merged([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]


def test_summarize_needs_a_call_span():
    with pytest.raises(ValueError):
        trace.summarize([_Ev("aten::add", 0, 1)], {})


def test_summarize_keeps_each_ops_launch():
    """An op keeps the host time of the runtime call with its correlation
    id: both kernels of one cudaGraphLaunch keep its time, and an op whose
    launch the trace lacks keeps None."""
    ev = [
        _span(trace.CALL_SPAN, 0, 100), _span("runner.estimate_pairs", 0, 100),
        _Ev("cudaLaunchKernel", 5, 1, kind="cuda_runtime", cid=1),
        _Ev("cudaGraphLaunch", 20, 2, kind="cuda_runtime", cid=2),
        _Ev("gemm", 10, 5, device="CUDA", kind="kernel", cid=1),
        _Ev("graph_a", 30, 10, device="CUDA", kind="kernel", cid=2),
        _Ev("graph_b", 40, 10, device="CUDA", kind="kernel", cid=2),
        _Ev("orphan", 60, 10, device="CUDA", kind="kernel", cid=9),
    ]
    s = trace.summarize(ev, {"runner.estimate_pairs": "stage2"})
    assert [(o.name, o.launch) for o in s.ops] == [("gemm", 5), ("graph_a", 20), ("graph_b", 20),
                                                   ("orphan", None)]
    assert [o.span for o in s.ops] == ["runner.estimate_pairs"] * 3 + [None]
