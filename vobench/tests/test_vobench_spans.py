"""The readers of the program's spans (vobench/metrics/_spans.py and the
metrics that read them) on a hand-built trace: each metric's exact value
from known busy and idle overlaps and launches, device time read by
launch whatever the program's CUDA-event times, and None where the
program recorded no span."""

from types import SimpleNamespace

import pytest

from tpu_vo_torch.utils.profiling import Span
from vobench import harness
from vobench.metrics import _spans
from vobench.trace import Op, Summary, merged

W0 = 1_760_000_000_000_000_000          # the window's start, ns on the host's clock
ROLES = {"runner.detect_frames": "stage1", "runner.estimate_pairs": "stage2",
         "runner.chain_relative_poses": "stage3"}
# device start, end, the harness's role, host time of the launch
OPS = [(1000, 2000, "stage1", 950), (2500, 3000, "stage1", 2450), (4000, 5000, "stage2", 3950),
       (6000, 6500, "stage2", 5950), (8000, 8200, "stage3", 7950)]
# name, id, parent, host (start, end), device (start, end) after the call's first CUDA event
SPANS = [("vo.call", 1, None, (50, 9000), (0, 8900)),
         ("vo.stage1", 2, 1, (900, 3100), (850, 3050)),
         ("orb.describe", 3, 2, (2400, 3050), (2350, 2950)),
         ("orb.pack", 4, 2, (3060, 3090), (2960, 2990)),
         ("vo.stage2", 5, 1, (3500, 6800), (3500, 6700)),
         ("ransac.hypotheses", 6, 5, (3900, 5050), (3850, 4950)),
         ("pair.residual", 7, 5, (5900, 6700), (5850, 6600)),
         ("vo.stage3", 8, 1, (7900, 8300), (7850, 8200))]
NAMES = ["stage2_idle_ms_per_call", "hyp_launched_gpu_ms_per_pair",
         "describe_launched_gpu_ms_per_frame", "stage3_host_ms_per_call", "warmup_call_s"]
WARMUP = Span("vo.call", 0, None, 0, W0 - 3_000_000_000, W0 - 500_000_000, None, None, None)


def _ctx(ops=True, extra=()):
    """The window of one call; `extra` adds ops (start, end, role, launch)."""
    role_span = {r: s for s, r in ROLES.items()}
    got = (OPS + list(extra)) if ops else []
    trace_ops = [Op(W0 + a, W0 + b, f"k{i}", role_span[r], W0 + t)
                 for i, (a, b, r, t) in enumerate(got)]
    busy = sum(e - s for s, e in merged((a, b) for a, b, _, _ in got))
    summary = Summary(trace_ops, (W0, W0 + 10_000), busy, {}, [], [])
    return SimpleNamespace(trace=summary, calls=[(0.0, 1.0)], frames_per_call=4,
                           pairs_per_call=3, span_role=ROLES)


def _records(device=True, drift=0.0):
    """The spans of SPANS, their device times stretched by 1 + `drift` (an
    event clock that drifts from the trace's)."""
    out = [WARMUP]
    for name, i, parent, (hs, he), (ds, de) in SPANS:
        dev = ((0, ds * (1 + drift), de * (1 + drift)) if device else (None, None, None))
        out.append(Span(name, 100 + i, None if parent is None else 100 + parent, 7,
                        W0 + hs, W0 + he, *dev))
    return out


@pytest.fixture
def program(monkeypatch):
    def use(records):
        monkeypatch.setattr(_spans, "_program_spans", lambda: records)
    return use


def _read(ctx):
    return {n: harness._reader("metrics", n)(ctx) for n in NAMES}


def test_each_metric_reads_its_overlaps(program):
    program(_records())
    ctx = _ctx()
    got = _read(ctx)
    # vo.stage2's host interval [3500, 6800]: busy 1000 + 500 of its 3300 ns
    assert got["stage2_idle_ms_per_call"] == pytest.approx(1800 / 1e6)
    # ransac.hypotheses on the host [3900, 5050] launched the op [4000, 5000]; 3 pairs
    assert got["hyp_launched_gpu_ms_per_pair"] == pytest.approx(1000 / 1e6 / 3)
    # orb.describe on the host [2400, 3050] launched the op [2500, 3000]; 4 frames
    assert got["describe_launched_gpu_ms_per_frame"] == pytest.approx(500 / 1e6 / 4)
    assert got["stage3_host_ms_per_call"] == pytest.approx(400 / 1e6)
    assert got["warmup_call_s"] == pytest.approx(2.5)


def test_none_without_spans_and_device_metrics_none_without_device_ops(program):
    program([])
    assert _read(_ctx()) == {n: None for n in NAMES}
    program([WARMUP])                       # nothing inside the window
    assert _read(_ctx()) == {n: None for n in NAMES}
    program(_records(device=False))         # a run on the CPU
    got = _read(_ctx(ops=False))
    assert got["stage2_idle_ms_per_call"] is None
    assert got["hyp_launched_gpu_ms_per_pair"] is None
    assert got["describe_launched_gpu_ms_per_frame"] is None
    assert got["stage3_host_ms_per_call"] == pytest.approx(400 / 1e6)
    assert got["warmup_call_s"] == pytest.approx(2.5)


def test_a_program_without_spans_gives_none(monkeypatch):
    from tpu_vo_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert _spans._program_spans() == []
    assert _read(_ctx()) == {n: None for n in NAMES}


def test_an_op_launched_inside_the_span_counts_wherever_it_runs(program):
    """Launched at 5000, inside ransac.hypotheses' host interval [3900,
    5050], it runs after it, at [5200, 5600]; launched at 3800, in
    vo.stage2 but not in the solver's span, an op that runs at [4100,
    4200], inside the solver's device interval, is not the solver's."""
    program(_records())
    ctx = _ctx(extra=[(5200, 5600, "stage2", 5000), (4100, 4200, "stage2", 3800)])
    got = _read(ctx)
    assert got["hyp_launched_gpu_ms_per_pair"] == pytest.approx((1000 + 400) / 1e6 / 3)
    assert got["describe_launched_gpu_ms_per_frame"] == pytest.approx(500 / 1e6 / 4)


def test_a_graphs_kernels_count_where_its_launch_was_made(program):
    """A five_point.replay span inside ransac.hypotheses whose one
    cudaGraphLaunch, at 4200, gave two kernels its correlation id: both
    count as the solver's, after the op launched before the replay."""
    replay = Span("five_point.replay", 120, 106, 7, W0 + 4100, W0 + 4300, 0, 4050.0, 4250.0)
    program(_records() + [replay])
    ctx = _ctx(extra=[(5060, 5160, "stage2", 4200), (5160, 5300, "stage2", 4200)])
    assert _read(ctx)["hyp_launched_gpu_ms_per_pair"] == pytest.approx(
        (1000 + 100 + 140) / 1e6 / 3)


def test_the_launched_readings_need_no_fit(program):
    """The program's CUDA-event times drift from the trace's clock by 40%
    (as in a process's later profiler sessions, where no one offset puts
    them on the trace's clock): the readings are as before."""
    program(_records())
    expected = _read(_ctx())
    program(_records(drift=0.4))
    got = _read(_ctx())
    assert got == expected
    assert got["hyp_launched_gpu_ms_per_pair"] == pytest.approx(1000 / 1e6 / 3)
