"""The readers of the program's spans (vobench/metrics/_spans.py and the
five metrics that read them) on a hand-built trace: each metric's exact
value from known busy and idle overlaps, the device intervals fitted to
the trace where the host's stamps leave them loose, the stages' check,
and None where the program recorded no span."""

from types import SimpleNamespace

import pytest

from tpu_vo_torch.utils.profiling import Span
from vobench import harness
from vobench.metrics import _spans
from vobench.trace import Op, Summary

W0 = 1_760_000_000_000_000_000          # the window's start, ns on the host's clock
ROLES = {"runner.detect_frames": "stage1", "runner.estimate_pairs": "stage2",
         "runner.chain_relative_poses": "stage3"}
OPS = [(1000, 2000, "stage1"), (2500, 3000, "stage1"), (4000, 5000, "stage2"),
       (6000, 6500, "stage2"), (8000, 8200, "stage3")]
TRUE_OFFSET = 100                       # device time 0 of the call at W0 + 100
# name, id, parent, host (start, end), device (start, end) before the offset
SPANS = [("vo.call", 1, None, (50, 9000), (0, 8900)),
         ("vo.stage1", 2, 1, (900, 3100), (850, 3050)),
         ("orb.describe", 3, 2, (2400, 3050), (2350, 2950)),
         ("orb.pack", 4, 2, (3060, 3090), (2960, 2990)),
         ("vo.stage2", 5, 1, (3500, 6800), (3500, 6700)),
         ("ransac.hypotheses", 6, 5, (3900, 5050), (3850, 4950)),
         ("pair.residual", 7, 5, (5900, 6700), (5850, 6600)),
         ("vo.stage3", 8, 1, (7900, 8300), (7850, 8200))]
NAMES = ["stage2_idle_ms_per_call", "ransac_hyp_gpu_ms_per_pair", "describe_gpu_ms_per_frame",
         "stage3_host_ms_per_call", "warmup_call_s"]
WARMUP = Span("vo.call", 0, None, 0, W0 - 3_000_000_000, W0 - 500_000_000, None, None, None)


def _ctx(ops=True):
    role_span = {r: s for s, r in ROLES.items()}
    trace_ops = [Op(W0 + a, W0 + b, f"k{i}", role_span[r])
                 for i, (a, b, r) in enumerate(OPS)] if ops else []
    busy = sum(b - a for a, b, _ in OPS) if ops else 0
    summary = Summary(trace_ops, (W0, W0 + 10_000), busy, {}, [], [])
    return SimpleNamespace(trace=summary, calls=[(0.0, 1.0)], frames_per_call=4,
                           pairs_per_call=3, span_role=ROLES)


def _records(loosen=0, device=True):
    out = [WARMUP]
    for name, i, parent, (hs, he), (ds, de) in SPANS:
        dev = (0, float(ds), float(de)) if device else (None, None, None)
        out.append(Span(name, 100 + i, None if parent is None else 100 + parent, 7,
                        W0 + hs - loosen, W0 + he - loosen, *dev))
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
    # ransac.hypotheses on the device [3950, 5050] holds the op [4000, 5000]; 3 pairs
    assert got["ransac_hyp_gpu_ms_per_pair"] == pytest.approx(1000 / 1e6 / 3)
    # orb.describe on the device [2450, 3050] holds the op [2500, 3000]; 4 frames
    assert got["describe_gpu_ms_per_frame"] == pytest.approx(500 / 1e6 / 4)
    assert got["stage3_host_ms_per_call"] == pytest.approx(400 / 1e6)
    assert got["warmup_call_s"] == pytest.approx(2.5)
    assert _spans.view(ctx).offsets == {(7, 0): TRUE_OFFSET}


def test_loose_host_stamps_fit_the_offset_where_no_boundary_cuts_an_op(program):
    """With every host stamp 300 ns early the host allows an offset of
    -200, which cuts the ops; offsets 50 to 150 cut none, and the fit
    takes 50, the nearest: the device metrics read the same."""
    program(_records(loosen=300))
    ctx = _ctx()
    got = _read(ctx)
    assert _spans.view(ctx).offsets == {(7, 0): 50}
    assert got["ransac_hyp_gpu_ms_per_pair"] == pytest.approx(1000 / 1e6 / 3)
    assert got["describe_gpu_ms_per_frame"] == pytest.approx(500 / 1e6 / 4)


def test_a_call_that_fits_nowhere_is_left_out_of_the_device_metrics(program, monkeypatch):
    """A second call whose ransac.hypotheses boundaries fall inside an
    operation at every offset the fit looks at: only the first call's
    device intervals count, per call that fits."""
    monkeypatch.setattr(_spans, "SEARCH_NS", 150)
    monkeypatch.setattr(_spans, "CUT_NS", 10)
    bad = [Span("vo.call", 300, None, 8, W0 + 60, W0 + 9000, 0, 0.0, 8900.0),
           Span("ransac.hypotheses", 301, 300, 8, W0 + 4350, W0 + 4650, 0, 4300.0, 4600.0)]
    program(_records() + bad)
    ctx = _ctx()
    v = _spans.view(ctx)
    assert set(v.offsets) == {(7, 0)} and set(v.misfits) == {(8, 0)}
    assert v.fitted_calls == 1
    assert _read(ctx)["ransac_hyp_gpu_ms_per_pair"] == pytest.approx(1000 / 1e6 / 3)


def test_the_stage_check_sums_the_children(program):
    program(_records())
    sums = {s["role"]: s for s in _spans.stage_sums(_ctx())}
    assert sums["stage1"]["harness_ms"] == pytest.approx(1500 / 1e6)
    assert sums["stage1"]["span_ms"] == pytest.approx(1500 / 1e6)
    assert sums["stage1"]["children"] == {"orb.describe": pytest.approx(500 / 1e6),
                                          "orb.pack": 0.0}
    assert sums["stage2"]["harness_ms"] == sums["stage2"]["span_ms"] == pytest.approx(1.5e-3)
    assert sums["stage2"]["children_ms"] == pytest.approx(1.5e-3)


def test_none_without_spans_and_device_metrics_none_without_device_ops(program):
    program([])
    assert _read(_ctx()) == {n: None for n in NAMES}
    program([WARMUP])                       # nothing inside the window
    assert _read(_ctx()) == {n: None for n in NAMES}
    program(_records(device=False))         # a run on the CPU
    got = _read(_ctx(ops=False))
    assert got["stage2_idle_ms_per_call"] is None
    assert got["ransac_hyp_gpu_ms_per_pair"] is None and got["describe_gpu_ms_per_frame"] is None
    assert got["stage3_host_ms_per_call"] == pytest.approx(400 / 1e6)
    assert got["warmup_call_s"] == pytest.approx(2.5)


def test_a_program_without_spans_gives_none(monkeypatch):
    from tpu_vo_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert _spans._program_spans() == []
    assert _read(_ctx()) == {n: None for n in NAMES}
