"""The port's utils/profiling against tpu_vo's: StageTimer.report gives
the same string for the same totals, benchmark the same keys; trace
writes a Chrome trace with a directory (given or $TPU_VO_TRACE_DIR),
nothing without one, and lets an exception raised in its body through
unchanged (tpu_vo's trace turns it into contextlib's RuntimeError when
a directory is set)."""

import json
import os

import pytest
import torch

from tpu_vo.utils import profiling as jprofiling
from tpu_vo_torch.utils import profiling
from _torch_threads import _one_thread  # noqa: F401


def test_stage_timer_report_equals_tpu_vo():
    totals = {"features": 0.123456, "matching": 0.5, "ransac": 1.75e-4, "io": 2.0}
    counts = {"features": 3, "matching": 7, "ransac": 1, "io": 4}
    port, ref = profiling.StageTimer(), jprofiling.StageTimer()
    for t in (port, ref):
        t.totals, t.counts = dict(totals), dict(counts)
    assert port.report() == ref.report()
    assert port.report().splitlines()[0].startswith("io ")


def test_stage_timer_accumulates():
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("a"):
            timer.sync(torch.ones(2))
    with timer.stage("b"):
        pass
    assert timer.counts == {"a": 3, "b": 1}
    assert all(v >= 0.0 for v in timer.totals.values())
    assert "ms/call x 3" in timer.report()


def test_benchmark_keys_equal_tpu_vo():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x + 1}

    got = profiling.benchmark(fn, torch.zeros(3), repeats=2, warmup=3)
    assert set(got) == {"first_call_s", "steady_s"} == set(
        jprofiling.benchmark(lambda: 0, repeats=1, warmup=1))
    assert len(calls) == 1 + 2 + 2 and min(got.values()) >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_VO_TRACE_DIR", raising=False)
    d = tmp_path / "given"
    with profiling.trace(str(d)):
        torch.ones(64).sum()
    (name,) = os.listdir(d)
    with open(d / name) as f:
        assert "traceEvents" in json.load(f)
    env_dir = tmp_path / "env"
    monkeypatch.setenv("TPU_VO_TRACE_DIR", str(env_dir))
    with profiling.trace():
        torch.ones(8).sum()
    assert len(os.listdir(env_dir)) == 1


def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_VO_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace():
        torch.ones(8).sum()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("with_dir", [False, True])
def test_trace_lets_exceptions_through(tmp_path, monkeypatch, with_dir):
    monkeypatch.delenv("TPU_VO_TRACE_DIR", raising=False)
    err = KeyError("from the body")
    with pytest.raises(KeyError) as info:
        with profiling.trace(str(tmp_path / "t") if with_dir else None):
            raise err
    assert info.value is err
