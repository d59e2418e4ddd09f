"""The program's spans (tpu_vo_torch.utils.profiling.span): nothing
recorded, and no record_function entered, with no profiler; under a
torch.profiler session every layer boundary of the batched entries
recorded once a call, with its parent and its call's number, its host
start and end inside the profiler's own event of the same name (the two
share a clock); the record bounded and cleared; the process's first call
recorded on the host without a profiler, the next not; the same outputs
with tracing on and off; RANSAC's phases in spans where its `mark` hook
was."""

import collections
import inspect
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_vo_torch.api import Frame, VisualOdometry
from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.estimation import ransac
from tpu_vo_torch.parallel import sharding
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.utils import profiling
from tpu_vo_torch.utils.synthetic import make_sequence
from _torch_threads import _one_thread  # noqa: F401

W, H = 160, 120
CFG = VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=100, n_levels=2))
STAGE1 = ["orb.pyramid", "orb.select", "orb.windows", "orb.describe", "orb.pack"]
STAGE2 = ["pair.match", "pair.prep", "ransac.draw", "ransac.hypotheses", "ransac.prescreen",
          "ransac.fullscore", "ransac.refit", "pair.pose", "pair.residual"]
BATCHED = {"vo.call": None, "vo.upload": "vo.call", "vo.stage1": "vo.call",
           "vo.seeds": "vo.call", "vo.stage2": "vo.call", "vo.stage3": "vo.call",
           **{n: "vo.stage1" for n in STAGE1}, **{n: "vo.stage2" for n in STAGE2}}


@pytest.fixture(scope="module")
def frames():
    return torch.from_numpy(np.stack(make_sequence(n_frames=4, width=W, height=H,
                                                   seed=2)[0]))


@pytest.fixture
def fresh(monkeypatch):
    """An empty record, the first call already made, numbering from 0."""
    monkeypatch.setattr(profiling, "_records",
                        collections.deque(maxlen=profiling.SPAN_LIMIT))
    monkeypatch.setattr(profiling, "_first_call", [False])
    monkeypatch.setattr(profiling, "_calls", itertools.count())
    return profiling


def _run(frames):
    return runner.run_sequence_batched(frames, CFG, seed=5, device="cpu")


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def _same(a, b):
    (pa, da), (pb, db) = a, b
    assert torch.equal(pa.R, pb.R) and torch.equal(pa.t, pb.t)
    assert da.keys() == db.keys() and all(torch.equal(da[k], db[k]) for k in da)


def test_off_records_nothing_and_enters_no_record_function(fresh, frames, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    _run(frames)
    assert profiling.spans() == [] and entered == []
    assert profiling.span("vo.stage1") is profiling.span("orb.pack") is profiling._NULL
    assert profiling.span(profiling.CALL_SPAN) is profiling._NULL


@pytest.mark.parametrize("entry", ["run_sequence_batched", "run_batch_of_sequences"])
def test_profiled_calls_record_every_boundary_with_parent_and_call(fresh, frames, entry):
    if entry == "run_sequence_batched":
        def call():
            return _run(frames)
    else:
        def call():
            return sharding.run_batch_of_sequences(torch.stack([frames, frames.flip(0)]), CFG,
                                                   seed=5, device="cpu")
    _profiled(lambda: (call(), call()))
    got = profiling.spans()
    assert sorted(s.name for s in got) == sorted(list(BATCHED) * 2)
    by_id = {s.id: s for s in got}
    calls = [s for s in got if s.name == "vo.call"]
    assert sorted(c.call for c in calls) == [0, 1] and all(c.parent is None for c in calls)
    for s in got:
        parent = by_id.get(s.parent)
        assert (parent.name if parent else None) == BATCHED[s.name], s
        assert s.call == (parent.call if parent else s.call) and s.call in (0, 1)
        assert s.start_ns <= s.end_ns and s.device is None and s.dev_start is None
        if parent:
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns


def test_host_times_lie_inside_the_profilers_events(fresh, frames):
    _, events = _profiled(lambda: _run(frames))
    names = set(BATCHED)
    prof = collections.defaultdict(list)
    for e in events:
        if e.name() in names and e.device_type().name == "CPU":
            prof[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    got = collections.defaultdict(list)
    for s in profiling.spans():
        got[s.name].append((s.start_ns, s.end_ns))
    assert set(got) == names == set(prof)
    for name in names:
        assert len(got[name]) == len(prof[name]) == 1
        (a, b), (s, e) = prof[name][0], got[name][0]
        assert a <= s <= e <= b, name


def test_the_record_is_bounded_and_reset_clears_it(fresh):
    assert profiling._records.maxlen == profiling.SPAN_LIMIT
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(profiling.SPAN_LIMIT + 3):
            with profiling.span("kernels.load"):
                pass
        with profiling.span("vo.seeds"):
            pass
    got = profiling.spans()
    assert len(got) == profiling.SPAN_LIMIT and got[-1].name == "vo.seeds"
    assert got[0].id == got[-1].id - profiling.SPAN_LIMIT + 1
    profiling.reset_spans()
    assert profiling.spans() == []


def test_the_first_call_is_recorded_on_the_host_and_the_second_is_not(fresh, frames,
                                                                        monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    monkeypatch.setattr(profiling, "_first_call", [True])
    first = _run(frames)
    got = profiling.spans()
    assert sorted(s.name for s in got) == sorted(BATCHED) and entered == []
    assert {s.call for s in got} == {0}
    assert all(s.device is None and s.dev_start is None for s in got)
    second = _run(frames)
    assert len(profiling.spans()) == len(got)
    _same(first, second)


def test_outputs_are_the_same_traced_and_not(fresh, frames):
    off = _run(frames)
    on, _ = _profiled(lambda: _run(frames))
    _same(off, on)
    assert len(profiling.spans()) == len(BATCHED)


def test_a_nested_entry_opens_no_second_call(fresh, frames):
    def nested():
        with profiling.span(profiling.CALL_SPAN):
            return _run(frames)
    _profiled(nested)
    assert [s.name for s in profiling.spans()].count("vo.call") == 1


def test_process_frame_is_one_call_a_frame(fresh, frames):
    vo = VisualOdometry(W, H, config=CFG, device="cpu")
    _profiled(lambda: [vo.process_frame(Frame.from_image(i, f.numpy())) for i, f in
                       enumerate(frames[:2])])
    got = profiling.spans()
    names = collections.Counter(s.name for s in got)
    assert names["vo.call"] == 2 and names["vo.upload"] == 2 and names["vo.seeds"] == 2
    assert all(names[n] == 2 for n in STAGE1 + STAGE2)
    assert {s.call for s in got} == {0, 1}


def test_ransac_phases_are_spans_not_a_mark_hook():
    assert list(inspect.signature(ransac.Phases.run).parameters) == ["self", "idx"]
    assert not hasattr(ransac, "_no_mark")
