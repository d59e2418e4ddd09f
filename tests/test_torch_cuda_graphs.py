"""The CUDA-graph cache (utils/cuda_graphs.GraphCache), each case run for
both of its callers: the 5-point solver (estimation/five_point
`_solve_graphs`) and the window LM (models/refinement `_refine_graphs`).

On the CPU: a CPU input never reaches the graph path; the signature
holds every input of the captured work; a capture that raises leaves its
signature to the eager body; the cache keeps at most `kept` signatures,
the least recently used evicted; the spans of a capture and of each
replay open where they should. The capture and the replay are stood in
for by fakes there.

On the card (skipped without one; `python3 -m pytest --noconftest
tests/test_torch_cuda_graphs.py` where JAX is absent): a first call made
inside a torch.profiler session captures, with no fallback, and its
replays equal the eager body and open no span.
"""

import collections
import contextlib
import itertools
import warnings
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_vo_torch.estimation import five_point as t5
from tpu_vo_torch.models import refinement as tref
from tpu_vo_torch.utils import profiling
from tpu_vo_torch.utils.cuda_graphs import GraphCache
from test_torch_five_point_graph import _inputs as _five_point_inputs
from test_torch_refine_graph import _inputs as _refine_inputs
from _torch_threads import _one_thread  # noqa: F401

# Each caller: its cache, its inputs (p pairs of n), the values of its
# other arguments, others that change the captured work, the spans its
# cache opens in, and the spans its eager body opens at those values.
CALLERS = {
    "five_point": SimpleNamespace(
        cache=t5._solve_graphs, inputs=_five_point_inputs, values=(24, "aberth"),
        other_values=[(100, "aberth"), (24, "dk")], outer=("ransac.hypotheses",),
        body_spans=[]),
    "refine": SimpleNamespace(
        cache=tref._refine_graphs, inputs=_refine_inputs, values=(6, 1e-3),
        other_values=[(0, 1e-3), (6, 1e-2)], outer=("vo.refine", "refine.lm"),
        body_spans=["lm.step"] * 6),
}


def _equal(a, b):
    return all(torch.equal(x, y) and x.stride() == y.stride() for x, y in zip(a, b))


@pytest.fixture(params=sorted(CALLERS))
def caller(request, monkeypatch):
    """One caller, its cache emptied for the test and restored after."""
    c = CALLERS[request.param]
    monkeypatch.setattr(c.cache, "graphs", collections.OrderedDict())
    return SimpleNamespace(**vars(c), body=c.cache.body, prefix=c.cache.prefix)


@pytest.fixture
def fake_graphs(monkeypatch, caller):
    """The cache's _capture and _replay stood in for on the CPU: a capture
    returns a record that holds the eager result, a replay returns that
    result without running the body; `log` lists the calls."""
    log = []

    def capture(device, args):
        log.append(("capture", tuple(args[0].shape)))
        return SimpleNamespace(home=SimpleNamespace(wait_event=lambda ev: None), done=None,
                               out=caller.body(*args))

    def replay(device, g, args):
        log.append(("replay", tuple(args[0].shape)))
        return g.out

    monkeypatch.setattr(caller.cache, "_capture", capture)
    monkeypatch.setattr(caller.cache, "_replay", replay)
    return log


@pytest.fixture
def fresh_spans(monkeypatch):
    """An empty record of spans, the process's first call already made."""
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=profiling.SPAN_LIMIT))
    monkeypatch.setattr(profiling, "_first_call", [False])
    monkeypatch.setattr(profiling, "_calls", itertools.count())


def _nested_spans(names):
    """The spans `names`, each opened inside the one before."""
    stack = contextlib.ExitStack()
    for name in names:
        stack.enter_context(profiling.span(name))
    return stack


def _other_layout(a):
    return a.transpose(0, 1).contiguous().transpose(0, 1)


def _other_dtype(a):
    return a.double() if a.dtype == torch.float32 else a.float()


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_a_cpu_input_never_reaches_the_graph_path(monkeypatch, fresh_spans):
    def body(x, k):
        return (x * k,)

    cache = GraphCache("toy", body)

    def no_graph(*args):
        raise AssertionError("a CPU input reached the CUDA graph path")

    for name in ("_graphed", "_capture", "_replay"):
        monkeypatch.setattr(cache, name, no_graph)
    x = torch.arange(6.0).reshape(2, 3)
    with profile(activities=[ProfilerActivity.CPU]):
        got = cache(x, 2.0)
    assert _equal(got, (x * 2.0,)) and not cache.graphs and not profiling.spans()


def test_the_signature_holds_every_input_of_the_captured_work(caller):
    args = caller.inputs(2, 8)
    key = caller.cache.signature(*args, *caller.values)
    assert key == (*((tuple(a.shape), a.stride(), a.dtype, a.device) for a in args),
                   *caller.values, torch.backends.cuda.matmul.allow_tf32)
    assert caller.cache.signature(*caller.inputs(2, 8, seed=1), *caller.values) == key
    others = [caller.cache.signature(*caller.inputs(3, 8), *caller.values),
              caller.cache.signature(*caller.inputs(2, 16), *caller.values),
              caller.cache.signature(*caller.inputs(2, 8, torch.float64), *caller.values)]
    others += [caller.cache.signature(*args, *values) for values in caller.other_values]
    for i, a in enumerate(args):       # each input alone in another layout, another dtype
        for other in (_other_layout(a), _other_dtype(a)):
            others.append(caller.cache.signature(*args[:i], other, *args[i + 1:],
                                                 *caller.values))
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not flag
        others.append(caller.cache.signature(*args, *caller.values))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert len({key, *others}) == len(others) + 1


def test_a_capture_that_raises_leaves_the_signature_to_the_eager_body(monkeypatch, caller,
                                                                      fresh_spans):
    calls = []

    def failing(*args):
        calls.append(args)
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(caller.cache, "_capture", failing)
    args = (*caller.inputs(2, 16), *caller.values)
    device = args[0].device
    with pytest.warns(UserWarning, match="capture failed"):
        first = caller.cache._graphed(device, args)
    with profile(activities=[ProfilerActivity.CPU]):
        second = caller.cache._graphed(device, args)
    assert len(calls) == 1 and list(caller.cache.graphs.values()) == [None]
    want = caller.body(*args)
    assert _equal(first, want) and _equal(second, want)
    # the fallback is the body, spans and all (the LM's lm.step an iteration)
    assert [s.name for s in profiling.spans()] == caller.body_spans


def test_the_cache_keeps_the_most_recently_used_signatures(caller, fake_graphs):
    cache, kept = caller.cache, caller.cache.kept
    inputs = {p: (*caller.inputs(p, 4), *caller.values) for p in range(1, kept + 3)}
    for p in range(1, kept + 1):
        cache._graphed(inputs[p][0].device, inputs[p])
    cache._graphed(inputs[1][0].device, inputs[1])          # 1 used again: 2 is the oldest
    for p in (kept + 1, kept + 2):
        cache._graphed(inputs[p][0].device, inputs[p])
        assert len(cache.graphs) == kept
    assert sorted(key[0][0][0] for key in cache.graphs) == [1] + list(range(4, kept + 3))
    captures = [s for kind, s in fake_graphs if kind == "capture"]
    assert len(captures) == kept + 2 and len(set(captures)) == len(captures)
    assert sum(kind == "replay" for kind, _ in fake_graphs) == kept + 3


def test_the_spans_of_a_capture_and_of_each_replay(caller, fake_graphs, fresh_spans):
    args = (*caller.inputs(2, 4), *caller.values)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span(profiling.CALL_SPAN):
            for _ in range(2):
                with _nested_spans(caller.outer):
                    got = caller.cache._graphed(args[0].device, args)
    assert _equal(got, caller.body(*args))
    recs = profiling.spans()
    inner = [r.id for r in recs if r.name == caller.outer[-1]]
    assert [(r.name, r.parent) for r in recs if r.name.startswith(caller.prefix + ".")
            and r.name not in caller.outer] == [
        (caller.prefix + ".capture", inner[0]), (caller.prefix + ".replay", inner[0]),
        (caller.prefix + ".replay", inner[1])]


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_first_call_inside_a_profiler_session_captures(cuda, caller, fresh_spans):
    args = (*caller.inputs(15, 256, device=cuda), *caller.values)
    want = caller.body(*args)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            with profiling.span(profiling.CALL_SPAN):
                got = [caller.cache(*args) for _ in range(3)]
            torch.cuda.synchronize()
    assert not [w for w in caught if "capture failed" in str(w.message)]
    assert len(caller.cache.graphs) == 1 and None not in caller.cache.graphs.values()
    assert all(_equal(g, want) for g in got)
    recs = profiling.spans()
    replays = {r.id for r in recs if r.name == caller.prefix + ".replay"}
    assert len(replays) == 3 and not [r for r in recs if r.parent in replays]
