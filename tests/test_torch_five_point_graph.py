"""The 5-point solver's CUDA graphs (estimation/five_point `_graphed`).

On the CPU: CPU inputs run the eager solver, bit for bit the frozen copy
of the solver before graphs (vobench/reference/five_point.py); the cache
key holds every input of the captured work; a capture that raises leaves
its signature to the eager solver; the cache keeps at most GRAPHS_KEPT
signatures, the least recently used evicted; the two spans open where
they should. The capture and the replay are stood in for by fakes there.

On the card (skipped without one): replays bit-equal to the eager solver
at the benchmark's batch sizes, outputs that no later replay overwrites,
one graph per TF32 setting, the bound, and a streamed run whose upload
thread runs across a first capture.
"""

import collections
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.estimation import five_point as t5
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.utils import profiling
from tpu_vo_torch.utils.synthetic import make_sequence
from vobench.reference import five_point as frozen

SAMPLES = 256


def _inputs(p, n=SAMPLES, dtype=torch.float32, seed=0, device="cpu"):
    """(x1, x2) (p, n, 5, 2): normalized coordinates of a small random
    motion, so that most samples have real roots."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-0.6, 0.6, (p, n, 5, 2))
    x2 = x1 + rng.normal(0.0, 0.02, (p, n, 5, 2)) + rng.uniform(-0.05, 0.05, (p, n, 1, 2))
    return (torch.as_tensor(x1, dtype=dtype, device=device),
            torch.as_tensor(x2, dtype=dtype, device=device))


def _equal(a, b):
    return all(torch.equal(x, y) and x.stride() == y.stride() for x, y in zip(a, b))


@pytest.fixture
def empty_cache(monkeypatch):
    """An empty graph cache for the test, the process's own restored after."""
    monkeypatch.setattr(t5, "_graphs", collections.OrderedDict())
    return t5._graphs


@pytest.fixture
def fake_graphs(monkeypatch, empty_cache):
    """_capture and _replay stood in for on the CPU: a capture returns a
    record of its signature, a replay the eager result; `log` lists the
    calls."""
    log = []

    def capture(x1, x2, dk_iters, root_method):
        log.append(("capture", tuple(x1.shape)))
        return SimpleNamespace(home=SimpleNamespace(wait_event=lambda ev: None), done=None)

    def replay(g, x1, x2):
        log.append(("replay", tuple(x1.shape)))
        return t5._solve(x1, x2)

    monkeypatch.setattr(t5, "_capture", capture)
    monkeypatch.setattr(t5, "_replay", replay)
    return log


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,dk_iters,method", [(torch.float32, 24, "aberth"),
                                                   (torch.float64, 100, "dk")])
def test_cpu_inputs_run_the_eager_solver_as_before(monkeypatch, dtype, dk_iters, method):
    def no_graph(*args):
        raise AssertionError("a CPU input reached the CUDA graph path")

    monkeypatch.setattr(t5, "_graphed", no_graph)
    x1, x2 = _inputs(3, 32, dtype)
    got = t5.five_point_candidates_batched(x1, x2, dk_iters=dk_iters, root_method=method)
    want = frozen.five_point_candidates_batched(x1, x2, dk_iters=dk_iters, root_method=method)
    assert got[1].any() and _equal(got, want)
    assert _equal(t5.five_point_candidates(x1[0, 0], x2[0, 0]),
                  frozen.five_point_candidates(x1[0, 0], x2[0, 0]))


def test_the_signature_holds_every_input_of_the_captured_work():
    x1, x2 = _inputs(2, 8)
    key = t5._signature(x1, x2, 24, "aberth")
    assert key == (tuple(x1.shape), x1.stride(), x1.dtype, x1.device,
                   tuple(x2.shape), x2.stride(), x2.dtype, x2.device, 24, "aberth",
                   torch.backends.cuda.matmul.allow_tf32)
    y1, y2 = _inputs(2, 8, seed=1)
    assert t5._signature(y1, y2, 24, "aberth") == key       # values are not in it
    t1 = x1.transpose(0, 1).contiguous().transpose(0, 1)     # same shape, other strides
    others = [t5._signature(_inputs(3, 8)[0], x2, 24, "aberth"),
              t5._signature(t1, x2, 24, "aberth"),
              t5._signature(x1.double(), x2.double(), 24, "aberth"),
              t5._signature(x1, x2, 100, "aberth"),
              t5._signature(x1, x2, 24, "dk")]
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not flag
        others.append(t5._signature(x1, x2, 24, "aberth"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert len({key, *others}) == len(others) + 1


def test_a_capture_that_raises_leaves_the_signature_to_the_eager_solver(monkeypatch,
                                                                       empty_cache):
    calls = []

    def failing(*args):
        calls.append(args)
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(t5, "_capture", failing)
    x1, x2 = _inputs(2, 16)
    with pytest.warns(UserWarning, match="capture failed"):
        first = t5._graphed(x1, x2, 24, "aberth")
    second = t5._graphed(x1, x2, 24, "aberth")
    assert len(calls) == 1 and list(empty_cache.values()) == [None]
    want = t5._solve(x1, x2)
    assert _equal(first, want) and _equal(second, want)


def test_the_cache_keeps_the_most_recently_used_signatures(fake_graphs, empty_cache):
    inputs = {p: _inputs(p, 4) for p in range(1, t5.GRAPHS_KEPT + 3)}
    for p in range(1, t5.GRAPHS_KEPT + 1):
        t5._graphed(*inputs[p], 24, "aberth")
    t5._graphed(*inputs[1], 24, "aberth")                   # 1 used again: 2 is the oldest
    for p in (t5.GRAPHS_KEPT + 1, t5.GRAPHS_KEPT + 2):
        t5._graphed(*inputs[p], 24, "aberth")
        assert len(empty_cache) == t5.GRAPHS_KEPT
    kept = sorted(key[0][0] for key in empty_cache)
    assert kept == [1] + list(range(4, t5.GRAPHS_KEPT + 3))
    captures = [s for kind, s in fake_graphs if kind == "capture"]
    assert len(captures) == t5.GRAPHS_KEPT + 2 and len(set(captures)) == len(captures)
    assert sum(kind == "replay" for kind, _ in fake_graphs) == t5.GRAPHS_KEPT + 3


def test_the_spans_of_a_capture_and_of_each_replay(monkeypatch, fake_graphs):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=profiling.SPAN_LIMIT))
    monkeypatch.setattr(profiling, "_first_call", [False])
    monkeypatch.setattr(profiling, "_calls", itertools.count())
    x1, x2 = _inputs(2, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span(profiling.CALL_SPAN):
            for _ in range(2):
                with profiling.span("ransac.hypotheses"):
                    t5._graphed(x1, x2, 24, "aberth")
    recs = profiling.spans()
    hyp = [r.id for r in recs if r.name == "ransac.hypotheses"]
    assert [(r.name, r.parent) for r in recs if r.name.startswith("five_point.")] == [
        ("five_point.capture", hyp[0]), ("five_point.replay", hyp[0]),
        ("five_point.replay", hyp[1])]


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p,dtype", [(1, torch.float32), (15, torch.float32),
                                     (127, torch.float32), (248, torch.float32),
                                     (15, torch.float64)])
def test_replays_equal_the_eager_solver(cuda, empty_cache, p, dtype):
    x1, x2 = _inputs(p, dtype=dtype, device=cuda)
    want = t5._solve(x1, x2)
    first = t5.five_point_candidates_batched(x1, x2)         # capture, then replay
    again = t5.five_point_candidates_batched(x1, x2)         # replay
    assert len(empty_cache) == 1 and None not in empty_cache.values()
    assert want[1].any() and _equal(first, want) and _equal(again, want)


@pytest.mark.cuda
def test_each_call_keeps_its_own_outputs(cuda, empty_cache):
    a, b = _inputs(15, device=cuda, seed=1), _inputs(15, device=cuda, seed=2)
    got_a = t5.five_point_candidates_batched(*a)
    got_b = t5.five_point_candidates_batched(*b)
    assert _equal(got_a, t5._solve(*a)) and _equal(got_b, t5._solve(*b))
    assert not torch.equal(got_a[0], got_b[0])


@pytest.mark.cuda
def test_each_tf32_setting_has_its_own_graph(cuda, empty_cache):
    x1, x2 = _inputs(15, device=cuda)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            assert _equal(t5.five_point_candidates_batched(x1, x2), t5._solve(x1, x2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert sorted(key[-1] for key in empty_cache) == [False, True]


@pytest.mark.cuda
def test_the_cache_holds_at_most_its_bound_on_the_card(cuda, empty_cache):
    for p in range(1, t5.GRAPHS_KEPT + 3):
        x1, x2 = _inputs(p, 16, device=cuda, seed=p)
        assert _equal(t5.five_point_candidates_batched(x1, x2), t5._solve(x1, x2))
        assert len(empty_cache) == min(p, t5.GRAPHS_KEPT)


@pytest.mark.cuda
def test_a_streamed_run_across_a_first_capture_equals_the_eager_run(cuda, empty_cache,
                                                                   monkeypatch):
    """The upload thread copies the second chunk while the first chunk's
    stage 2 captures its graph."""
    frames = np.stack(make_sequence(n_frames=8, width=160, height=120, seed=2)[0])
    cfg = VOConfig(image_width=160, image_height=120, orb=ORBConfig(n_features=100,
                                                                    n_levels=2))

    def run():
        return runner.run_sequence_streamed(iter([frames[:4], frames[4:]]), cfg, seed=5,
                                            prefetch_depth=2, device=cuda)

    poses, diags = run()
    assert len(empty_cache) >= 1 and None not in empty_cache.values()
    monkeypatch.setattr(t5, "_graphed", lambda x1, x2, it, method: t5._solve(x1, x2, it, method))
    eager_poses, eager_diags = run()
    assert torch.equal(poses.R, eager_poses.R) and torch.equal(poses.t, eager_poses.t)
    assert diags.keys() == eager_diags.keys()
    for k in diags:
        assert torch.equal(diags[k], eager_diags[k]), k
