"""The 5-point solver's CUDA graphs (estimation/five_point `_solve_graphs`,
a utils/cuda_graphs.GraphCache; the cache's own cases, for both of its
callers, are in tests/test_torch_cuda_graphs.py).

On the CPU: CPU inputs run the eager solver, bit for bit the frozen copy
of the solver before graphs (vobench/reference/five_point.py).

On the card (skipped without one): replays bit-equal to the eager solver
at the benchmark's batch sizes, outputs that no later replay overwrites,
one graph per TF32 setting, the bound, and a streamed run whose upload
thread runs across a first capture.
"""

import collections

import numpy as np
import pytest
import torch

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.estimation import five_point as t5
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.utils.synthetic import make_sequence
from vobench.reference import five_point as frozen
from _torch_threads import _one_thread  # noqa: F401

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
    monkeypatch.setattr(t5._solve_graphs, "graphs", collections.OrderedDict())
    return t5._solve_graphs.graphs


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,dk_iters,method", [(torch.float32, 24, "aberth"),
                                                   (torch.float64, 100, "dk")])
def test_cpu_inputs_run_the_eager_solver_as_before(monkeypatch, dtype, dk_iters, method):
    def no_graph(*args):
        raise AssertionError("a CPU input reached the CUDA graph path")

    monkeypatch.setattr(t5._solve_graphs, "_graphed", no_graph)
    x1, x2 = _inputs(3, 32, dtype)
    got = t5.five_point_candidates_batched(x1, x2, dk_iters=dk_iters, root_method=method)
    want = frozen.five_point_candidates_batched(x1, x2, dk_iters=dk_iters, root_method=method)
    assert got[1].any() and _equal(got, want)
    assert _equal(t5.five_point_candidates(x1[0, 0], x2[0, 0]),
                  frozen.five_point_candidates(x1[0, 0], x2[0, 0]))


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
    kept = t5._solve_graphs.kept
    for p in range(1, kept + 3):
        x1, x2 = _inputs(p, 16, device=cuda, seed=p)
        assert _equal(t5.five_point_candidates_batched(x1, x2), t5._solve(x1, x2))
        assert len(empty_cache) == min(p, kept)


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
    monkeypatch.setattr(t5._solve_graphs, "_graphed", lambda device, args: t5._solve(*args))
    eager_poses, eager_diags = run()
    assert torch.equal(poses.R, eager_poses.R) and torch.equal(poses.t, eager_poses.t)
    assert diags.keys() == eager_diags.keys()
    for k in diags:
        assert torch.equal(diags[k], eager_diags[k]), k
