"""The LM refinement's CUDA graphs (models/refinement `_refine_graphs`, a
utils/cuda_graphs.GraphCache; the cache's own cases, for both of its
callers, are in tests/test_torch_cuda_graphs.py).

On the CPU: CPU inputs run the eager loop, bit for bit the loop as it
was before graphs (`_loop_before_graphs` below); the benchmark's
refine_graph_hit_pct reads the replays.

On the card (skipped without one; `python3 -m pytest --noconftest
tests/test_torch_refine_graph.py` where JAX is absent): replays bit-equal
to the eager loop at 1 and 31 pairs, outputs that no later replay
overwrites, one graph per iteration count and per TF32 setting, the
bound, no wait for the card in a replayed refine_pairs, and a refined
32-frame VGA run equal to its eager run.
"""

import collections

import numpy as np
import pytest
import torch

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.models import refinement as tref
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.utils.profiling import Span
from tpu_vo_torch.utils.synthetic import make_sequence
from vobench import harness
from vobench.tests.test_vobench_spans import W0, _ctx
from _torch_threads import _one_thread  # noqa: F401

hit_pct = harness._reader("metrics", "refine_graph_hit_pct")


def _so3(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _inputs(p, n=64, dtype=torch.float32, seed=0, device="cpu"):
    """(x1, x2, mask, R0, t0): p noisy two-view pairs of n normalized
    correspondences, a fifth off the mask, starts perturbed from the
    truth."""
    rng = np.random.default_rng(seed)
    x1s, x2s, R0s, t0s = [], [], [], []
    for _ in range(p):
        R = _so3(rng.normal(size=3) * 0.05)
        t = np.array([0.1, 0.0, 1.0]) + rng.normal(size=3) * 0.1
        X = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(3, 20, (n, 1))], -1)
        Xc = X @ R.T + t / np.linalg.norm(t)
        x1s.append(X[:, :2] / X[:, 2:] + rng.normal(0, 2e-3, (n, 2)))
        x2s.append(Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 2e-3, (n, 2)))
        R0s.append(_so3(rng.normal(size=3) * 0.01) @ R)
        t0 = t + rng.normal(size=3) * 0.05
        t0s.append(t0 / np.linalg.norm(t0))
    mask = torch.from_numpy(rng.random((p, n)) > 0.2).to(device)
    return (*(torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
              for a in (x1s, x2s)), mask,
            *(torch.as_tensor(np.asarray(a), dtype=dtype, device=device) for a in (R0s, t0s)))


def _loop_before_graphs(x1, x2, mask, R0, t0, iters, lambda0=1e-3):
    """refine_relative_pose_lm's batched body as it stood before the
    graphs, without its spans: the reference of the eager path."""
    dtype = x1.dtype
    n_inl = torch.clamp(mask.sum(-1), min=1).to(dtype)
    args = (x1, x2, mask.to(dtype), R0, t0)

    def cost_of(p):
        r = tref._residuals(p, *args)
        return (r * r).sum(-1) / n_inl

    p = torch.zeros(x1.shape[0], 6, dtype=dtype, device=x1.device)
    c0 = cost_of(p)
    c = c0
    lam = torch.full_like(c0, lambda0)
    for _ in range(iters):
        r, J = tref._residuals_and_jacobian(p, *args)
        JtJ = J.transpose(-1, -2) @ J
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        A = JtJ + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(JtJ, dim1=-2, dim2=-1) + 1e-12)
        step, info = torch.linalg.solve_ex(A, g)
        p_new = p - step
        c_new = cost_of(p_new)
        accept = (c_new < c) & torch.isfinite(p_new).all(-1) & (info == 0)
        p = torch.where(accept[:, None], p_new, p)
        c = torch.where(accept, c_new, c)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 4.0), 1e-9, 1e6)
    R, t = tref._motion(p, R0, t0)
    improved = c < c0
    return (torch.where(improved[:, None, None], R, R0), torch.where(improved[:, None], t, t0),
            torch.minimum(c, c0), improved)


def _equal(a, b):
    return all(torch.equal(x, y) and x.stride() == y.stride() for x, y in zip(a, b))


@pytest.fixture
def empty_cache(monkeypatch):
    """An empty graph cache for the test, the process's own restored after."""
    monkeypatch.setattr(tref._refine_graphs, "graphs", collections.OrderedDict())
    return tref._refine_graphs.graphs


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("iters", [0, 6])
def test_cpu_inputs_run_the_eager_loop_as_before(monkeypatch, dtype, iters):
    def no_graph(*args):
        raise AssertionError("a CPU input reached the CUDA graph path")

    monkeypatch.setattr(tref._refine_graphs, "_graphed", no_graph)
    args = _inputs(4, dtype=dtype)
    want = _loop_before_graphs(*args, iters)
    got = tref.refine_window(*args, iters=iters)
    assert got.R_rel.dtype == dtype and _equal(got, want)
    assert bool(got.improved.any()) == (iters > 0)
    one = tref.refine_relative_pose_lm(*(a[1] for a in args), iters=iters, lambda0=1e-2)
    assert _equal(one, (v[0] for v in _loop_before_graphs(*(a[1:2] for a in args), iters,
                                                          1e-2)))


def test_the_graph_hit_share_reads_the_replays(monkeypatch):
    from vobench.metrics import _spans

    def call(i, replay):
        """One call's vo.refine > refine.lm (> refine.replay) at W0 + 1000 i."""
        b, base = W0 + 1000 * i, 10 * i
        out = [Span("vo.refine", base + 1, None, i, b + 100, b + 900),
               Span("refine.lm", base + 2, base + 1, i, b + 200, b + 800)]
        if replay:
            out.append(Span("refine.replay", base + 3, base + 2, i, b + 300, b + 700))
        return out

    capture = Span("refine.capture", 0, None, 0, W0 - 2_000_000, W0 - 1_000_000)
    cases = [([capture] + call(1, True) + call(2, True), 100.0),
             ([capture] + call(1, True) + call(2, False), 50.0),
             ([capture] + call(1, False) + call(2, False), 0.0),     # every call eager
             (call(1, False) + call(2, False), None),                 # a program without graphs
             ([capture], None)]                                       # no vo.refine in the window
    for records, want in cases:
        monkeypatch.setattr(_spans, "_program_spans", lambda: records)
        assert hit_pct(_ctx()) == want


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 31])
def test_replays_equal_the_eager_loop(cuda, empty_cache, p):
    args = _inputs(p, 1000, device=cuda, seed=p)
    want = tref._refine(*args, 6)
    first = tref.refine_window(*args, iters=6)         # capture, then replay
    again = tref.refine_window(*args, iters=6)         # replay
    assert len(empty_cache) == 1 and None not in empty_cache.values()
    assert want[3].any() and _equal(first, want) and _equal(again, want)


@pytest.mark.cuda
def test_each_call_keeps_its_own_outputs(cuda, empty_cache):
    a, b = _inputs(31, 256, device=cuda, seed=1), _inputs(31, 256, device=cuda, seed=2)
    got_a = tref.refine_window(*a, iters=6)
    got_b = tref.refine_window(*b, iters=6)
    assert _equal(got_a, tref._refine(*a, 6)) and _equal(got_b, tref._refine(*b, 6))
    assert not torch.equal(got_a.R_rel, got_b.R_rel)


@pytest.mark.cuda
def test_each_iteration_count_and_tf32_setting_has_its_own_graph(cuda, empty_cache):
    args = _inputs(31, 256, device=cuda)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            for iters in (0, 6):
                assert _equal(tref.refine_window(*args, iters=iters), tref._refine(*args, iters))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert sorted((key[-3], key[-1]) for key in empty_cache) == [
        (0, False), (0, True), (6, False), (6, True)]
    assert None not in empty_cache.values()


@pytest.mark.cuda
def test_the_cache_holds_at_most_its_bound_on_the_card(cuda, empty_cache):
    kept = tref._refine_graphs.kept
    for p in range(1, kept + 3):
        args = _inputs(p, 64, device=cuda, seed=p)
        assert _equal(tref.refine_window(*args, iters=2), tref._refine(*args, 2))
        assert len(empty_cache) == min(p, kept)


@pytest.fixture(scope="module")
def vga_run():
    """A refined 32-frame VGA run on the card through run_sequence_batched
    (config 5's sizes), and the arguments its refine_pairs was given."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    frames = torch.from_numpy(np.stack(make_sequence(n_frames=32, width=640, height=480,
                                                     seed=4)[0]))
    cfg = VOConfig(image_width=640, image_height=480, orb=ORBConfig(n_features=1000))
    kept = []
    refine_pairs = runner.refine_pairs

    def keep(*args):
        kept.append(args)
        return refine_pairs(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, "refine_pairs", keep)
        out = runner.run_sequence_batched(frames, cfg, seed=9, device="cuda", refine_iters=6)
    return frames, cfg, out, kept[0]


@pytest.mark.cuda
def test_a_replayed_refine_pairs_never_waits_for_the_card(cuda, vga_run):
    args = vga_run[3]
    runner.refine_pairs(*args)                       # the signature's graph exists
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [runner.refine_pairs(*args) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    key = tref._refine_graphs.signature(*runner.refine_inputs(*args[:4]), args[4], 1e-3)
    assert tref._refine_graphs.graphs.get(key) is not None
    want = tref._refine(*runner.refine_inputs(*args[:4]), args[4])
    assert all(_equal(o, want) for o in outs)


@pytest.mark.cuda
def test_a_refined_vga_run_equals_its_eager_run(cuda, vga_run, monkeypatch):
    frames, cfg, (poses, diags), _ = vga_run
    assert bool(diags["refine_improved"].any())
    monkeypatch.setattr(tref._refine_graphs, "_graphed", lambda device, args: tref._refine(*args))
    eager_poses, eager_diags = runner.run_sequence_batched(frames, cfg, seed=9, device="cuda",
                                                           refine_iters=6)
    assert torch.equal(poses.R, eager_poses.R) and torch.equal(poses.t, eager_poses.t)
    assert diags.keys() == eager_diags.keys()
    for k in diags:
        assert torch.equal(diags[k], eager_diags[k]), k
