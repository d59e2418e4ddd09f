"""estimation/solve: stage 2's SVDs and eigendecompositions, torch.linalg's
results without a wait for the card.

On the CPU: CPU tensors, and every shape torch does not send to
cuSOLVER's batched routines, get torch.linalg's result; the route
rests on device, dtype, shape and grad alone; the module imports, and
loads no library, without a card; solve.jacobi spans open only on the
card's route; the callers (the gate's and the pose's decompose_essential,
the refit's fit_fundamental_linear and project_to_essential) call it;
the benchmark's reader jacobi_solves_per_call counts the spans a call.

On the card: svd and eigh equal torch.linalg bit for bit, strides too, on
the gate, refit and pose inputs of one call of every benchmark cell and
on crafted matrices (rank 2, zero, repeated singular values, invalid
5-point candidates), with no matrix left unconverged; a seq128 call and a
parity-preset call equal the same call on torch.linalg, and make no
wait for the card inside vo.stage2. This file imports no JAX, so its card
cases run where JAX is missing:

    python3 -m pytest --noconftest tests/test_torch_solve.py -p no:cacheprovider
"""

import collections
import itertools
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_vo_torch.configs as prog_configs
from tpu_vo_torch.estimation import eight_point, five_point, ransac, recover_pose, solve
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.utils import profiling
from tpu_vo_torch.utils.profiling import Span
from vobench import harness
from vobench.metrics import _spans, jacobi_solves_per_call
from vobench.tests.test_vobench_spans import W0, WARMUP, _ctx
from vobench.trace import SYNC_CALLS
from _torch_threads import _one_thread  # noqa: F401

SEED = 2 ** 31 + 7
CELLS = ["kitti_orb1200.seq128", "kitti_orb1200.fleet8x32", "uhd_orb8000.seq16",
         "vga_orb1000_lm.seq32", "kitti_orb1200_parity.seq128"]


def _fake(shape, device="cuda", dtype=torch.float32, requires_grad=False):
    """What the route reads of a tensor, without a card."""
    return SimpleNamespace(shape=torch.Size(shape), device=torch.device(device), dtype=dtype,
                           requires_grad=requires_grad)


def _random(shape, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device)


def _same(got, want):
    """Equal outputs, bit for bit, in equal shapes, dtypes and strides."""
    assert type(got) is type(want) and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.stride() == w.stride()
        assert torch.equal(g, w)


@pytest.fixture
def fresh(monkeypatch):
    """An empty record of spans, the process's first call already made."""
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=profiling.SPAN_LIMIT))
    monkeypatch.setattr(profiling, "_first_call", [False])
    monkeypatch.setattr(profiling, "_calls", itertools.count())


# ---------------------------------------------------------------------------
# The CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3), (5, 16, 3, 3), (7, 3, 3), (2, 4, 6), (40, 40)])
def test_cpu_svd_is_torch_linalg(shape):
    A = _random(shape, 1)
    _same(solve.svd(A), torch.linalg.svd(A))


@pytest.mark.parametrize("shape", [(9, 9), (1, 9, 9), (7, 9, 9), (3, 2, 4, 4)])
def test_cpu_eigh_is_torch_linalg(shape):
    B = _random(shape, 2)
    A = B.mT @ B
    _same(solve.eigh(A), torch.linalg.eigh(A))


@pytest.mark.parametrize("fn, args, want", [
    (solve.svd_routed, ((127, 16, 3, 3),), True),
    (solve.svd_routed, ((3, 3),), True),
    (solve.svd_routed, ((5, 32, 20),), True),
    (solve.svd_routed, ((5, 3, 3), "cuda", torch.float64), True),
    (solve.svd_routed, ((5, 33, 3),), False),
    (solve.svd_routed, ((0, 3, 3),), False),
    (solve.svd_routed, ((5, 3, 3), "cpu"), False),
    (solve.svd_routed, ((5, 3, 3), "cuda", torch.float16), False),
    (solve.svd_routed, ((5, 3, 3), "cuda", torch.complex64), False),
    (solve.svd_routed, ((5, 3, 3), "cuda", torch.float32, True), False),
    (solve.eigh_routed, ((127, 9, 9),), True),
    (solve.eigh_routed, ((2, 32, 32),), True),
    (solve.eigh_routed, ((1, 9, 9),), False),
    (solve.eigh_routed, ((9, 9),), False),
    (solve.eigh_routed, ((1, 1, 9, 9),), False),
    (solve.eigh_routed, ((4, 33, 33),), False),
    (solve.eigh_routed, ((4, 9, 9), "cpu"), False),
    (solve.eigh_routed, ((4, 9, 9), "cuda", torch.bfloat16), False),
])
def test_the_route_rests_on_device_dtype_shape_and_grad(fn, args, want):
    assert fn(_fake(*args)) is want


def test_the_module_imports_and_loads_nothing_without_a_card(monkeypatch):
    """Imported afresh with ctypes.CDLL refused, the CPU route of every
    caller runs, and no library, handle or counter is made."""
    import ctypes
    import importlib

    def refuse(*a, **k):
        raise AssertionError("a library was loaded")

    monkeypatch.setattr(ctypes, "CDLL", refuse)
    fresh_solve = importlib.reload(solve)
    try:
        monkeypatch.setattr(eight_point, "solve", fresh_solve)
        monkeypatch.setattr(recover_pose, "solve", fresh_solve)
        x1, x2 = _random((6, 40, 2), 3), _random((6, 40, 2), 4)
        mask = torch.ones(6, 40, dtype=torch.bool)
        E = eight_point.estimate_essential_8pt(x1, x2, mask)
        recover_pose.decompose_essential(E)
        assert fresh_solve._library.cache_info().currsize == 0
        assert fresh_solve._handle.cache_info().currsize == 0
        assert fresh_solve._counters == {} and fresh_solve.nonconverged("cpu") == 0
    finally:
        monkeypatch.undo()
        importlib.reload(solve)


def test_jacobi_spans_open_only_on_the_cards_route(fresh, monkeypatch):
    A, B = _random((4, 3, 3), 5), _random((4, 9, 9), 6)
    with profile(activities=[ProfilerActivity.CPU]):
        solve.svd(A)
        solve.eigh(B.mT @ B)
    assert not [s for s in profiling.spans() if s.name == "solve.jacobi"]
    # the card's route, its routines played by torch.linalg
    monkeypatch.setattr(solve, "_routed", lambda A, max_dim, min_batch: True)
    monkeypatch.setattr(solve, "_gesvdj_batched", torch.linalg.svd)
    monkeypatch.setattr(solve, "_xsyev_batched", torch.linalg.eigh)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("ransac.refit"):
            solve.svd(A)
            solve.eigh(B.mT @ B)
    got = profiling.spans()
    outer = next(s for s in got if s.name == "ransac.refit")
    jacobi = [s for s in got if s.name == "solve.jacobi"]
    assert len(jacobi) == 2 and all(s.parent == outer.id for s in jacobi)


def test_every_stage2_decomposition_goes_through_the_module(monkeypatch):
    """A gated CPU call: the gate's and the pose's SVDs, the refit's eigh
    and SVD, in that order, one call each."""
    calls = []
    real_svd, real_eigh = solve.svd, solve.eigh
    monkeypatch.setattr(solve, "svd", lambda A: calls.append(("svd", tuple(A.shape)))
                        or real_svd(A))
    monkeypatch.setattr(solve, "eigh", lambda A: calls.append(("eigh", tuple(A.shape)))
                        or real_eigh(A))
    cell = harness.load_cell("kitti_orb1200.seq128", dict(
        image_width=160, image_height=120, n_features=200, n_levels=2, max_iters=16,
        call_shape=[3], pool=1))
    frames = harness.make_pool(cell, SEED, torch.device("cpu"))[0]
    runner.run_sequence_batched(frames, harness.vo_config(cell.config, prog_configs), 3,
                                device="cpu")
    assert calls == [("svd", (2, ransac.FINALISTS, 3, 3)), ("eigh", (2, 9, 9)),
                     ("svd", (2, 3, 3)), ("svd", (2, 3, 3))]


def _jacobi_spans(i, n):
    """Call i's vo.stage2 at W0 + 1000 i holding n solve.jacobi spans."""
    b, base = W0 + 1000 * i, 100 * i
    out = [Span("vo.stage2", base + 1, None, i, b + 100, b + 900)]
    out += [Span("solve.jacobi", base + 2 + k, base + 1, i, b + 200 + 10 * k, b + 205 + 10 * k)
            for k in range(n)]
    return out


@pytest.mark.parametrize("records, want", [
    ([WARMUP] + _jacobi_spans(1, 4), 4.0),
    ([WARMUP] + _jacobi_spans(1, 3), 3.0),
    ([WARMUP] + _jacobi_spans(1, 0), None),      # a program without the module's route
    ([WARMUP], None),                            # no span in the window
    ([], None),                                  # a program without spans
])
def test_the_reader_counts_the_jacobi_spans_a_call(monkeypatch, records, want):
    monkeypatch.setattr(_spans, "_program_spans", lambda: records)
    monkeypatch.setattr(_spans, "_last", [None, None])
    assert jacobi_solves_per_call.read(_ctx()) == want


def test_the_reader_is_none_without_a_trace():
    assert jacobi_solves_per_call.read(SimpleNamespace(trace=None, calls=[(0.0, 1.0)])) is None


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuSOLVER's batched routines have no CPU mode")
    return torch.device("cuda")


def _cell_call(workload, device):
    """(entry, frames, cfg, kwargs) of one call of the cell `workload`."""
    cell = harness.load_cell(workload, {"pool": 1})
    module = __import__(cell.traffic["entry"]["module"], fromlist=["_"])
    entry = getattr(module, cell.traffic["entry"]["function"])
    kwargs, _ = harness.entry_kwargs(cell, device)
    frames = harness.make_pool(cell, SEED, device)[0]
    return entry, frames, harness.vo_config(cell.config, prog_configs), kwargs


def _recorded_inputs(workload, device, monkeypatch):
    """The inputs of every solve.svd and solve.eigh of one call of the
    cell, the call itself run on torch.linalg."""
    seen = []
    with monkeypatch.context() as m:
        m.setattr(solve, "svd", lambda A: seen.append(("svd", A.clone())) or torch.linalg.svd(A))
        m.setattr(solve, "eigh", lambda A: seen.append(("eigh", A.clone()))
                  or torch.linalg.eigh(A))
        entry, frames, cfg, kwargs = _cell_call(workload, device)
        entry(frames, cfg, SEED, **kwargs)
    return seen


def _crafted(device):
    """Rank-2 and zero matrices, repeated singular values, and the 5-point
    solver's invalid candidates from degenerate samples."""
    rank2 = _random((64, 3, 2), 7) @ _random((64, 2, 3), 8)
    q = torch.linalg.qr(_random((64, 3, 3), 9)).Q
    repeated = q @ torch.diag(torch.tensor([1.0, 1.0, 0.0])) @ q.mT
    equal = torch.eye(3).expand(8, 3, 3) * torch.tensor([0.0, 1.0, 2.0, 1e-20, 1e20, -1.0,
                                                         3.0, 7.0])[:, None, None]
    s1 = _random((32, 5, 2), 10)
    s2 = s1.clone()                                 # no motion: every candidate degenerate
    s1[16:, 1:] = s1[16:, :1]                       # coincident points
    Es, valid = five_point.five_point_candidates_batched(s1.to(device), s2.to(device))
    invalid = Es[~valid]
    assert invalid.shape[0] > 0
    svd_in = [rank2, torch.zeros(16, 3, 3), repeated, equal, invalid.cpu(),
              torch.cat([rank2, repeated]).reshape(16, 8, 3, 3)]
    ata = [M.mT @ M for M in (_random((8, 40, 9), 11), _random((8, 7, 9), 12))]
    eigh_in = ata + [torch.zeros(8, 9, 9), torch.eye(9).expand(4, 9, 9).clone(),
                     torch.diag_embed(torch.tensor([2.0, 2.0, 2.0, 1.0, 1.0, 0.0, 0.0, 5.0, 5.0])
                                      .expand(3, 9)).clone()]
    return ([("svd", A.to(device)) for A in svd_in] + [("eigh", A.to(device)) for A in eigh_in])


def _held_to_torch(inputs):
    before = solve.nonconverged()
    for kind, A in inputs:
        got = getattr(solve, kind)(A)
        want = getattr(torch.linalg, kind)(A)
        assert (solve.svd_routed if kind == "svd" else solve.eigh_routed)(A)
        _same(got, want)
    assert solve.nonconverged() == before


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_cells_decompositions_equal_torch_linalg(cuda, workload, monkeypatch):
    inputs = _recorded_inputs(workload, cuda, monkeypatch)
    kinds = collections.Counter(k for k, _ in inputs)
    gated = workload != "kitti_orb1200_parity.seq128"
    assert kinds == {"svd": 3 if gated else 2, "eigh": 1}
    _held_to_torch(inputs)


@pytest.mark.cuda
def test_crafted_decompositions_equal_torch_linalg(cuda):
    _held_to_torch(_crafted(cuda))


@pytest.mark.cuda
def test_float64_and_other_small_shapes_equal_torch_linalg(cuda):
    inputs = [("svd", _random((6, 3, 3), 13, cuda).double()), ("svd", _random((3, 3), 14, cuda)),
              ("svd", _random((5, 7, 4), 15, cuda)), ("svd", _random((5, 4, 7), 16, cuda))]
    for shape, seed in (((5, 9, 9), 17), ((2, 3, 32, 32), 18)):
        B = _random(shape, seed, cuda)
        inputs += [("eigh", B.mT @ B), ("eigh", (B.mT @ B).double())]
    _held_to_torch(inputs)


def _stage2_waits(events, stage2):
    """The runtime calls of SYNC_CALLS made while the host was in vo.stage2."""
    return [e.name() for e in events if e.name() in SYNC_CALLS
            and any(s <= e.start_ns() <= t for s, t in stage2)]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kitti_orb1200.seq128", "kitti_orb1200_parity.seq128"])
def test_a_call_equals_the_call_on_torch_linalg_and_waits_nowhere_in_stage2(cuda, workload,
                                                                             fresh, monkeypatch):
    entry, frames, cfg, kwargs = _cell_call(workload, cuda)
    entry(frames, cfg, SEED, **kwargs)                        # warm-up: graphs, handles
    runs = {}
    for route in ("jacobi", "torch"):
        with monkeypatch.context() as m:
            if route == "torch":
                m.setattr(solve, "svd", torch.linalg.svd)
                m.setattr(solve, "eigh", torch.linalg.eigh)
            profiling._records.clear()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                poses, diags = entry(frames, cfg, SEED, **kwargs)
                torch.cuda.synchronize()
            stage2 = [(s.start_ns, s.end_ns) for s in profiling.spans() if s.name == "vo.stage2"]
            names = collections.Counter(s.name for s in profiling.spans())
            runs[route] = (poses, diags, _stage2_waits(prof.profiler.kineto_results.events(),
                                                       stage2), names["solve.jacobi"])
    (pa, da, waits, jacobi), (pb, db, torch_waits, none) = runs["jacobi"], runs["torch"]
    assert torch.equal(pa.R, pb.R) and torch.equal(pa.t, pb.t)
    assert da.keys() == db.keys() and all(torch.equal(da[k], db[k]) for k in da)
    assert waits == [] and len(torch_waits) >= 2
    assert jacobi == (4 if workload == "kitti_orb1200.seq128" else 3) and none == 0
    assert solve.nonconverged(cuda) == 0
