"""The refinement stage of run_sequence_batched (refine_iters, tpu_vo's
config 5) on the CPU: with 0 iterations the call is the unrefined one,
bit for bit; with 6 its poses are the chain of refine_window over the
inputs that runner.refine_inputs built, the pairs improve, and the poses
move; a negative count raises before stage 1. runner.refine_pairs
against the benchmark's plain reference (vobench/reference/window_lm.py)
on seeded random windows, whose own Jacobian is held against
torch.func.jacfwd; and the spans of a refined call."""

import collections
import functools
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_vo_torch.configs as prog_configs
from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.models.refinement import refine_window
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.utils import profiling
from vobench import harness
from vobench.reference import configs as ref_configs
from vobench.reference import window_lm
from _torch_threads import _one_thread  # noqa: F401

# float64: the two compute one function, so only rounding differs
F64_TOL = 1e-9
# float32: tests/test_torch_refinement.py's tolerances for the port against
# tpu_vo (entries of R and t 2e-4, costs 1e-4 relative): six LM steps, each
# a 6x6 solve, in another order of the same sums
F32_TOL, F32_COST_RTOL = 2e-4, 1e-4
SEED = 2 ** 31 + 11
# The benchmark's cells cut down for the CPU: the seq128 cell as
# vobench/tests/test_vobench_reference.py cuts it, and the refinement
# cell at 320x240, where most pairs get a motion
SEQ = dict(image_width=160, image_height=120, n_features=100, n_levels=3, max_iters=16,
           call_shape=[4])
VGA_CUT = dict(image_width=320, image_height=240, n_features=300, n_levels=4, max_iters=64,
               call_shape=[4])
CUTS = {"kitti_orb1200.seq128": SEQ, "vga_orb1000_lm.seq32": VGA_CUT}
REFINE_SPANS = {"vo.refine": "vo.call", "refine.prep": "vo.refine", "refine.lm": "vo.refine",
                "lm.step": "refine.lm"}


@functools.lru_cache(maxsize=None)
def _cell(workload):
    """(frames, the program's VOConfig) of the cell `workload` cut by CUTS."""
    cell = harness.load_cell(workload, CUTS[workload])
    frames = harness.make_pool(cell, SEED, torch.device("cpu"))[0]
    return frames, harness.vo_config(cell.config, prog_configs)


def _same(a, b):
    (pa, da), (pb, db) = a, b
    assert torch.equal(pa.R, pb.R) and torch.equal(pa.t, pb.t)
    assert da.keys() == db.keys() and all(torch.equal(da[k], db[k]) for k in da)


def test_no_refinement_is_the_unrefined_call():
    frames, cfg = _cell("kitti_orb1200.seq128")
    plain = runner.run_sequence_batched(frames, cfg, 77, device="cpu")
    _same(runner.run_sequence_batched(frames, cfg, 77, device="cpu", refine_iters=0), plain)
    assert not {"refine_improved", "refine_cost"} & set(plain[1])


def test_refined_poses_chain_refine_window_of_the_call_inputs(monkeypatch):
    frames, cfg = _cell("vga_orb1000_lm.seq32")
    kept = {}
    stage2, prep = runner.estimate_pairs, runner.refine_inputs
    monkeypatch.setattr(runner, "estimate_pairs",
                        lambda *a, **k: kept.setdefault("est", stage2(*a, **k)))
    monkeypatch.setattr(runner, "refine_inputs",
                        lambda *a: kept.setdefault("args", prep(*a)))
    poses, diags = runner.run_sequence_batched(frames, cfg, 5, device="cpu", refine_iters=6)
    est, args = kept["est"], kept["args"]
    out = refine_window(*args, iters=6)
    want = runner.chain_relative_poses(out.R_rel, out.t_rel, est["have_rt"], est["pose_ok"], cfg)
    assert torch.equal(poses.R, want.R) and torch.equal(poses.t, want.t)
    assert torch.equal(diags["refine_improved"], out.improved)
    assert torch.equal(diags["refine_cost"], out.cost)
    # the refinement does work: most pairs improve, and the poses move
    have = est["have_rt"]
    assert int(have.sum()) >= 2
    assert int(out.improved[have].sum()) > 0.5 * int(have.sum())
    start = refine_window(*args, iters=0)
    assert bool((out.cost <= start.cost).all()) and bool((out.cost < start.cost).any())
    plain, _ = runner.run_sequence_batched(frames, cfg, 5, device="cpu")
    assert not torch.equal(poses.t, plain.t) and not torch.equal(poses.R, plain.R)
    assert torch.equal(plain.t[:1], poses.t[:1])


def test_a_negative_refinement_raises_before_stage_1(monkeypatch):
    def stage1(*args, **kwargs):
        raise AssertionError("stage 1 ran before refine_iters was checked")

    monkeypatch.setattr(runner, "detect_frames", stage1)
    frames, cfg = _cell("kitti_orb1200.seq128")
    with pytest.raises(ValueError, match="refine_iters"):
        runner.run_sequence_batched(frames, cfg, device="cpu", refine_iters=-1)


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _window(seed, dtype, P=5, N=80, W=640, H=480, noise=2e-3, outliers=0.2):
    """(prev, cur, est) of P noisy two-view pairs at W x H: pixels of
    points seen under a motion near (R, t), the second frame's keypoints
    in a shuffled order that match_train_idx undoes, outliers off the
    inlier mask, starts perturbed from the truth."""
    rng = np.random.default_rng(seed)
    px1, px2, idx, R0s, t0s = [], [], [], [], []
    for _ in range(P):
        R = _rodrigues(rng.normal(size=3) * 0.05)
        t = np.array([0.1, 0.0, 1.0]) + rng.normal(size=3) * 0.1
        t /= np.linalg.norm(t)
        X = np.concatenate([rng.uniform(-3, 3, (N, 2)), rng.uniform(3, 20, (N, 1))], -1)
        Xc = X @ R.T + t
        x1 = X[:, :2] / X[:, 2:] + rng.normal(0, noise, (N, 2))
        x2 = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, noise, (N, 2))
        order = rng.permutation(N)
        cur = np.empty_like(x2)
        cur[order] = x2
        px1.append(x1 * W + [W / 2, H / 2])
        px2.append(cur * W + [W / 2, H / 2])
        idx.append(order)
        R0s.append(_rodrigues(rng.normal(size=3) * 0.01) @ R)
        t0 = t + rng.normal(size=3) * 0.05
        t0s.append(t0 / np.linalg.norm(t0))
    mask = torch.from_numpy(rng.random((P, N)) > outliers)

    def feats(xy):
        xy = torch.from_numpy(np.asarray(xy)).to(dtype)
        zero = torch.zeros(xy.shape[:2], dtype=torch.float32)
        return ORBFeatures(xy, zero, zero, zero.int(), zero,
                           torch.zeros(*xy.shape[:2], 32, dtype=torch.uint8),
                           torch.zeros(*xy.shape[:2], 8, dtype=torch.int32),
                           torch.ones(xy.shape[:2], dtype=torch.bool))

    est = {"match_train_idx": torch.from_numpy(np.asarray(idx)), "match_mask": mask,
           "R": torch.from_numpy(np.asarray(R0s)).to(dtype),
           "t": torch.from_numpy(np.asarray(t0s)).to(dtype)}
    return feats(px1), feats(px2), est


def _both(seed, dtype, iters=6):
    prev, cur, est = _window(seed, dtype)
    prog = runner.refine_pairs(prev, cur, est, VOConfig(image_width=640, image_height=480), iters)
    x1, x2 = window_lm.correspondences(prev.xy, cur.xy, est["match_train_idx"],
                                       ref_configs.VOConfig(image_width=640, image_height=480))
    ref = window_lm.refine_window(x1, x2, est["match_mask"], est["R"], est["t"], iters)
    return prog, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_pairs_equals_the_plain_reference_f64(seed):
    prog, ref = _both(seed, torch.float64)
    assert prog.R_rel.dtype == torch.float64 and bool(prog.improved.all())
    assert torch.equal(prog.improved, ref.improved)
    for a, b in ((prog.R_rel, ref.R_rel), (prog.t_rel, ref.t_rel), (prog.cost, ref.cost)):
        torch.testing.assert_close(a, b, rtol=F64_TOL, atol=F64_TOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_refine_pairs_equals_the_plain_reference_f32(seed):
    prog, ref = _both(seed, torch.float32)
    assert prog.R_rel.dtype == torch.float32 and bool(prog.improved.any())
    assert torch.equal(prog.improved, ref.improved)
    for a, b in ((prog.R_rel, ref.R_rel), (prog.t_rel, ref.t_rel)):
        torch.testing.assert_close(a, b, rtol=0.0, atol=F32_TOL)
    torch.testing.assert_close(prog.cost, ref.cost, rtol=F32_COST_RTOL, atol=0.0)


@pytest.mark.parametrize("scale", [0.0, 1e-9, 1e-3, 0.3, 2.0])
def test_the_reference_jacobian_equals_jacfwd(scale):
    prev, cur, est = _window(6, torch.float64)
    cfg = ref_configs.VOConfig(image_width=640, image_height=480)
    x1, x2 = window_lm.correspondences(prev.xy, cur.xy, est["match_train_idx"], cfg)
    w, R0, t0 = est["match_mask"].double(), est["R"], est["t"]
    g = torch.Generator().manual_seed(int(scale * 1e9) % 1000)
    p = torch.randn(x1.shape[0], 6, dtype=torch.float64, generator=g) * scale
    r, J = window_lm.residuals_and_jacobian(p, x1, x2, w, R0, t0)
    want = torch.func.vmap(torch.func.jacfwd(window_lm.residuals))(p, x1, x2, w, R0, t0)
    assert torch.equal(r, window_lm.residuals(p, x1, x2, w, R0, t0))
    assert float((J - want).abs().max()) <= 1e-11 * float(want.abs().max())


@pytest.fixture
def fresh(monkeypatch):
    """An empty record of spans, the process's first call already made."""
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=profiling.SPAN_LIMIT))
    monkeypatch.setattr(profiling, "_first_call", [False])
    monkeypatch.setattr(profiling, "_calls", itertools.count())


@pytest.mark.parametrize("iters", [0, 6])
def test_a_refined_call_records_the_refinement_spans(fresh, iters):
    frames, cfg = _cell("kitti_orb1200.seq128")
    with profile(activities=[ProfilerActivity.CPU]):
        runner.run_sequence_batched(frames, cfg, 77, device="cpu", refine_iters=iters)
    got = profiling.spans()
    names = collections.Counter(s.name for s in got)
    by_id = {s.id: s for s in got}
    assert len(got) == 20 + (3 + iters if iters else 0)
    if not iters:
        assert not set(REFINE_SPANS) & set(names)
        return
    assert names["vo.refine"] == names["refine.prep"] == names["refine.lm"] == 1
    assert names["lm.step"] == iters
    for s in got:
        if s.name in REFINE_SPANS:
            assert by_id[s.parent].name == REFINE_SPANS[s.name], s
