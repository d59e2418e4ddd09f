"""The port's profiling tools (tpu_vo_torch/tools) on the CPU at cut sizes.

Each tool runs through main(device="cpu", <cut sizes>, reps=1, iters=1),
prints the JAX tool's row names as JSON lines with a parseable last
line, writes nothing under benchmarks/, and raises without a card when
no device is named. The split stages compose back into the function they
split, bit for bit on the CPU; the chain variants equal tpu_vo's
cumulative_compose within 1e-5 (float32)."""

import hashlib
import io
import json
import os
import contextlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpu_vo.configs import VOConfig as JVOConfig
from tpu_vo.geometry import se3 as jse3
from tpu_vo.pipeline import runner as jrunner
from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.features import orb
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import _intrinsics, estimate_pair, pair_generators
from tpu_vo_torch.estimation import ransac as R
from tpu_vo_torch.tools import (probe_4k_gap, profile_4k, profile_5pt_micro, profile_batch8,
                                profile_batch8_flat, profile_chain, profile_features,
                                profile_headline, profile_pairs, profile_ransac, profile_rows,
                                select_breakdown, streamed_probe, topk_micro)
from tpu_vo_torch.utils import profiling
from tpu_vo_torch.utils.synthetic import make_sequence

BENCHMARKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "benchmarks")
SMALL = dict(width=160, height=120, features=100)

# tool: (module, cut sizes, the JAX tool's row names that must be there)
TOOLS = {
    "profile_headline": (profile_headline, dict(T=4, hyps=16, fc=2, pc=3, **SMALL),
                         ["features", "pairs", "chain", "sum", "full", "gap"]),
    "profile_features": (profile_features, dict(T=4, fc=2, **SMALL),
                         ["pyramid", "select", "patches", "angle+desc", "pack", "full",
                          "composed_equal"]),
    "select_breakdown": (select_breakdown, dict(width=200, height=120, features=300),
                         ["level0.kernel", "level0.pool_topk", "level0.gather_rank", "level0.whole",
                          "level7",
                          "totals", "select_maps_levels"]),
    "topk_micro": (topk_micro, dict(height=20, width=64, k=16),
                   ["pool_flat", "flat_only", "topk_1d", "topk_2d", "topk_rowband",
                    "approx_f32", "sort_1d", "topk_2d_exact", "topk_rowband_exact"]),
    "profile_4k": (profile_4k, dict(base_width=160, base_height=120, base_features=100,
                                    base_batch=3, hi_width=320, hi_height=200, hi_features=300,
                                    hi_batch=2, hyps=16),
                   ["base_160x120.pyramid_ms", "base_160x120.select_maps_ms",
                    "base_160x120.select_plus_topk_ms", "hi_320x200.patches_blur_ms",
                    "hi_320x200.frontend_ms", "hi_320x200.hamming_ms", "hi_320x200.pair_ms",
                    "ratios"]),
    "probe_4k_gap": (probe_4k_gap, dict(T=3, width=200, height=150, features=200, fc=1, pc=2,
                                        chain_reps=1),
                     ["frontend", "pairs", "chain", "whole", "per_frame"]),
    "profile_pairs": (profile_pairs, dict(T=5, hyps=16, fc=5, pc=2, **SMALL),
                      ["match+filter", "+gather+normalize", "ransac", "recover_pose",
                       "F+residual diag", "full estimate_pair", "composed_equal"]),
    "profile_ransac": (profile_ransac, dict(T=5, width=160, height=120, features=200, fc=5,
                                            pc=2, hyps=16, dk=10),
                       ["poly(no-DK)", "dk_roots", "draw+5pt", "prescreen", "fullscore",
                        "refit", "full ransac", "syncs", "composed_equal"]),
    "profile_5pt_micro": (profile_5pt_micro, dict(pc=2, samples=8, dk=10),
                          ["nullspace", "constraint", "gauss-jordan", "det-poly", "dk+newton",
                           "soa nullspace", "soa roots+newton"]),
    "profile_chain": (profile_chain, dict(n=8), ["doubling", "soa", "assoc", "scan", "full"]),
    "streamed_probe": (streamed_probe, dict(T=4, hyps=16, chunks=(4,), fc=2, pc=2,
                                            **SMALL),
                       ["streamed_c4_fcNone_pcNone", "streamed_c4_fc2_pc2"]),
    "profile_batch8": (profile_batch8, dict(width=96, height=64, features=50, hyps=4,
                                            variants=("single_T96_fc8_pc95",)),
                       ["single_T96_fc8_pc95"]),
    "profile_batch8_flat": (profile_batch8_flat, dict(B=2, T=4, width=96, height=64,
                                                      features=50, hyps=4, pcs=(3, 6), fc=4,
                                                      fcs=(8,), fc_pc=6),
                            ["flat_B2_T4_fc4_pc3", "flat_B2_T4_fc4_pc6", "flat_B2_T4_fc8_pc6"]),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run beside other test processes, and
    oversubscribed OpenMP pools turn each parallel op into a wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_hash(root):
    h = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                h[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return h


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_cpu(name, tmp_path):
    mod, cut, names = TOOLS[name]
    before = _tree_hash(BENCHMARKS)
    buf = io.StringIO()
    out = tmp_path / "rows.json"
    with contextlib.redirect_stdout(buf):
        obj = mod.main(device="cpu", reps=1, iters=1, out=str(out), **cut)
    lines = buf.getvalue().strip().splitlines()
    last = json.loads(lines[-1])
    assert last == json.loads(json.dumps(obj))
    assert json.loads(out.read_text()) == last
    assert last["tool"] == name and last["card"] == "cpu"
    for n in names:
        assert n in last["rows"], n
    for line in lines[:-1]:
        row = json.loads(line)
        assert row["tool"] == name and row["card"] == "cpu"
        if isinstance(row.get("ms"), (int, float)):
            pytest.fail(f"{row['row']}: a device time from a CPU run")
    for flag in ("composed_equal", "topk_2d_exact", "topk_rowband_exact"):
        if flag in last["rows"]:
            assert last["rows"][flag] is True, flag
    assert _tree_hash(BENCHMARKS) == before


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_raises_without_a_card(name, monkeypatch):
    mod, cut, _ = TOOLS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(**cut)


def test_unknown_size_raises():
    with pytest.raises(TypeError, match="unknown sizes"):
        profile_chain.main(device="cpu", frames=3)


@pytest.fixture(scope="module")
def small():
    """Five 160x120 frames, their features (200 keypoints: RANSAC scores
    in two phases), the config."""
    cfg = VOConfig(image_width=160, image_height=120, orb=ORBConfig(n_features=200),
                   ransac=RansacConfig(max_iters=16))
    frames = torch.from_numpy(np.stack(make_sequence(n_frames=5, width=160, height=120,
                                                     seed=0)[0]))
    return cfg, frames, runner.detect_frames(frames, cfg)


def test_features_stages_compose_to_detect_and_compute(small):
    cfg, frames, feats = small
    got = profile_features.composed(frames[:4], cfg.orb, 2)
    want = orb.detect_and_compute(frames[:2], cfg.orb)
    assert all(torch.equal(a[:2], b) for a, b in zip(got, want))
    assert all(torch.equal(a, b[:4]) for a, b in zip(got, feats))


def test_gather_rank_gives_rank_from_maps_keypoints():
    """The tool's pool_topk row chained into its gather_rank row, at the
    pipeline's stage-1 capacity, gives _rank_from_maps' keypoints bit for
    bit on every level."""
    o = type("O", (), dict(width=200, height=120, features=300))
    cfg, levels, budgets = select_breakdown.levels_of(o, "cpu")
    found = 0
    for lvl, n in zip(levels, budgets):
        h, w = lvl.shape[-2:]
        packed, hmap, bits = orb.select_maps_levels([lvl], cfg.fast_threshold,
                                                    cfg.edge_threshold)[0]
        v = select_breakdown.pool_topk(packed, orb._stage1_size(n, cfg, h * w))
        got = select_breakdown.gather_rank(v, hmap, bits, w, n, cfg, h * w)
        want = orb._rank_from_maps(packed, hmap, bits, w, n, cfg, h * w)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        found += int(want[3].sum())
    assert found > 0


def test_topk_variants_give_topk_1d_values():
    packed, pooled = topk_micro.packed_map(188, 1280)
    packed, pooled = torch.from_numpy(packed), torch.from_numpy(np.ascontiguousarray(pooled))
    want = topk_micro.topk_1d(pooled, 706)
    assert torch.equal(topk_micro.topk_2d(pooled, 706), want)
    assert torch.equal(topk_micro.topk_rowband(pooled, 706), want)
    assert torch.equal(topk_micro.topk_1d(topk_micro.pool_flat(packed).view(188, 640), 706),
                       want)
    assert torch.equal(topk_micro.sort_1d(pooled)[-706:].flip(0), want)


def test_pair_stages_compose_to_estimate_pair(small):
    cfg, _, feats = small
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    got = profile_pairs.composed(prev, cur, cfg, pair_generators(0, range(1, 5)))
    want = estimate_pair(prev, cur, cfg, generators=pair_generators(0, range(1, 5)))
    for k in profile_pairs.COMPARED:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("score,prescreen", [("msac", True), ("count", True), ("msac", False)])
def test_ransac_phases_compose_to_find_essential_ransac(small, score, prescreen):
    cfg, _, feats = small
    n = feats.xy.shape[1] if prescreen else R.PRESCREEN
    prev = ORBFeatures(*(f[:-1, :n] for f in feats))
    cur = ORBFeatures(*(f[1:, :n] for f in feats))
    K = _intrinsics(cfg.intrinsics, prev.xy.device, prev.xy.dtype)
    good, _ = profile_pairs.match_stage(prev, cur, cfg)
    _, _, x1n, x2n, mask = profile_pairs.prep_stage(prev, cur, good, K)
    rcfg = RansacConfig(max_iters=16, score_method=score)
    thr = R.pixel_threshold_to_normalized(rcfg.threshold_px, K)
    c = profile_ransac.phases_of(x1n, x2n, mask, thr, rcfg)
    assert c.two_phase == prescreen
    idx = c.draw(pair_generators(0, range(1, 5)))
    got = profile_ransac.stepwise(c, idx)
    want = R.find_essential_ransac(x1n, x2n, mask, thr, idx=idx,
                                   **profile_pairs.ransac_options(rcfg))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(want.success.sum()) >= 1


def _positions(poses):
    return poses.t.numpy()


def test_streamed_step_at_8_8_is_run_sequence_streamed():
    """The tool's step at (8, 8), the defaults, gives run_sequence_streamed's
    poses bit for bit; at (None, None) (one call a chunk) the same pose_ok
    and positions within 1e-5 (measured here: bit-equal too, but only the
    batching differs, so 1e-5 is the bar)."""
    cfg = VOConfig(image_width=160, image_height=120, orb=ORBConfig(n_features=100),
                   ransac=RansacConfig(max_iters=16))
    frames = torch.from_numpy(np.stack(make_sequence(n_frames=16, width=160, height=120,
                                                     seed=0)[0]))
    want, diag = runner.run_sequence_streamed(iter(frames.split(16)), cfg, device="cpu")
    poses, ok = streamed_probe.stream(frames, 16, cfg, 8, 8)
    assert torch.equal(poses.R, want.R) and torch.equal(poses.t, want.t)
    assert torch.equal(ok, diag["pose_ok"])
    poses1, ok1 = streamed_probe.stream(frames, 16, cfg, None, None)
    assert torch.equal(ok1, diag["pose_ok"])
    assert np.abs(_positions(poses1) - _positions(want)).max() < 1e-5


def test_streamed_step_defaults_are_8_8():
    cfg = VOConfig(image_width=160, image_height=120, orb=ORBConfig(n_features=100),
                   ransac=RansacConfig(max_iters=16))
    frames = torch.from_numpy(np.stack(make_sequence(n_frames=8, width=160, height=120,
                                                     seed=1)[0]))
    carry = runner._empty_features(cfg, torch.device("cpu"))
    a = runner._streamed_step(carry, frames, cfg, 0, 0)
    b = runner._streamed_step(carry, frames, cfg, 0, 0, runner.STREAM_FRAME_CHUNK,
                              runner.STREAM_PAIR_CHUNK)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1] if k != "stats")


def test_chain_variants_equal_tpu_vo_cumulative_compose():
    n = 63
    R_np, t_np = profile_chain.poses(n)
    want = jse3.cumulative_compose(jse3.Pose(jnp.asarray(R_np), jnp.asarray(t_np)))
    R, t = torch.from_numpy(R_np), torch.from_numpy(t_np)
    for name, fn in profile_chain.VARIANTS.items():
        gR, gt = fn(R, t)
        assert gR.dtype == torch.float32
        assert np.abs(gR.numpy() - np.asarray(want.R)).max() < 1e-5, name
        assert np.abs(gt.numpy() - np.asarray(want.t)).max() < 1e-5, name
    have = np.ones(n, bool)
    jfull = jrunner.chain_relative_poses(jnp.asarray(R_np), jnp.asarray(t_np),
                                         jnp.asarray(have), jnp.asarray(have),
                                         JVOConfig(image_width=1241, image_height=376))
    full = runner.chain_relative_poses(R, t, torch.from_numpy(have), torch.from_numpy(have),
                                       VOConfig(image_width=1241, image_height=376))
    assert np.abs(full.R.numpy() - np.asarray(jfull.R)).max() < 1e-5
    assert np.abs(full.t.numpy() - np.asarray(jfull.t)).max() < 1e-5


def test_chain_poses_are_the_jax_tools_draws():
    """The tool's poses: RandomState(0) draws in the JAX tool's order,
    rotations by tpu_vo's rotation_from_axis_angle within float32."""
    rng = np.random.RandomState(0)
    ax = rng.randn(63, 3)
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    Rj = np.asarray(jse3.rotation_from_axis_angle(jnp.asarray(ax, jnp.float32),
                                                  jnp.asarray(rng.rand(63) * 0.2, jnp.float32)))
    t = rng.randn(63, 3).astype(np.float32) * 0.1
    R_np, t_np = profile_chain.poses(63)
    assert np.array_equal(t_np, t)
    assert np.abs(R_np - Rj).max() < 1e-6


def test_sync_sites_split_each_chunks_syncs():
    chunk = [("prescreen", "aten::linalg_svd"), ("prescreen", "aten::linalg_svd"),
             ("refit", "aten::linalg_eigh"), ("recover_pose", "aten::linalg_svd")]
    waits = [{"phase": p, "op": op, "call": "cudaStreamSynchronize",
              "host_wait_ms": 1.0 + 10 * c + i} for c in range(3)
             for i, (p, op) in enumerate(chunk)]
    sites = profile_ransac.sync_sites(waits, 3)
    assert list(sites) == ["sync prescreen linalg_svd 1", "sync prescreen linalg_svd 2",
                           "sync refit linalg_eigh 1", "sync recover_pose linalg_svd 1"]
    assert sites["sync prescreen linalg_svd 2"] == {"calls": 3, "host_wait_ms": 2 + 12 + 22,
                                                    "max_ms": 22.0}


def test_interval_union_and_busy_profile_needs_a_card(monkeypatch):
    assert profiling.interval_union([(0, 2), (1, 3), (5, 6), (6, 6.5), (10, 10)]) == 4.5
    assert profiling.interval_union([]) == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.busy_profile(lambda: None, 1, 0)


def test_option_parsing():
    o = profile_rows.options(["--chunks", "16,64", "--fc", "none", "--reps", "2"],
                             streamed_probe.DEFAULTS, "cpu", {"pc": None}, "")
    assert o.chunks == (16, 64) and o.fc is None and o.pc is None and o.reps == 2
    assert o.device == torch.device("cpu") and o.T == 64
