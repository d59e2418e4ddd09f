"""A cell with a stage after stage 2, built here and cut down as
test_vobench_reference.py cuts the real ones: its configuration names a
`module:function` reference run (`reference` below) and an entry setting
(`entry_kwargs`), and its entry taps a stage with the role `refine`, a
re-normalisation of every pair's relative motion that the reference
computes again. A sound run is correct; a broken refinement fails on the
refine_* numbers alone; a clash of settings and an unknown reference
raise before the first call; the real cells keep their reference."""

import copy
import json
import math
import os
import time
from typing import NamedTuple

import pytest
import torch

from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.pipeline.runner import chain_relative_poses, detect_frames, estimate_pairs
from tpu_vo_torch.pipeline.step import pair_generators
from vobench import check, control, harness
from vobench.reference import pipeline as ref_pipeline
from vobench.tests.test_vobench_reference import SEED, SEQ

CALLS = []          # the seeds of the entry's calls
LIMITS = {"refine_rot_gap_deg": 0.01, "refine_dir_gap_deg": 0.5, "refine_flags_diff": 0}


class Refined(NamedTuple):
    R_rel: torch.Tensor     # (P, 3, 3)
    t_rel: torch.Tensor     # (P, 3)
    improved: torch.Tensor  # (P,) bool


def _renormalize(R, t, iters):
    """`iters` steps towards the nearest rotation and the unit vector;
    improved where a step moved t."""
    t0 = t
    for _ in range(iters):
        R = 1.5 * R - 0.5 * R @ R.transpose(-1, -2) @ R
        t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return R, t, (t != t0).any(-1)


def refine_motions(R, t, have_rt, iters):
    """The program's refinement stage (have_rt is there for the faults)."""
    return Refined(*_renormalize(R, t, iters))


def entry(frames, cfg, seed=0, device=None, refine_iters=0):
    """run_sequence_batched with the refinement between stages 2 and 3;
    the stages are called through this module, where the harness taps them."""
    CALLS.append(seed)
    frames = frames.to(device or "cuda")
    T = frames.shape[0]
    feats = detect_frames(frames, cfg)
    est = estimate_pairs(ORBFeatures(*(f[:-1] for f in feats)),
                         ORBFeatures(*(f[1:] for f in feats)), cfg,
                         pair_generators(seed, range(1, T)))
    ref = refine_motions(est["R"], est["t"], est["have_rt"], refine_iters)
    return chain_relative_poses(ref.R_rel, ref.t_rel, est["have_rt"], est["pose_ok"], cfg), {}


def reference(frames, cfg, seed, block, refine_iters):
    """The reference run of this cell: vobench.reference.pipeline.run, the
    same refinement computed again, the chain over the refined motions."""
    feats, est, _ = ref_pipeline.run(frames, cfg, seed, block)
    t0, R, t = est["t"], est["R"], est["t"]
    for _ in range(refine_iters):
        R = 1.5 * R - 0.5 * R @ R.transpose(-1, -2) @ R
        t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    poses = ref_pipeline.chain_relative_poses(R, t, est["have_rt"], est["pose_ok"], cfg)
    return feats, est, poses, {"refine": {"R": R, "t": t, "improved": (t != t0).any(-1)}}


def _cell(**config):
    cell = harness.load_cell("kitti_orb1200.seq128", SEQ)
    cell.config.update({"reference": f"{__name__}:reference",
                        "entry_kwargs": {"refine_iters": 2}}, **config)
    cell.traffic["entry"] = {"module": __name__, "function": "entry"}
    cell.traffic["stages"] = dict(cell.traffic["stages"], refine="refine_motions")
    cell.limits = dict(cell.limits, **LIMITS)
    return cell


@pytest.fixture
def stand_in(monkeypatch):
    """Makes `cell` the one that harness.load_cell gives."""
    def use(cell):
        monkeypatch.setattr(harness, "load_cell", lambda workload, overrides=None:
                            copy.deepcopy(cell))
        CALLS.clear()
    return use


def _run():
    return harness.run_cell("stand_in.refine", SEED, 0.3, False, time.time(), device="cpu")


def _failing(line):
    return {k for k, c in line["checks"].items()
            if k != "calls_checked" and not c["value"] <= c["limit"]}


def test_a_sound_refinement_is_correct(stand_in):
    stand_in(_cell())
    line = _run()
    assert line["correct"] is True, line["checks"]
    assert list(line["checks"]) == list(check.NAMES + check.REFINE_NAMES) + ["calls_checked"]
    assert all(line["checks"][k]["value"] == 0 for k in check.NAMES + check.REFINE_NAMES)
    # every warm-up and window call of the entry took the configuration's setting
    assert len(CALLS) >= 2


def test_load_cell_overrides_set_entry_kwargs(monkeypatch):
    """`overrides` reaches a setting of entry_kwargs, as it reaches the
    port's and the traffic's."""
    real = harness.load_json

    def with_settings(path):
        got = real(path)
        if path.endswith(os.path.join("configs", "kitti_orb1200.json")):
            got["entry_kwargs"] = {"refine_iters": 6}
        return got
    monkeypatch.setattr(harness, "load_json", with_settings)
    cell = harness.load_cell("kitti_orb1200.seq128", dict(SEQ, refine_iters=1))
    assert cell.config["entry_kwargs"] == {"refine_iters": 1}
    kwargs, settings = harness.entry_kwargs(cell, torch.device("cpu"))
    assert settings == {"refine_iters": 1} and kwargs == {"refine_iters": 1, "device": "cpu"}


def _flipped_flag(fn):
    """Pair 0's `improved` flag flipped; the motions as they were."""
    def faulty(*a, **k):
        out = fn(*a, **k)
        improved = out.improved.clone()
        improved[0] = ~improved[0]
        return out._replace(improved=improved)
    return faulty


def _turned_rotation(fn):
    """The last pair with a motion has its refined rotation turned by 0.05
    degrees about the optical axis."""
    def faulty(R, t, have_rt, iters):
        out = fn(R, t, have_rt, iters)
        i = int(torch.nonzero(have_rt)[-1])
        c, s = math.cos(math.radians(0.05)), math.sin(math.radians(0.05))
        turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=out.R_rel.dtype)
        R_rel = out.R_rel.clone()
        R_rel[i] = turn @ R_rel[i]
        return out._replace(R_rel=R_rel)
    return faulty


@pytest.mark.parametrize("fault,fails", [(_flipped_flag, {"refine_flags_diff"}),
                                         (_turned_rotation, {"refine_rot_gap_deg"})],
                         ids=["flipped_flag", "turned_rotation"])
def test_a_broken_refinement_fails_on_the_refine_numbers_alone(stand_in, monkeypatch, fault,
                                                               fails):
    import sys
    module = sys.modules[__name__]
    monkeypatch.setattr(module, "refine_motions", fault(refine_motions))
    stand_in(_cell())
    line = _run()
    assert line["correct"] is False
    assert _failing(line) == fails, line["checks"]


@pytest.mark.parametrize("config,traffic_kwargs", [
    ({}, {"refine_iters": 1}),                                   # a setting twice
    ({"reference": "vobench/other"}, {}),
    ({"reference": f"{__name__}:no_such_run"}, {}),
    ({"reference": "tpu_vo_torch.pipeline.runner:run_sequence_batched"}, {}),
    ({"reference": None}, {})], ids=["clash", "path", "missing", "the_program", "none"])
def test_a_clash_or_an_unknown_reference_raises_before_the_first_call(stand_in, config,
                                                                      traffic_kwargs):
    cell = _cell(**config)
    cell.traffic["kwargs"] = traffic_kwargs
    stand_in(cell)
    with pytest.raises(ValueError):
        _run()
    with pytest.raises(ValueError):
        control.readings("stand_in.refine", [SEED], ("program",), device="cpu")
    assert CALLS == []


def test_the_control_reads_the_refine_numbers_in_both_modes(stand_in):
    stand_in(_cell())
    got = control.readings("stand_in.refine", [SEED], ("program", "control"), device="cpu")
    assert [mode for mode, _, _ in got] == ["program", "control"]
    for _, _, numbers in got:
        assert set(numbers) == set(check.NAMES + check.REFINE_NAMES)


def test_the_refine_numbers_are_judged_only_where_the_cell_taps_refine():
    """A call that lacks a number, or a reading that is NaN, makes the
    worst NaN; a missing limit fails; a cell without the role is judged on
    NAMES alone."""
    zero = {k: 0 for k in check.NAMES}
    sound = dict(zero, refine_rot_gap_deg=0.0, refine_dir_gap_deg=0.0, refine_flags_diff=0)
    names = check.names({"refine": "f"})
    assert check.worst([dict(sound, refine_rot_gap_deg=1.0), sound],
                       names)["refine_rot_gap_deg"] == 1.0
    numbers = check.worst([dict(zero, refine_rot_gap_deg=1.0), zero], names)
    assert all(math.isnan(numbers[k]) for k in check.REFINE_NAMES)
    assert math.isnan(check.worst([zero, dict(zero, traj_gap=float("nan"))])["traj_gap"])
    limits = dict({k: 0 for k in check.NAMES}, **LIMITS)
    assert not check.judge(numbers, limits, names)
    assert check.judge(sound, limits, check.names({"refine": "f"}))
    del limits["refine_dir_gap_deg"]
    assert not check.judge(sound, limits, check.names({"refine": "f"}))
    assert check.names({"stage1": "a", "stage2": "b"}) == check.NAMES
    assert check.judge(dict(sound, refine_flags_diff=5), limits, check.NAMES)


def test_the_real_cells_keep_the_default_reference():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert harness.reference_run(cell.config) is ref_pipeline.run
        assert "refine" not in cell.traffic["stages"]
        assert check.names(cell.traffic["stages"]) == check.NAMES
