"""The reference against the program on the CPU at a tiny size, and a
whole run of the harness with its timed path broken underneath: each
fault has to make `correct` false."""

import importlib
import math
import time

import pytest
import torch

import tpu_vo_torch.configs as prog_configs
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.parallel import sharding
from tpu_vo_torch.pipeline import runner
from vobench import check, harness
from vobench.reference import configs as ref_configs

SMALL = dict(image_width=160, image_height=120, n_features=100, n_levels=3, max_iters=16,
             pool=2, check_calls=1, trace_calls=2, ref_block=2)
SEQ = dict(SMALL, call_shape=[4])
FLEET = dict(SMALL, call_shape=[2, 3])
SEED = 2 ** 31 + 11


def _run(workload, overrides, trace=False):
    return harness.run_cell(workload, SEED, 0.3, trace, time.time(), device="cpu",
                            overrides=overrides)


@pytest.mark.parametrize("workload,overrides", [("kitti_orb1200.seq128", SEQ),
                                                ("uhd_orb8000.seq16", SEQ),
                                                ("kitti_orb1200.fleet8x32", FLEET)])
def test_reference_equals_the_program_on_the_cpu(workload, overrides):
    """The frozen plain code gives the program's outputs bit for bit, and
    the comparison reads 0 on every number."""
    cell = harness.load_cell(workload, overrides)
    frames = harness.make_pool(cell, SEED, torch.device("cpu"))[0]
    tap = harness.Tap(importlib.import_module(cell.traffic["entry"]["module"]),
                      cell.traffic["stages"], False)
    try:
        entry = getattr(tap.module, cell.traffic["entry"]["function"])
        poses, _ = entry(frames, harness.vo_config(cell.config, prog_configs), 77, device="cpu")
        prog = (tap.out["stage1"], tap.out["stage2"], poses)
    finally:
        tap.close()
    ref = harness.reference(frames, harness.vo_config(cell.config, ref_configs), 77,
                            cell.traffic["ref_block"], harness.reference_run(cell.config),
                            tf32=False)
    numbers = check.compare(prog, ref)
    assert all(v == 0 for v in numbers.values()), numbers
    for p, r in zip(prog[0], ref[0]):
        assert torch.equal(p, r)
    assert torch.equal(prog[2].t.reshape(ref[2].t.shape), ref[2].t)
    assert int(prog[0].valid.sum()) > 0.5 * prog[0].valid.numel()


@pytest.mark.parametrize("workload,overrides", [("kitti_orb1200.seq128", SEQ),
                                                ("kitti_orb1200.fleet8x32", FLEET)])
def test_a_sound_run_is_correct(workload, overrides):
    line = _run(workload, overrides)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and set(line["metrics"]) == {"frames_per_s", "setup_s"} | (
        {"call_ms_p95"} if workload.endswith("seq128") else set())
    assert list(line)[-1] == "checks"


def test_a_traced_run_is_correct_and_reports_its_window():
    line = _run("kitti_orb1200.seq128", SEQ, trace=True)
    assert line["correct"] is True
    assert line["attempted"] == SEQ["trace_calls"]
    assert line["device"]["window_s"] > 0 and "breakdown" in line


def _moved_keypoint(fn):
    def faulty(frames, *a, **k):
        f = fn(frames, *a, **k)
        i = int(torch.nonzero(f.valid[0])[0])
        xy = f.xy.clone()
        xy[0, i, 0] += 1.0
        return f._replace(xy=xy)
    return faulty


def _half_batch(fn):
    """Features of the first half of the frames only, repeated."""
    def faulty(frames, *a, **k):
        f = fn(frames[: max(1, frames.shape[0] // 2)], *a, **k)
        n = frames.shape[0]
        return type(f)(*(x.repeat(math.ceil(n / x.shape[0]), *[1] * (x.dim() - 1))[:n]
                         for x in f))
    return faulty


def _rotated_pose(fn):
    """Pair 0's relative rotation turned by 2 degrees."""
    def faulty(*a, **k):
        est = dict(fn(*a, **k))
        c, s = math.cos(math.radians(2.0)), math.sin(math.radians(2.0))
        turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        R = est["R"].clone()
        R[0] = turn @ R[0]
        est["R"] = R
        return est
    return faulty


def _state_unchanged(fn):
    """The trajectory never leaves its first pose."""
    def faulty(*a, **k):
        out = fn(*a, **k)
        poses = out[0] if isinstance(out, tuple) and not isinstance(out, Pose) else out
        still = Pose(poses.R[..., :1, :, :].expand_as(poses.R).clone(),
                     poses.t[..., :1, :].expand_as(poses.t).clone())
        return (still, out[1]) if poses is not out else still
    return faulty


FAULTS = [("detect_frames", _moved_keypoint), ("detect_frames", _half_batch),
          ("estimate_pairs", _rotated_pose)]


@pytest.mark.parametrize("workload,overrides,module,stage3", [
    ("kitti_orb1200.seq128", SEQ, runner, "chain_relative_poses"),
    ("kitti_orb1200.fleet8x32", FLEET, sharding, "_chain_rows")])
@pytest.mark.parametrize("fault", FAULTS + [("stage3", _state_unchanged)],
                         ids=["moved_keypoint", "half_batch", "rotated_pose", "state_unchanged"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, overrides, module, stage3,
                                            fault):
    name, make = fault
    name = stage3 if name == "stage3" else name
    monkeypatch.setattr(module, name, make(getattr(module, name)))
    line = _run(workload, overrides)
    assert line["correct"] is False, line["checks"]


def test_forbidden_names_compare_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "tpu_vo_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_vo.features", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["tpu_vo.features"]
