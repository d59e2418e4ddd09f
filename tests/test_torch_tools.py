"""The port's user tools and the public functions it lacked, against
tpu_vo's on the same inputs:

  - tools/make_synthetic_dataset (4 frames, 160x120, both scenes): the
    same file names, frames within one grey level on at most 0.2% of the
    pixels (test_torch_synthetic's bar), groundtruth_tum.txt within 1e-9,
    K.txt equal;
  - tools/evaluate_trajectory: the same JSON keys, values within 1e-9, on
    TUM and on KITTI files, each alignment;
  - image/pyramid.level_scales and features/patches.extract_patches
    (keypoints at every border and beyond, a level smaller than the
    window) exactly; geometry/conventions' text.
"""

import contextlib
import importlib.util
import io
import json
import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vo.features import patches as jpatches
from tpu_vo.geometry import conventions as jconventions
from tpu_vo.image import pyramid as jpyramid
from tpu_vo_torch.features import patches
from tpu_vo_torch.geometry import conventions
from tpu_vo_torch.image import pyramid
from tpu_vo_torch.io.dataset import load_frame
from tpu_vo_torch.tools import evaluate_trajectory, make_synthetic_dataset
from _torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_DIFF_SHARE = 0.002


def _jax_tool(name):
    """tools/<name>.py of the JAX package, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("scene", ["corridor", "planes"])
def test_make_synthetic_dataset_matches_tpu_vo(tmp_path, scene):
    args = ["--frames", "4", "--width", "160", "--height", "120", "--scene", scene, "--seed", "2"]
    ref, got = str(tmp_path / "ref"), str(tmp_path / "port")
    _run(_jax_tool("make_synthetic_dataset").main, [ref, *args])
    text = _run(make_synthetic_dataset.main, [got, *args])
    assert text.strip() == f"wrote 4 frames (160x120) + groundtruth to {got}"
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(got)) == sorted(
        [f"{i:06d}.png" for i in range(4)] + ["groundtruth_tum.txt", "K.txt"])
    a = np.stack([load_frame(os.path.join(ref, f"{i:06d}.png")) for i in range(4)]).astype(int)
    b = np.stack([load_frame(os.path.join(got, f"{i:06d}.png")) for i in range(4)]).astype(int)
    d = np.abs(a - b)
    assert a.shape == (4, 120, 160) and d.max() <= 1 and (d > 0).mean() <= MAX_DIFF_SHARE
    np.testing.assert_allclose(np.loadtxt(os.path.join(got, "groundtruth_tum.txt")),
                               np.loadtxt(os.path.join(ref, "groundtruth_tum.txt")),
                               rtol=0, atol=1e-9)
    with open(os.path.join(ref, "K.txt")) as f, open(os.path.join(got, "K.txt")) as g:
        assert f.read() == g.read()


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """An estimate and a ground truth, each written as TUM and as KITTI."""
    d = tmp_path_factory.mktemp("traj")
    rng = np.random.default_rng(4)
    n = 12
    gt_t = np.cumsum(rng.normal(0, 0.2, (n, 3)) + [0, 0, 1.0], 0)
    angles = np.cumsum(rng.normal(0, 0.05, n))
    gt_R = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
                     for a in angles])
    est_t = 0.3 * gt_t + rng.normal(0, 0.02, (n, 3))
    est_R = gt_R @ np.stack([np.eye(3) + 0.01 * np.array([[0, -1, 0], [1, 0, 0], [0, 0, 0]])] * n)
    from tpu_vo_torch.geometry.se3 import Pose
    from tpu_vo_torch.io.trajectory_io import save_trajectory_kitti, save_trajectory_tum

    files = {}
    for name, R, t in (("est", est_R, est_t), ("gt", gt_R, gt_t)):
        pose = Pose(torch.from_numpy(R), torch.from_numpy(t))
        files[name, "tum"] = str(d / f"{name}_tum.txt")
        files[name, "kitti"] = str(d / f"{name}_kitti.txt")
        save_trajectory_tum(files[name, "tum"], pose)
        save_trajectory_kitti(files[name, "kitti"], pose)
    return files


@pytest.mark.parametrize("align", ["none", "rigid", "scale"])
@pytest.mark.parametrize("formats", [("tum", "tum"), ("kitti", "kitti"), ("tum", "kitti")])
def test_evaluate_trajectory_matches_tpu_vo(trajectories, formats, align):
    argv = [trajectories["est", formats[0]], trajectories["gt", formats[1]], "--align", align]
    want = json.loads(_run(_jax_tool("evaluate_trajectory").main, argv))
    got = json.loads(_run(evaluate_trajectory.main, argv))
    assert list(got) == list(want)
    assert got["frames"] == 12 and got["align"] == align
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-9, (k, got[k], v)
        else:
            assert got[k] == v
    assert "rpe_rot_mean_deg" in got and "rpe_trans_rmse" in got


def test_level_scales_equal_tpu_vo():
    for n, f in ((8, 1.2), (1, 1.2), (4, 2.0), (12, 1.1)):
        assert pyramid.level_scales(n, f) == jpyramid.level_scales(n, f)


@pytest.mark.parametrize("shape", [(64, 90), (30, 60), (20, 25)])
def test_extract_patches_equals_dynamic_slice(shape):
    """Windows at every border, past each edge and at negative
    coordinates (which lax.dynamic_slice counts from the end), on a level
    larger and on levels smaller than the 43-px window."""
    h, w = shape
    rng = np.random.default_rng(h)
    lvl = rng.uniform(0, 255, shape).astype(np.float32)
    cy = [-30, -22, -1, 0, 1, 20, 21, 22, h // 2, h - 22, h - 21, h - 1, h, h + 25]
    cx = [-30, -21, -1, 0, 1, 20, 21, 22, w // 2, w - 22, w - 21, w - 1, w, w + 25]
    ys, xs = (np.array(v, np.int32).ravel() for v in np.meshgrid(cy, cx, indexing="ij"))
    want = np.asarray(jpatches.extract_patches(jnp.asarray(lvl), jnp.asarray(ys), jnp.asarray(xs)))
    got = patches.extract_patches(torch.from_numpy(lvl), torch.from_numpy(ys), torch.from_numpy(xs))
    assert got.shape == (len(ys), 43, 43) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    small = patches.extract_patches(torch.from_numpy(lvl), torch.from_numpy(ys),
                                    torch.from_numpy(xs), radius=3)
    want = np.asarray(jpatches.extract_patches(jnp.asarray(lvl), jnp.asarray(ys),
                                               jnp.asarray(xs), radius=3))
    np.testing.assert_array_equal(small.numpy(), want)


def test_conventions_text_equals_tpu_vo():
    doctrine = conventions.__doc__[conventions.__doc__.index("Pixels and points"):]
    ref = jconventions.__doc__[jconventions.__doc__.index("Pixels and points"):]
    assert doctrine == ref.replace("tpu_vo.geometry", "tpu_vo_torch.geometry")


@pytest.mark.parametrize("tool", ["evaluate_trajectory", "make_synthetic_dataset"])
def test_tools_run_as_modules(trajectories, tmp_path, monkeypatch, capsys, tool):
    """The tool's `__main__` entry (`python -m tpu_vo_torch.tools.<tool>`),
    run in this process from its file."""
    gt = trajectories["gt", "kitti"]
    argv = ([gt, gt] if tool == "evaluate_trajectory" else
            [str(tmp_path / "ds"), "--frames", "2", "--width", "64", "--height", "48",
             "--scene", "planes"])
    monkeypatch.setattr(sys, "argv", [tool, *argv])
    with pytest.raises(SystemExit) as info:
        runpy.run_path({"evaluate_trajectory": evaluate_trajectory,
                        "make_synthetic_dataset": make_synthetic_dataset}[tool].__file__,
                       run_name="__main__")
    assert info.value.code == 0
    out = capsys.readouterr().out
    if tool == "evaluate_trajectory":
        assert json.loads(out)["ate_rmse"] == 0.0
    else:
        assert sorted(os.listdir(tmp_path / "ds")) == [
            "000000.png", "000001.png", "K.txt", "groundtruth_tum.txt"]
