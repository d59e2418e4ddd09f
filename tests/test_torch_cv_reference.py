"""The port's copy of the OpenCV reference (utils/cv_reference) equals
tpu_vo's on the same frames, legacy and seeded RANSAC alike, and its
band (tools/reference_band.ref_with_band) equals the JAX benchmark's."""

import importlib.util
import os

import numpy as np
import pytest

from tpu_vo.utils import cv_reference as jref
from tpu_vo.utils.synthetic import make_sequence
from tpu_vo_torch.tools import reference_band
from tpu_vo_torch.utils import cv_reference as tref
from _torch_threads import _one_thread  # noqa: F401

HARNESS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "benchmarks", "run_benchmarks.py")
W, H, T = 320, 240, 6
FRAMES = make_sequence(n_frames=T, width=W, height=H, seed=1)[0]


@pytest.mark.parametrize("state", [None, 12345, 12349])
def test_reference_vo_equals_tpu_vo(state):
    a, b = jref.ReferenceVO(W, H, ransac_state=state), tref.ReferenceVO(W, H, ransac_state=state)
    ta, tb = a.run(FRAMES), b.run(FRAMES)
    assert ta.shape == (T, 3)
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(a.rotations(), b.rotations())
    np.testing.assert_array_equal(a.last_F, b.last_F)
    assert np.abs(tb[-1]).sum() > 0  # it moved


def test_error_helpers_equal():
    ta = jref.ReferenceVO(W, H).run(FRAMES)
    tb = tref.ReferenceVO(W, H, ransac_state=1).run(FRAMES)
    assert jref.absolute_trajectory_error(ta, tb) == tref.absolute_trajectory_error(ta, tb)
    R = np.stack([np.eye(3)] * T)
    assert jref.relative_pose_error(R, R) == tref.relative_pose_error(R, R) == 0.0


def test_band_equals_the_benchmark_harness():
    spec = importlib.util.spec_from_file_location("jax_run_benchmarks", HARNESS)
    run_benchmarks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_benchmarks)
    traj, rots, band, rels, ext = reference_band.ref_with_band(W, H, FRAMES)
    traj_j, band_j, _, rots_j = run_benchmarks.ref_with_band(W, H, FRAMES)
    np.testing.assert_array_equal(traj, traj_j)
    np.testing.assert_array_equal(rots, rots_j)
    assert round(band, 4) == band_j and len(rels) == reference_band.SEEDS
    assert max(rels) == band and ext > 0
