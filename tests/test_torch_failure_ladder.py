"""The reference's failure ladder (tests/test_failure_ladder.py's four rungs)
through the port's estimate_pair against tpu_vo's on the same features:

  (b) < 10 good matches        -> no pose (visual_odometry.cpp:340-345)
  (c) no valid descriptors     -> zero matches, every gate closed
  (d) junk geometry            -> matches but no pose_ok (:270-277)
  (e) healthy geometry         -> pose_ok, the rotation recovered

The port's RANSAC is fed tpu_vo's samples (its draw from the same key on
the same match mask): n_good, pose_ok and have_rt are equal, and the
inlier count too but on the degenerate rung, a chance consensus among
random points where float32 rounding may move one match across the
threshold (within 1). The rungs' features are made as
tests/test_failure_ladder.py makes them, each from a seed of its own.
Without tpu_vo's samples, pose_ok on the degenerate rung depends on the
draw in both packages (tpu_vo: keys 0 and 1 fail the gate, key 2 passes)."""

import jax
import numpy as np
import pytest
import torch

from tests.test_failure_ladder import N, make_features, perturb_bits, small_cfg
from tests.test_geometry import make_two_view_scene
from tpu_vo.estimation.ransac import _draw_samples
from tpu_vo.pipeline.step import estimate_pair as jestimate
from tpu_vo_torch import interop
from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.matching import adaptive_threshold_filter, mutual_nearest_match
from tpu_vo_torch.pipeline.step import estimate_pair
from _torch_threads import _one_thread  # noqa: F401


def _too_few(rng):
    shared = rng.integers(0, 2 ** 32, size=(6, 8), dtype=np.uint32)
    d1 = rng.integers(0, 2 ** 32, size=(N, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2 ** 32, size=(N, 8), dtype=np.uint32)
    d1[:6] = shared
    d2[:6] = shared
    return make_features(rng, d1), make_features(rng, d2), None


def _no_valid(rng):
    return make_features(rng, n_valid=0), make_features(rng, n_valid=0), None


def _degenerate(rng):
    d = rng.integers(0, 2 ** 32, size=(N, 8), dtype=np.uint32)
    return make_features(rng, d), make_features(rng, perturb_bits(rng, d)), None


def _healthy(rng):
    K, R, t, X, x1, x2 = make_two_view_scene(rng, n=N, w=256, h=256)
    d = rng.integers(0, 2 ** 32, size=(N, 8), dtype=np.uint32)
    return (make_features(rng, d, xy=x1.astype(np.float32)),
            make_features(rng, perturb_bits(rng, d), xy=x2.astype(np.float32)), R)


# rung: (features maker, seed, n_good, pose_ok)
RUNGS = {"b_too_few_matches": (_too_few, 0, None, False),
         "c_no_valid_descriptors": (_no_valid, 0, 0, False),
         "d_degenerate_geometry": (_degenerate, 1234, N, False),
         "e_healthy_geometry": (_healthy, 0, N, True)}


def _port(f):
    """tpu_vo's features as the port's, with a leading pair dimension."""
    return interop.features_from_numpy({k: np.asarray(v)[None] for k, v in f._asdict().items()})


def _rot_err_deg(R, R_gt):
    return np.degrees(np.arccos(np.clip((np.trace(R.T @ R_gt) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_rung_equals_tpu_vo(rung):
    make, seed, n_good, pose_ok = RUNGS[rung]
    f1, f2, R_gt = make(np.random.default_rng(seed))
    key = jax.random.PRNGKey(0)
    jcfg = small_cfg()
    j = jestimate(f1, f2, key, jcfg)
    cfg = VOConfig(image_width=256, image_height=256, orb=ORBConfig(n_features=N),
                   ransac=RansacConfig(max_iters=32))
    a, b = _port(f1), _port(f2)
    good, _ = adaptive_threshold_filter(
        mutual_nearest_match(a.desc32, b.desc32, a.valid, b.valid), cfg.match)
    idx = np.asarray(_draw_samples(key, jax.numpy.asarray(good.valid[0].numpy()),
                                   jcfg.ransac.max_iters, 5))
    p = estimate_pair(a, b, cfg, idx=torch.from_numpy(idx.astype(np.int64))[None])
    got = {k: p[k][0].item() for k in ("n_good", "pose_ok", "have_rt", "n_inliers")}
    want = {k: np.asarray(j[k]).item() for k in ("n_good", "pose_ok", "have_rt", "n_inliers")}
    assert (got["n_good"], got["pose_ok"], got["have_rt"]) == \
        (want["n_good"], want["pose_ok"], want["have_rt"])
    assert got["pose_ok"] == pose_ok
    if n_good is None:
        assert got["n_good"] < 10 and not got["have_rt"]
    else:
        assert got["n_good"] == n_good
    assert torch.isfinite(p["R"]).all()
    if rung.startswith("d_"):
        assert abs(got["n_inliers"] - want["n_inliers"]) <= 1
    else:
        assert got["n_inliers"] == want["n_inliers"]
    if R_gt is not None:
        assert _rot_err_deg(p["R"][0].double().numpy(), R_gt) < 0.5
