"""Port detect_and_compute against tpu_vo's accelerator route (fused
select kernel + patch kernel, run by the Pallas interpreter).

The route is selected by making tpu_vo.features.fast._use_pallas return
True inside force_tpu_interpret_mode(); the JAX package is not changed.
(JAX's CPU route breaks stage-1 FAST ties by index, not by bit-reversed
index, so it is a different function.) On valid slots: xy, octave,
valid, angle and desc equal; response within rtol 2e-6 (the interpreter
contracts Harris' a*b - c*c into an FMA).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpu_vo.features.fast as jfast
from tpu_vo.configs import ORBConfig as JORBConfig
from tpu_vo.features.orb import detect_and_compute as jax_detect
from tpu_vo.utils.synthetic import make_sequence
from tpu_vo_torch import interop
from tpu_vo_torch.configs import ORBConfig
from tpu_vo_torch.features import orb as torb
from _torch_threads import _one_thread  # noqa: F401

pytestmark = pytest.mark.skipif(
    jax.default_backend() != "cpu",
    reason="interpret-mode Pallas runs on the CPU backend only")

N_FEATURES, N_LEVELS = 300, 3


@pytest.fixture(scope="module")
def frames():
    return np.stack(make_sequence(n_frames=2, width=256, height=160, seed=5)[0])


@pytest.fixture(scope="module")
def jax_features(frames):
    mp = pytest.MonkeyPatch()
    mp.setattr(jfast, "_use_pallas", lambda: True)
    try:
        with pltpu.force_tpu_interpret_mode():
            f = jax_detect(jnp.asarray(frames[0].astype(np.float32)),
                           JORBConfig(n_features=N_FEATURES, n_levels=N_LEVELS))
        return {k: np.asarray(v) for k, v in f._asdict().items()}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_features(frames):
    f = torb.detect_and_compute(torch.from_numpy(frames),
                                ORBConfig(n_features=N_FEATURES, n_levels=N_LEVELS))
    return interop.to_numpy(f)


def test_features_per_level_equal():
    from tpu_vo.features.orb import features_per_level as jfpl
    for args in [(1200, 8, 1.2), (300, 3, 1.2), (500, 4, 1.5)]:
        assert jfpl(*args) == torb.features_per_level(*args)


def test_detect_and_compute_matches_accelerator_route(jax_features, port_features):
    j = jax_features
    t = {k: v[0] for k, v in port_features.items()}
    np.testing.assert_array_equal(j["valid"], t["valid"])
    v = j["valid"]
    assert v.sum() >= 250
    for name in ("xy", "octave", "angle", "size"):
        np.testing.assert_array_equal(j[name][v], t[name][v], err_msg=name)
    np.testing.assert_allclose(j["response"][v], t["response"][v], rtol=2e-6, atol=0)
    bits_j = np.unpackbits(j["desc"][v], axis=-1)
    bits_t = np.unpackbits(t["desc"][v], axis=-1)
    diff = (bits_j != bits_t).sum(-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    same = diff == 0
    np.testing.assert_array_equal(j["desc32"][v][same], t["desc32"][v][same])


def test_batch_equals_single_frames(frames, port_features):
    cfg = ORBConfig(n_features=N_FEATURES, n_levels=N_LEVELS)
    for i in range(2):
        single = interop.to_numpy(torb.detect_and_compute(torch.from_numpy(frames[i]), cfg))
        for name, arr in single.items():
            np.testing.assert_array_equal(arr, port_features[name][i], err_msg=name)


@pytest.mark.parametrize("keep_ties", [False, True])
def test_rank_from_maps_matches(frames, keep_ties):
    """Stage-1 cut + stage-2 Harris ranking on the same select maps, with
    and without OpenCV's keep-ties retainBest (tpu_vo with its exact
    stage-1 cut, which the port always takes)."""
    from tpu_vo.features.orb import _rank_from_maps as jax_rank
    from tpu_vo_torch.ops.select import select_maps

    lvl = torch.from_numpy(frames.astype(np.float32))
    packed, hmap, bits = select_maps(lvl, 10, 31)
    h, w = lvl.shape[-2:]
    jcfg = JORBConfig(retain_best_keep_ties=keep_ties, stage1_exact_topk=True)
    tcfg = ORBConfig(retain_best_keep_ties=keep_ties)
    ys, xs, resp, valid = torb._rank_from_maps(packed, hmap, bits, w, 120, tcfg, h * w)
    for i in range(2):
        j = [np.asarray(a) for a in jax_rank(jnp.asarray(packed[i].numpy()),
                                             jnp.asarray(hmap[i].numpy()), bits, w, 120,
                                             jcfg, h * w)]
        np.testing.assert_array_equal(j[3], valid[i].numpy())
        v = j[3]
        assert v.sum() >= 100
        for a, b in zip(j[:3], (ys[i], xs[i], resp[i])):
            np.testing.assert_array_equal(a[v], b.numpy()[v])
