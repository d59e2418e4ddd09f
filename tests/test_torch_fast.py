"""Kernel B3's plain version (tpu_vo_torch.ops.fast.fast_margin on the
CPU) and features/fast.detect against tpu_vo's XLA formulation
(fast_score_map, fast.detect on the CPU backend) and, once, against its
Pallas `fast_margin_pallas` in interpret mode; on a card, the CUDA kernel
against the plain version. Every comparison is bit for bit. The JAX
functions are jitted: FAST is subtractions, mins and maxes of integers,
which no fusion can round differently.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_vo.features import fast as jfast
from tpu_vo.ops.fast_pallas import fast_margin_pallas
from tpu_vo_torch.features import fast as tfast
from tpu_vo_torch.ops import fast as tops


_jscore = jax.jit(jfast.fast_score_map)
_jdetect = jax.jit(jfast.detect, static_argnums=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B3 has no CPU mode")
    return torch.device("cuda")


def _levels(shape, seed=0):
    """Integer-grid float32 images: smooth blobs plus noise, so that FAST
    scores tie often and every threshold finds corners."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x / 5.0) * np.cos(y / 4.0)
    return np.clip(np.round(base + rng.normal(0, 25, shape)), 0, 255).astype(np.float32)


@pytest.mark.parametrize("shape", [(37, 101), (2, 37, 101), (96, 200), (3, 96, 200)])
@pytest.mark.parametrize("thr", [5, 10, 20, 40])
def test_fast_margin_and_detect_match_xla(shape, thr):
    img = _levels(shape)
    js, jc = (np.asarray(a) for a in _jscore(jnp.asarray(img), thr))
    batch = torch.from_numpy(img).reshape(-1, *shape[-2:])
    ts, tc = tops.fast_margin(batch, thr)
    assert jc.any()
    np.testing.assert_array_equal(ts.numpy().reshape(shape), js)
    np.testing.assert_array_equal(tc.numpy().reshape(shape), jc)

    jscore, jkeep = (np.asarray(a) for a in _jdetect(jnp.asarray(img), thr))
    tscore, tkeep = tfast.detect(torch.from_numpy(img), thr)
    np.testing.assert_array_equal(tscore.numpy(), jscore)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    _, traw = tfast.detect(torch.from_numpy(img), thr, nonmax=False)
    np.testing.assert_array_equal(traw.numpy(), jc)


@pytest.mark.parametrize("shape", [(7, 7), (9, 11), (1, 8, 8)])
def test_fast_margin_on_levels_near_the_support(shape):
    """Levels a little larger than the 7x7 support: the border mask and
    the wraparound of tpu_vo's rolls must give the same interior."""
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.float32)
    js, jc = (np.asarray(a) for a in _jscore(jnp.asarray(img), 10))
    ts, tc = tops.fast_margin(torch.from_numpy(img).reshape(-1, *shape[-2:]), 10)
    np.testing.assert_array_equal(ts.numpy().reshape(shape), js)
    np.testing.assert_array_equal(tc.numpy().reshape(shape), jc)


@pytest.mark.skipif(jax.default_backend() != "cpu",
                    reason="interpret-mode Pallas runs on the CPU backend only")
def test_fast_margin_matches_pallas_interpret():
    img = np.random.default_rng(0).integers(0, 255, (40, 100)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ps, pc = (np.asarray(a) for a in fast_margin_pallas(jnp.asarray(img), 10))
    ts, tc = tops.fast_margin(torch.from_numpy(img)[None], 10)
    assert pc.any()
    np.testing.assert_array_equal(tc[0].numpy(), pc)
    np.testing.assert_array_equal(ts[0].numpy(), ps)


def test_fast_margin_checks_input_and_counts_no_cpu_launch():
    before = tops.fast_margin.launches
    tops.fast_margin(torch.zeros(1, 16, 16), 10)
    assert tops.fast_margin.launches == before
    for bad in (torch.zeros(16, 16), torch.zeros(1, 16, 16, dtype=torch.float64)):
        with pytest.raises(ValueError):
            tops.fast_margin(bad, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.fast_margin(torch.zeros(1, 16, 16, device="meta"), 10)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 96, 200), (3, 376, 1241), (2, 105, 346),
                                   (1, 37, 101), (2, 9, 11)])
@pytest.mark.parametrize("thr", [10, 40])
def test_fast_kernel_matches_plain(cuda, shape, thr):
    img = torch.from_numpy(_levels(shape, seed=2))
    before = tops.fast_margin.launches
    ks, kc = tops.fast_margin(img.to(cuda), thr)
    torch.cuda.synchronize()
    assert tops.fast_margin.launches == before + 1
    rs, rc = tops.fast_margin_reference(img, thr)
    assert torch.equal(ks.cpu(), rs) and torch.equal(kc.cpu(), rc)
    ds, dk = tfast.detect(img.to(cuda), thr)
    assert torch.equal(dk.cpu(), tfast.detect(img, thr)[1])
