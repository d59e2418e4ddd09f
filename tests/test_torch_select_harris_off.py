"""Kernel B1's Harris-off variant: the plain version of
select_maps(..., with_harris=False) against tpu_vo's Pallas
fused_select_maps(..., with_harris=False) in interpret mode (packed keys
bit for bit, Harris all zero on both sides), its packed keys equal to the
with-Harris call's, and (on a card) the CUDA instance against the plain
version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_vo.ops import select_pallas
from tpu_vo.utils.synthetic import make_sequence
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops import select as tsel

pytestmark = pytest.mark.skipif(
    jax.default_backend() != "cpu",
    reason="interpret-mode Pallas runs on the CPU backend only")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B1 has no CPU mode")
    return torch.device("cuda")


def _compare_off(jp, jh, tp, th):
    jp, jh = np.asarray(jp), np.asarray(jh)
    hp2, wo = tp.shape[-2:]
    np.testing.assert_array_equal(jp[..., :hp2, :wo], tp.numpy())
    assert not jp[..., hp2:, :].any() and not jp[..., :, wo:].any()
    assert not jh.any()
    assert not th.numpy().any() and th.dtype == torch.float32


def test_harris_off_matches_pallas_96x200():
    h, w = 96, 200
    img = np.random.default_rng(0).integers(0, 255, (h, w)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jp, jh, jbits = select_pallas.fused_select_maps(jnp.asarray(img), 10, 31,
                                                        with_harris=False)
    tp, th, tbits = tsel.select_maps(torch.from_numpy(img)[None], 10, 31, with_harris=False)
    assert jbits == tbits and th.shape == (1, h, w)
    assert (tp > 0).sum() > 100
    _compare_off(jp, jh, tp[0], th[0])


@pytest.mark.parametrize("level", [0, 2])
def test_harris_off_matches_pallas_on_pyramid_batch(level):
    frames = np.stack(make_sequence(n_frames=2, width=256, height=160, seed=5)[0])
    lv = build_pyramid(torch.from_numpy(frames), 3, 1.2)[level].contiguous()
    with pltpu.force_tpu_interpret_mode():
        jp, jh = jax.vmap(lambda im: select_pallas.fused_select_maps(
            im, 10, 31, with_harris=False)[:2])(jnp.asarray(lv.numpy()))
    [(tp, th, _)] = tsel.select_maps_levels([lv], 10, 31, with_harris=False)
    assert (tp > 0).sum() > 20
    _compare_off(jp, jh, tp, th)


def test_harris_off_packed_equals_harris_on():
    frames = np.stack(make_sequence(n_frames=2, width=200, height=120, seed=1)[0])
    levels = [lv.contiguous() for lv in build_pyramid(torch.from_numpy(frames), 3, 1.2)]
    on = tsel.select_maps_levels(levels, 10, 31)
    off = tsel.select_maps_levels(levels, 10, 31, with_harris=False)
    for (pt, ht, bt), (pf, hf, bf) in zip(on, off):
        assert bt == bf and torch.equal(pt, pf)
        assert ht.any() and not hf.any() and hf.shape == ht.shape


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 96, 200), (3, 376, 1241), (1, 45, 37)])
def test_harris_off_kernel_matches_plain(cuda, shape):
    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, shape, generator=g).float()
    before = (tsel.select_maps.launches, tsel.select_maps.launches_no_harris)
    kp, kh, kb = tsel.select_maps(img.to(cuda), 10, 31, with_harris=False)
    torch.cuda.synchronize()
    assert (tsel.select_maps.launches, tsel.select_maps.launches_no_harris) == (
        before[0] + 1, before[1] + 1)
    rp, rh, rb = tsel.select_maps_reference(img, 10, 31, with_harris=False)
    assert kb == rb and torch.equal(kp.cpu(), rp) and torch.equal(kh.cpu(), rh)
