"""Kernel B1's plain version (tpu_vo_torch.ops.select) against tpu_vo's
Pallas `fused_select_maps` in interpret mode, and (on a card) the CUDA
kernel against the plain version.

Packed keys must match bit for bit over the shared region, and tpu_vo's
padding must be zero. Harris must match inside the border at rtol 2e-6,
atol 1e-12: the Pallas interpreter contracts a*b - c*c into an FMA, the
port rounds every product (tests/test_pallas_ops.py uses the same bar).
"""

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
from _torch_threads import _one_thread  # noqa: F401

pytestmark = pytest.mark.skipif(
    jax.default_backend() != "cpu",
    reason="interpret-mode Pallas runs on the CPU backend only")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B1 has no CPU mode")
    return torch.device("cuda")


def _compare(jp, jh, tp, th, h, w, border=31):
    jp, jh = np.asarray(jp), np.asarray(jh)
    hp2, wo = tp.shape[-2:]
    np.testing.assert_array_equal(jp[..., :hp2, :wo], tp.numpy())
    assert not jp[..., hp2:, :].any() and not jp[..., :, wo:].any()
    inner = np.zeros((h, w), bool)
    inner[border:h - border, border:w - border] = True
    np.testing.assert_allclose(jh[..., :h, :w][..., inner], th.numpy()[..., inner],
                               rtol=2e-6, atol=1e-12)
    assert not th.numpy()[..., ~inner].any()


def test_select_maps_matches_pallas_96x200():
    h, w = 96, 200
    img = np.random.default_rng(0).integers(0, 255, (h, w)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jp, jh, jbits = select_pallas.fused_select_maps(jnp.asarray(img), 10, 31)
    tp, th, tbits = tsel.select_maps(torch.from_numpy(img)[None], 10, 31)
    assert jbits == tbits
    assert (tp > 0).sum() > 100
    _compare(jp, jh, tp[0], th[0], h, w)


@pytest.mark.parametrize("level", [0, 2])
def test_select_maps_matches_pallas_on_pyramid_batch(level):
    frames = np.stack(make_sequence(n_frames=2, width=256, height=160, seed=5)[0])
    lv = build_pyramid(torch.from_numpy(frames), 3, 1.2)[level].contiguous()
    h, w = lv.shape[-2:]
    with pltpu.force_tpu_interpret_mode():
        jp, jh = jax.vmap(lambda im: select_pallas.fused_select_maps(im, 10, 31)[:2])(
            jnp.asarray(lv.numpy()))
    tp, th, _ = tsel.select_maps(lv, 10, 31)
    assert (tp > 0).sum() > 20
    _compare(jp, jh, tp, th, h, w)


def test_bit_reverse_matches_jax():
    for bits in (1, 9, 17, 23):
        x = np.random.default_rng(bits).integers(0, 1 << bits, 1000).astype(np.int32)
        np.testing.assert_array_equal(
            np.asarray(select_pallas._bit_reverse(jnp.asarray(x), bits)),
            tsel._bit_reverse(torch.from_numpy(x), bits).numpy())


def test_select_maps_rejects_bad_input():
    with pytest.raises(ValueError):
        tsel.select_maps(torch.zeros(1, 64, 64, dtype=torch.float64), 10, 31)
    with pytest.raises(ValueError):
        tsel.select_maps(torch.zeros(1, 64, 64), 10, 3)
    with pytest.raises(ValueError):
        tsel.select_maps(torch.zeros(64, 64), 10, 31)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 96, 200), (3, 376, 1241), (2, 105, 346), (1, 45, 37)])
def test_select_kernel_matches_plain(cuda, shape):
    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, shape, generator=g).float()
    before = tsel.select_maps.launches
    kp, kh, kb = tsel.select_maps(img.to(cuda), 10, 31)
    torch.cuda.synchronize()
    assert tsel.select_maps.launches == before + 1
    rp, rh, rb = tsel.select_maps_reference(img, 10, 31)
    assert kb == rb
    assert torch.equal(kp.cpu(), rp) and torch.equal(kh.cpu(), rh)
