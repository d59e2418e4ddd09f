"""Kernel B3's plain version (tpu_vo_torch.ops.fast.fast_margin and
fast_margin_levels on the CPU) and features/fast.detect and detect_levels
against tpu_vo's XLA formulation (fast_score_map, fast.detect on the CPU
backend) and against its Pallas `fast_margin_pallas` in interpret mode;
an emulation of the kernel's compass rejection; on a card, the CUDA
kernel against the plain version, one launch for all levels. Every
comparison is bit for bit. The JAX functions are jitted: FAST is
subtractions, mins and maxes of integers, which no fusion can round
differently.
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
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops import fast as tops, levels as tlevels
from tpu_vo_torch.ops.select import compass_candidates
from tpu_vo_torch.utils.synthetic import compass_pattern, make_sequence


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


@pytest.fixture(scope="module")
def pyramid():
    """A 3-level pyramid of two 240x160 frames (integer-grid levels)."""
    frames = np.stack(make_sequence(n_frames=2, width=240, height=160, seed=5)[0])
    return [lv.contiguous() for lv in build_pyramid(torch.from_numpy(frames), 3, 1.2)]


def test_fast_margin_levels_match_xla_and_detect_levels(pyramid):
    """One call for a pyramid: each level bit for bit tpu_vo's
    fast_score_map, and detect_levels each level's fast.detect (the CPU
    runs the plain version level by level and launches nothing)."""
    before = tops.fast_margin.launches
    got = tops.fast_margin_levels(pyramid, 10)
    det = tfast.detect_levels(pyramid, 10)
    assert tops.fast_margin.launches == before and len(got) == len(det) == 3
    for lv, (ts, tc), (ds, dk) in zip(pyramid, got, det):
        js, jc = (np.asarray(a) for a in _jscore(jnp.asarray(lv.numpy()), 10))
        assert jc.any()
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(tc.numpy(), jc)
        jscore, jkeep = (np.asarray(a) for a in _jdetect(jnp.asarray(lv.numpy()), 10))
        np.testing.assert_array_equal(ds.numpy(), jscore)
        np.testing.assert_array_equal(dk.numpy(), jkeep)
    for (_, k), (s, c) in zip(det, got):
        assert torch.equal(k, tfast.nonmax_suppress(s, c))


@pytest.mark.skipif(jax.default_backend() != "cpu",
                    reason="interpret-mode Pallas runs on the CPU backend only")
def test_fast_margin_levels_match_pallas_interpret(pyramid):
    lv = pyramid[2][:1]
    with pltpu.force_tpu_interpret_mode():
        ps, pc = (np.asarray(a) for a in fast_margin_pallas(jnp.asarray(lv[0].numpy()), 10))
    (ts, tc), = tops.fast_margin_levels([lv], 10)
    h, w = lv.shape[-2:]
    assert pc[:h, :w].any()
    np.testing.assert_array_equal(tc[0].numpy(), pc[:h, :w])
    np.testing.assert_array_equal(ts[0].numpy(), ps[:h, :w])


def _b3_emulated(img: torch.Tensor, thr: int):
    """Kernel B3's function as it computes it: the compass test rejects a
    pixel (score 0, no corner) unless two compass points lie past thr on
    one side; only the interior candidates get the arc scan."""
    h, w = img.shape[-2:]
    score, corner = tfast.fast_score_map(img, thr)
    cand = compass_candidates(img, thr) & tfast._border_mask(h, w, 3, img.device)
    zero = torch.zeros((), dtype=score.dtype)
    return torch.where(cand, score, zero), corner & cand, cand


@pytest.mark.parametrize("source", ["noise", "compass pattern"])
def test_b3_compass_rejection_drops_no_corner(source):
    """No pixel that the compass test rejects is a corner, at thresholds
    where pixels sit exactly at thr on the compass (the pattern), so the
    rejected kernel output equals the plain version."""
    rng = np.random.default_rng(3)
    for thr in (1, 10, 40):
        if source == "noise":
            img = torch.from_numpy(rng.integers(0, 256, (2, 37, 101)).astype(np.float32))
        else:
            img = torch.from_numpy(compass_pattern(2, 60, 90, thr, seed=thr))
        s, c, cand = _b3_emulated(img, thr)
        rs, rc = tfast.fast_score_map(img, thr)
        assert torch.equal(s, rs) and torch.equal(c, rc)
        assert not (rc & ~cand).any() and (~cand).any() and rc.any()


def test_fast_margin_levels_checks_input():
    with pytest.raises(ValueError):
        tops.fast_margin_levels([], 10)
    with pytest.raises(ValueError):
        tops.fast_margin_levels([torch.zeros(1, 16, 16, dtype=torch.float64)], 10)
    with pytest.raises(ValueError, match="unsupported levels"):
        tops.fast_margin_levels([torch.zeros(1, 16, 16, device="meta")], 10)
    t = tlevels.level_table([torch.zeros(2, 9, 11)], score=[torch.zeros(2, 9, 11)],
                            corner=[torch.zeros(2, 9, 11, dtype=torch.bool)])
    assert t.score[0] is not None and t.corner[0] is not None and t.score[1] is None


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [[(2, 376, 1241), (2, 313, 1034), (2, 37, 101), (2, 9, 11)],
                                    [(3, 64 + 9 * i, 90 + 13 * i) for i in range(10)]])
@pytest.mark.parametrize("thr", [10, 40])
def test_fast_margin_levels_kernel_matches_plain(cuda, shapes, thr):
    """One launch per 8 levels (10 levels: two), on noise and on the
    compass pattern; each level equals the plain version."""
    levels = [torch.from_numpy(_levels(s, seed=i)) for i, s in enumerate(shapes)]
    pattern = [torch.from_numpy(compass_pattern(s[0], *s[1:], thr, seed=i))
               for i, s in enumerate(shapes) if min(s[1:]) >= 7]
    for lvls in (levels, pattern):
        before = tops.fast_margin.launches
        got = tops.fast_margin_levels([lv.to(cuda) for lv in lvls], thr)
        torch.cuda.synchronize()
        assert tops.fast_margin.launches == before + -(-len(lvls) // tlevels.MAX_LEVELS)
        for lv, (ks, kc) in zip(lvls, got):
            rs, rc = tops.fast_margin_reference(lv, thr)
            assert torch.equal(ks.cpu(), rs) and torch.equal(kc.cpu(), rc)


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


def test_fast_ablation_cuts_apply():
    """Each of tools/fast_ablation's variants changes csrc/fast.cu where it
    names (the tool raises where a text moved; it runs on a card only)."""
    from tpu_vo_torch.tools import fast_ablation

    full = fast_ablation._source(())
    for label, cuts, _ in fast_ablation.VARIANTS[1:]:
        src = fast_ablation._source(cuts)
        assert src != full, label
        for cut in cuts:
            for old, _ in fast_ablation.CUT[cut]:
                assert full.count(old) == 1, (label, old)
    assert {c for _, cuts, _ in fast_ablation.VARIANTS for c in cuts} == set(fast_ablation.CUT)
