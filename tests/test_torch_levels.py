"""Kernels B1 and B2 launched once for all pyramid levels:
`select_maps_levels` and `extract_patches_levels` (tpu_vo_torch.ops), and
the compass test that lets B1 skip its FAST arc scan.

On the CPU both entry points run the per-level plain versions, which must
equal tpu_vo's Pallas kernels run by the interpreter (packed keys and
windows bit for bit; Harris at rtol 2e-6, atol 1e-12 inside the border,
because the interpreter contracts a*b - c*c into an FMA, as in
tests/test_torch_select.py). On a card, each launches its kernel once and
equals the plain versions bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_vo.ops import select_pallas
from tpu_vo.ops.patch_pallas import extract_patches_pallas
from tpu_vo_torch.features import fast
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops import levels as tlevels, patch as tpatch, select as tsel
from tpu_vo_torch.utils.synthetic import compass_pattern, make_sequence
from _torch_threads import _one_thread  # noqa: F401

THR, BORDER = 10, 31
interpret_only = pytest.mark.skipif(
    jax.default_backend() != "cpu",
    reason="interpret-mode Pallas runs on the CPU backend only")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1 and B2 have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pyramid():
    frames = np.stack(make_sequence(n_frames=1, width=200, height=120, seed=7)[0])
    return [lv.contiguous() for lv in build_pyramid(torch.from_numpy(frames), 3, 1.2)]


def _margin(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 margin, max(best dark arc, best bright arc), of every
    pixel (with wraparound, as fast_score_map computes it)."""
    d = torch.stack([img - fast._shift(img, dy, dx) for dx, dy in fast.CIRCLE_OFFSETS])
    d_ext = torch.cat([d, d[:8]], dim=0)
    return torch.maximum(fast._arc_margin(d_ext), fast._arc_margin(-d_ext))


def _assert_compass_exact(img: torch.Tensor, thr: int) -> torch.Tensor:
    cand = tsel.compass_candidates(img, thr)
    margin = _margin(img)
    _, corner = fast.fast_score_map(img, thr)
    assert not (corner & ~cand).any()
    assert not (margin[~cand] > thr).any()
    assert (margin > thr).any() and (~cand).any()
    return margin


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compass_rejects_only_non_corners_on_noise(seed):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.integers(0, 256, (2, 40, 56)).astype(np.float32))
    _assert_compass_exact(img, int(rng.integers(1, 60)))


def test_compass_rejects_only_non_corners_at_the_edge():
    """Centres with exactly 1 or 2 compass points past thr on each side:
    corners occur only where a side has 2, and the test keeps them."""
    img = torch.from_numpy(compass_pattern(2, 60, 90, THR, seed=4))
    margin = _assert_compass_exact(img, THR)
    cy, cx = (torch.from_numpy(a) for a in np.meshgrid(np.arange(3, 57, 7), np.arange(3, 87, 7),
                                                         indexing="ij"))
    d = torch.stack([img[:, cy + dy, cx + dx] for dx, dy in
                     (fast.CIRCLE_OFFSETS[j] for j in (0, 4, 8, 12))])
    d = img[:, cy, cx][None] - d
    dark, bright = (d > THR).sum(0), (-d > THR).sum(0)
    corner = margin[:, cy, cx] > THR
    assert {1, 2} <= set(dark.unique().tolist()) and {1, 2} <= set(bright.unique().tolist())
    assert corner[(dark == 2) | (bright == 2)].any()
    assert not corner[(dark == 1) & (bright == 1)].any()


@interpret_only
def test_select_maps_levels_equal_plain_and_pallas(pyramid):
    got = tsel.select_maps_levels(pyramid, THR, BORDER)
    assert len(got) == len(pyramid)
    for lv, (tp, th, tbits) in zip(pyramid, got):
        rp, rh, rbits = tsel.select_maps_reference(lv, THR, BORDER)
        assert tbits == rbits and torch.equal(tp, rp) and torch.equal(th, rh)
        h, w = lv.shape[-2:]
        with pltpu.force_tpu_interpret_mode():
            jp, jh, jbits = select_pallas.fused_select_maps(jnp.asarray(lv[0].numpy()), THR,
                                                            BORDER)
        assert jbits == tbits
        jp, jh = np.asarray(jp), np.asarray(jh)
        hp2, wo = tp.shape[-2:]
        np.testing.assert_array_equal(jp[:hp2, :wo], tp[0].numpy())
        assert not jp[hp2:, :].any() and not jp[:, wo:].any()
        inner = fast._border_mask(h, w, BORDER, "cpu").numpy()
        np.testing.assert_allclose(jh[:h, :w][inner], th[0].numpy()[inner], rtol=2e-6,
                                   atol=1e-12)
        assert not th[0].numpy()[~inner].any()
    assert sum(int((tp > 0).sum()) for tp, _, _ in got) > 20


def _slots(levels, counts, seed, edge=False):
    """int32 (B, N) slots, counts[l] for level l; with edge, keypoints up
    to 5 px past every edge, else 31 px inside with 2 invalid (0, 0)."""
    rng = np.random.default_rng(seed)
    b = levels[0].shape[0]
    ys, xs = [], []
    for lv, n in zip(levels, counts):
        h, w = lv.shape[-2:]
        lo, hy, hx = (-5, h + 5, w + 5) if edge else (31, h - 31, w - 31)
        y, x = rng.integers(lo, hy, (b, n)), rng.integers(lo, hx, (b, n))
        if not edge:
            y[:, :2], x[:, :2] = 0, 0
        ys.append(y)
        xs.append(x)
    offsets = np.cumsum([0, *counts])[:-1].tolist()
    as_t = lambda a: torch.from_numpy(np.concatenate(a, 1).astype(np.int32))
    return as_t(ys), as_t(xs), offsets


@interpret_only
def test_extract_patches_levels_equal_plain_and_pallas(pyramid):
    ys, xs, offsets = _slots(pyramid, (13, 9, 6), seed=0)
    got = tpatch.extract_patches_levels(pyramid, ys, xs, offsets)
    assert got.shape == (1, 28, 43, 43)
    for lv, a, e in zip(pyramid, offsets, offsets[1:] + [28]):
        ref = tpatch.extract_patches_reference(lv, ys[:, a:e], xs[:, a:e])
        assert torch.equal(got[:, a:e], ref)
        with pltpu.force_tpu_interpret_mode():
            jw = np.asarray(extract_patches_pallas(jnp.asarray(lv[0].numpy()),
                                                   jnp.asarray(ys[0, a:e].numpy()),
                                                   jnp.asarray(xs[0, a:e].numpy())))
        np.testing.assert_array_equal(got[0, a:e].numpy(), jw[:, :43, :])


def test_extract_patches_levels_equal_plain_at_every_edge():
    g = torch.Generator().manual_seed(1)
    levels = [torch.randint(0, 256, (2, h, w), generator=g).float()
              for h, w in ((30, 60), (64, 100), (45, 43))]
    ys, xs, offsets = _slots(levels, (17, 12, 8), seed=1, edge=True)
    got = tpatch.extract_patches_levels(levels, ys, xs, offsets)
    ref = torch.cat([tpatch.extract_patches_reference(lv, ys[:, a:e], xs[:, a:e])
                     for lv, a, e in zip(levels, offsets, offsets[1:] + [37])], 1)
    assert torch.equal(got, ref)


def test_level_entry_points_reject_bad_input():
    lv = torch.zeros(1, 64, 64)
    ys = torch.zeros(1, 6, dtype=torch.int32)
    for n, offsets in ((2, [0]), (2, [1, 3]), (2, [0, 7]), (3, [0, 4, 2])):
        with pytest.raises(ValueError):
            tpatch.extract_patches_levels([lv] * n, ys, ys, offsets)
    with pytest.raises(ValueError):
        tsel.select_maps_levels([], THR, BORDER)
    with pytest.raises(ValueError):
        tlevels.check_levels([lv] * (tlevels.MAX_LEVELS + 1))
    with pytest.raises(ValueError):
        tlevels.check_levels([lv, torch.zeros(2, 64, 64)])


def test_level_table_layout():
    lvs = [torch.zeros(2, 37, 101), torch.zeros(2, 9, 11)]
    t = tlevels.level_table(lvs, [0, 12], 14)
    assert (t.n, t.total, list(t.H[:2]), list(t.W[:2])) == (2, 14, [37, 9], [101, 11])
    assert (list(t.Hp2[:2]), list(t.Wout[:2]), list(t.first[:2])) == ([19, 5], [102, 12], [0, 12])
    assert t.img[0] == lvs[0].data_ptr() and t.packed[0] is None


@pytest.mark.cuda
def test_select_maps_levels_kernel_matches_plain(cuda):
    noise = np.random.default_rng(0).integers(0, 256, (2, 376, 1241)).astype(np.float32)
    levels = [lv.contiguous() for lv in build_pyramid(torch.from_numpy(noise), 8, 1.2)]
    pattern = [torch.from_numpy(compass_pattern(2, *lv.shape[-2:], THR, seed=i))
               for i, lv in enumerate(levels)]
    for lvls in (levels, pattern, levels + pattern[:3]):
        before = tsel.select_maps.launches
        got = tsel.select_maps_levels([lv.to(cuda) for lv in lvls], THR, BORDER)
        torch.cuda.synchronize()
        assert tsel.select_maps.launches == before + -(-len(lvls) // tlevels.MAX_LEVELS)
        for lv, (kp, kh, kb) in zip(lvls, got):
            rp, rh, rb = tsel.select_maps_reference(lv, THR, BORDER)
            assert kb == rb and torch.equal(kp.cpu(), rp) and torch.equal(kh.cpu(), rh)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
def test_extract_patches_levels_kernel_matches_plain(cuda, b):
    g = torch.Generator().manual_seed(b)
    levels = [torch.randint(0, 256, (b, h, w), generator=g).float()
              for h, w in ((30, 60), (376, 1241), (105, 346))]
    ys, xs, offsets = _slots(levels, (17, 300, 40), seed=b, edge=True)
    before = tpatch.extract_patches.launches
    got = tpatch.extract_patches_levels([lv.to(cuda) for lv in levels], ys.to(cuda),
                                        xs.to(cuda), offsets)
    torch.cuda.synchronize()
    assert tpatch.extract_patches.launches == before + 1
    assert torch.equal(got.cpu(), tpatch.extract_patches_levels(levels, ys, xs, offsets))


@pytest.mark.cuda
def test_level_kernels_split_past_max_levels(cuda):
    """11 levels: two launches of each kernel, the same outputs."""
    g = torch.Generator().manual_seed(5)
    levels = [torch.randint(0, 256, (2, 64 + 7 * i, 80 + 11 * i), generator=g).float()
              for i in range(11)]
    ys, xs, offsets = _slots(levels, [5 + i for i in range(11)], seed=5, edge=True)
    before = (tsel.select_maps.launches, tpatch.extract_patches.launches)
    maps = tsel.select_maps_levels([lv.to(cuda) for lv in levels], THR, 4)
    got = tpatch.extract_patches_levels([lv.to(cuda) for lv in levels], ys.to(cuda),
                                        xs.to(cuda), offsets)
    torch.cuda.synchronize()
    assert (tsel.select_maps.launches, tpatch.extract_patches.launches) == (before[0] + 2,
                                                                           before[1] + 2)
    for lv, (kp, kh, _) in zip(levels, maps):
        rp, rh, _ = tsel.select_maps_reference(lv, THR, 4)
        assert torch.equal(kp.cpu(), rp) and torch.equal(kh.cpu(), rh)
    assert torch.equal(got.cpu(), tpatch.extract_patches_levels(levels, ys, xs, offsets))


def test_select_ablation_variants_apply():
    """Each of tools/select_ablation's variants switches off its phases in
    the current csrc/select.cu (the tool raises where a phase moved)."""
    from tpu_vo_torch.tools import select_ablation

    full = select_ablation._source(())
    for _, parts in select_ablation.VARIANTS[1:]:
        assert select_ablation._source(parts) != full
