"""Kernels P1, P2 and P3 (tpu_vo_torch.ops.patch_probe) against the
Pallas kernels of tools/patch_slots_probe.py in interpret mode, bit for
bit (tolerance 0), on uniform non-integer f32 pixels and keypoints up to
5 px past each edge: P1's right-edge clamp, P1's roll wrapping at 128
lanes, and P2's and P3's zero tail rows. Then P2's three-way bf16 split
and the band copy of P2 and P3 from the unpadded level (emulated), what
the port refuses, the port of the probe tool on the CPU, and, on a card,
each kernel against its plain version, also on pixels across 41 binades.

Importing tools/patch_slots_probe.py points JAX's compilation cache at
another directory and changes its thresholds (`:30-35`); the module
fixture restores them, so later files on the same worker keep
conftest's.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops import patch as tpatch, patch_probe as pp
from tpu_vo_torch.tools import patch_slots_probe as tprobe
from tpu_vo_torch.utils.synthetic import make_sequence

_CACHE_SETTINGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                   "jax_persistent_cache_min_entry_size_bytes")
_cpu_only = pytest.mark.skipif(jax.default_backend() != "cpu",
                               reason="interpret-mode Pallas runs on the CPU backend only")


@pytest.fixture(scope="module")
def jprobe():
    saved = {k: getattr(jax.config, k) for k in _CACHE_SETTINGS}
    try:
        mod = importlib.import_module("tools.patch_slots_probe")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    assert {k: getattr(jax.config, k) for k in _CACHE_SETTINGS} == saved
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels P1-P3 have no CPU mode")
    return torch.device("cuda")


def _level(b, h, w, n, seed):
    """Uniform non-integer f32 pixels, keypoints from 5 px before to 5 px
    past each edge."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    ys = rng.integers(-5, h + 5, (b, n)).astype(np.int32)
    xs = rng.integers(-5, w + 5, (b, n)).astype(np.int32)
    return img, ys, xs


def _wide():
    """(1, 64, 1241) with keypoints at x = 1170, 1180, 1200 and 1240."""
    img, ys, xs = _level(1, 64, 1241, 24, 0)
    xs[0, :4] = (1170, 1180, 1200, 1240)
    return img, ys, xs


def _interpret(build_fn, args, img, ys, xs):
    with pltpu.force_tpu_interpret_mode():
        run = build_fn.__wrapped__(*args)
        return np.asarray(run(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs)))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@_cpu_only
@pytest.mark.parametrize("variant", [(8, 2, True, 256), (8, 4, False, 128),
                                     (8, 4, True, 128), (8, 4, True, 512)])
def test_band_windows_match_pallas(jprobe, variant):
    kp_chunk, nslots, compact, lanes = variant
    img, ys, xs = _wide()
    ref = _interpret(jprobe.build, (1, 64, 1241, 24, *variant), img, ys, xs)
    got = pp.band_windows(*_torch(img, ys, xs), kp_chunk, nslots, compact, lanes).numpy()
    np.testing.assert_array_equal(got, ref)
    if variant == (8, 2, True, 256):
        # the right-edge clamp: x = 1180 and 1200 (>= 1173) come out
        # shifted left of the window at c0 = x - 21; x = 1170 does not
        for k, shifted in ((0, False), (1, True), (2, True)):
            r0 = int(np.clip(ys[0, k] - 21, 0, 64 - 48))
            window = img[0, r0:r0 + 48, xs[0, k] - 21:xs[0, k] + 22]
            assert (not np.array_equal(got[0, k], window)) == shifted, k


@_cpu_only
@pytest.mark.parametrize("kernel", ["mxu", "roll"])
def test_phase_windows_match_pallas(jprobe, kernel):
    img, ys, xs = _level(2, 64, 300, 24, 1)
    assert (img != np.round(img)).mean() > 0.99
    build_fn = jprobe.build_v2 if kernel == "mxu" else jprobe.build_v3
    ref = _interpret(build_fn, (2, 64, 300, 24, 8, 4), img, ys, xs)
    fn = pp.phase_windows_mxu if kernel == "mxu" else pp.phase_windows_roll
    got = fn(*_torch(img, ys, xs), 8, 4).numpy()
    np.testing.assert_array_equal(got, ref)
    tail = (np.clip(ys - 21, 0, 64 - 48) & 3)
    assert (tail > 0).sum() > 5
    for bi, k in zip(*np.nonzero(tail)):
        assert (got[bi, k, 48 - tail[bi, k]:] == 0).all()
        assert (got[bi, k, :48 - tail[bi, k]] != 0).any()


@_cpu_only
def test_band_windows_refuse_what_pallas_cannot_read(jprobe):
    """512 lanes at w = 300: the Pallas copy would start at column -128,
    which the interpreter reports as an out-of-bounds read."""
    img, ys, xs = _level(2, 64, 300, 24, 1)
    with pytest.raises(Exception, match="Out-of-bounds"):
        _interpret(jprobe.build, (2, 64, 300, 24, 8, 4, True, 512), img, ys, xs)
    with pytest.raises(ValueError, match="512-lane band"):
        pp.band_windows(*_torch(img, ys, xs), 8, 4, True, 512)


@pytest.mark.parametrize("shape", [(1, 47, 300), (1, 64, 42)])
def test_windows_refuse_levels_smaller_than_the_window(shape):
    img = torch.zeros(shape)
    ys = xs = torch.zeros((1, 4), dtype=torch.int32)
    for fn in (lambda: pp.band_windows(img, ys, xs, 8, 2),
               lambda: pp.phase_windows_mxu(img, ys, xs),
               lambda: pp.phase_windows_roll(img, ys, xs)):
        with pytest.raises(ValueError, match="smaller than the 48x43 window"):
            fn()


def test_shared_memory_fit():
    """Only nslots x slot within 232,448 B fits; P2's production (32, 16)
    needs 393,216 B of bands. A P1 slot holds the (48, 43) window, 8,256 B
    at any lanes: 28 fit (the TPU kernel's (56, 256) band took 57,344 B,
    and 4 fitted). P2's and P3's slots hold the band alone (no zero rows,
    no separate stage): 9 fit."""
    assert pp.smem_bytes("P1", 4, 256) == (8_256, 33_024)
    assert pp.smem_bytes("P1", 28, 512) == (8_256, 231_168)
    assert pp.slot_warps(8) == 8 and pp.slot_warps(1) == 1 and pp.slot_warps(40) == 8
    assert pp.smem_bytes("P2", 8) == (24_576, 196_608)
    assert pp.smem_bytes("P3", 8) == (24_576, 196_608)
    for kernel, nslots, lanes in (("P1", 4, 256), ("P1", 2, 512), ("P1", 16, 256),
                                  ("P1", 28, 128), ("P2", 8, 128), ("P2", 9, 128),
                                  ("P3", 8, 128), ("P3", 9, 128)):
        pp.check_fits(kernel, nslots, lanes)
    for kernel, nslots, lanes in (("P1", 29, 256), ("P1", 32, 128), ("P2", 10, 128),
                                  ("P2", 16, 128), ("P3", 10, 128), ("P3", 16, 128)):
        with pytest.raises(ValueError, match=r"does not fit \(\d+ x [\d,]+ B"):
            pp.check_fits(kernel, nslots, lanes)


def _footprint(h, w, ys, xs, compact, lanes):
    """(rows (B, N, 48), cols (B, N, 43)): the level pixels that P1's
    kernel copies into each window, by its own formula (`BandWindow` in
    csrc/patch_probe.cu): column col + j, less `lanes` from j = wrap on,
    where the roll wraps."""
    r0 = torch.clamp(ys.long() - 21, 0, h - 48)
    c0 = torch.clamp(xs.long() - 21, 0, w - 43)
    c128 = c0 & ~127
    cc = torch.clamp(c128, max=(w // 128 + 1) * 128 - lanes)
    if compact:
        row, coff = r0, c0 - c128
    else:
        hp = max((h + 7) & ~7, 56)
        row, coff = torch.clamp(r0 & ~7, 0, max(hp - 56, 0)), torch.zeros_like(c0)
    j = torch.arange(43)
    cols = (cc + coff)[..., None] + j - torch.where(j >= (lanes - coff)[..., None], lanes, 0)
    return row[..., None] + torch.arange(48), cols


@pytest.mark.parametrize("w", [1241, 1100, 300])
@pytest.mark.parametrize("lanes", [128, 256, 512])
def test_band_footprint_copy_equals_the_padded_band(w, lanes):
    """P1's kernel copies each window's own elements from the caller's
    level (emulated by `_footprint`), 0 past its edge, where the TPU kernel rolls
    a band of the padded level: emulated here, bit for bit the plain
    version, compact and not, with keypoints at the right and bottom
    edges. At 128 lanes the roll wraps, and the window's columns are two
    runs of the level; at 256 and 512 lanes windows near the right edge
    come out shifted left (the band's clamp). No element reads the pad: rows stay
    below r0 + 48 <= h (r8 <= r0), columns below floor128(c0) + 43 <=
    c0 + 43 <= w with compact (where the clamp and the wrap only move
    left) and without."""
    img, ys, xs = _level(2, 64, w, 40, 6)
    xs[:, :8] = (w - 1, w + 3, w - 22, w - 44, w - 60, w - 70, w - 130, 1180 % w)
    ys[:, 8:12] = (63, 68, 40, 44)
    img, ys, xs = _torch(img, ys, xs)
    if (w // 128 + 1) * 128 < lanes:
        with pytest.raises(ValueError, match="lane band is wider"):
            pp.band_windows(img, ys, xs, 8, 2, True, lanes)
        return
    for compact in (True, False):
        rows, cols = _footprint(64, w, ys, xs, compact, lanes)
        assert (rows >= 0).all() and (rows < 64).all()
        assert (cols >= 0).all() and (cols < w).all()
        bi = torch.arange(2)[:, None, None, None]
        got = img[bi, rows[..., None], cols[..., None, :]]
        assert torch.equal(got, pp.band_windows_reference(img, ys, xs, compact, lanes))
        assert torch.equal(got, pp.band_windows(img, ys, xs, 8, 2, compact, lanes))
        two_runs = (cols.diff(dim=-1) != 1).any(-1)
        assert two_runs.any() == (compact and lanes == 128)
        if compact:  # the clamp of the band's column shifts windows left
            shifted = cols[..., 0] < torch.clamp(xs.long() - 21, 0, w - 43)
            assert shifted.any() == (lanes > 128)


def _split_input(name):
    if name == "integers":
        return torch.arange(256, dtype=torch.float32)
    if name == "pyramid level":
        frames = np.stack(make_sequence(n_frames=1, width=160, height=120, seed=0)[0])
        return build_pyramid(torch.from_numpy(frames), 3, 1.2)[2].flatten()
    rng = np.random.default_rng(5)
    x = rng.uniform(1, 2, 4000) * 2.0 ** rng.integers(-100, 100, 4000)
    x *= rng.choice([-1, 1], 4000)
    x[:10] = 0.0  # +0: a -0 comes out +0, equal in value but not in bits
    x[10:20] = 2.0 ** -100
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("name", ["integers", "pyramid level", "binades"])
def test_bf16_split_is_exact(name):
    """P2's split: each part is a bfloat16 value, and (hi + mid) + lo is
    x bit for bit."""
    x = _split_input(name)
    hi, mid, lo = pp.bf16_split(x)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).to(torch.float32).view(torch.int32),
                           part.view(torch.int32))
    assert torch.equal(((hi + mid) + lo).view(torch.int32), x.view(torch.int32))
    if name == "binades":
        assert (lo != 0).float().mean() > 0.9  # every part carries bits


def _bands(img, ys, xs, fill=0.0):
    """(bands (B, N, 48, 128), roff, coff): the kernels' band copy,
    emulated from the unpadded level by `phase_band`, with `fill` past
    the level's last column."""
    b, h, w = img.shape
    row, col, roff, coff, ncols = pp.phase_band(h, w, ys, xs)
    assert (row + pp.ROWS <= h).all() and (ncols >= coff + 43).all()
    rows = row[..., None, None] + torch.arange(pp.ROWS)[:, None]
    cols = col[..., None, None] + torch.arange(pp.PHASE_LANES)
    bi = torch.arange(b)[:, None, None, None]
    band = img[bi, rows, torch.clamp(cols, max=w - 1)]
    inside = cols < col[..., None, None] + ncols[..., None, None]
    return torch.where(inside, band, fill), roff, coff


def _p2_products(bands, roff, coff):
    """P2's arithmetic: per bf16 part, (48, 128) x oh_c then oh_r x that,
    the parts added as (hi + mid) + lo."""
    oh_c = (torch.arange(128)[:, None] == torch.arange(43) + coff[..., None, None]).float()
    oh_r = (torch.arange(48) == torch.arange(48)[:, None] + roff[..., None, None]).float()
    hi, mid, lo = (oh_r @ (part @ oh_c) for part in pp.bf16_split(bands))
    return (hi + mid) + lo


@pytest.mark.parametrize("w", [1241, 301])
def test_phase_bands_come_from_the_unpadded_level(w):
    """P2 and P3 copy their bands from the caller's level, zero past its
    width: the windows read out of them (P3's roll and row offset, P2's
    split one-hot products) are the plain version's, with keypoints at
    the right edge. Past the width the zeros matter to P2: a NaN there
    would reach its windows."""
    img, ys, xs = _level(2, 64, w, 24, 4)
    xs[:, :6] = (w - 70, w - 44, w - 22, w - 1, w + 3, w - 60)
    img, ys, xs = _torch(img, ys, xs)
    ref = pp.phase_windows_reference(img, ys, xs)
    bands, roff, coff = _bands(img, ys, xs)
    r, c = torch.arange(48)[:, None], torch.arange(43)
    src = (roff[..., None, None] + r).clamp(max=47) * 128 + coff[..., None, None] + c
    p3 = torch.gather(bands.flatten(2), 2, src.flatten(2)).view(ref.shape)
    assert torch.equal(torch.where(r + roff[..., None, None] < 48, p3, 0.0), ref)
    assert torch.equal(_p2_products(bands, roff, coff), ref)
    nan_bands, _, _ = _bands(img, ys, xs, fill=float("nan"))
    assert torch.isnan(_p2_products(nan_bands, roff, coff)[:, :6]).any()


def test_phase_windows_equal_b2_above_the_bottom_rows():
    """P2/P3's rows [:43] are B2's window wherever the two row clamps
    (H - 48 and H - 43) agree, y <= H - 27; every row has values there."""
    img, ys, xs = _torch(*_level(2, 96, 200, 300, 2))
    got = pp.phase_windows_reference(img, ys, xs)
    b2 = tpatch.extract_patches(img, ys, xs)
    same = ys <= 96 - 27
    assert same.sum() > 100 and (~same).sum() > 5
    assert torch.equal(got[:, :, :43][same], b2[same])
    assert not torch.equal(got[:, :, :43][~same], b2[~same])


def test_probe_main_on_the_cpu(capsys):
    rows = tprobe.main(device="cpu", shape=(2, 64, 300, 24), reps=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(rows) == 1 + 12 + 3 + 2
    refused = [r["label"] for r in rows if r["refused"]]
    assert refused == ["chunk=32 slots=16 compact=1 lanes=512"]
    assert "refused, a 512-lane band" in lines[12]
    assert rows[1]["args"] == {"kp_chunk": 8, "nslots": 2, "compact": True, "lanes": 256}
    assert [r["match"] for r in rows if r["kernel"] in ("P2", "P3")] == [True] * 5
    assert all(r["ms"] is None for r in rows)


def test_probe_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprobe.main(["p1"])
    with pytest.raises(SystemExit):
        tprobe.main(["p4"], device="cpu")
    run = tprobe.build_v3(8, 4)
    assert run.func is pp.phase_windows_roll and run.keywords == {"kp_chunk": 8, "nslots": 4}
    with pytest.raises(ValueError, match="must be int32 of shape"):
        run(torch.zeros(1, 64, 300), torch.zeros((2, 24), dtype=torch.int32),
            torch.zeros((2, 24), dtype=torch.int32))


_KERNELS = {
    "P1 8,2,T,256": (lambda *a: pp.band_windows(*a, 8, 2, True, 256),
                     lambda *a: pp.band_windows_reference(*a, True, 256), pp.band_windows),
    "P1 8,4,F,128": (lambda *a: pp.band_windows(*a, 8, 4, False, 128),
                     lambda *a: pp.band_windows_reference(*a, False, 128), pp.band_windows),
    "P1 8,4,T,128": (lambda *a: pp.band_windows(*a, 8, 4, True, 128),
                     lambda *a: pp.band_windows_reference(*a, True, 128), pp.band_windows),
    "P2 16,8": (lambda *a: pp.phase_windows_mxu(*a, 16, 8), pp.phase_windows_reference,
                pp.phase_windows_mxu),
    "P3 16,8": (lambda *a: pp.phase_windows_roll(*a, 16, 8), pp.phase_windows_reference,
                pp.phase_windows_roll),
    "P2 8,4 binades": (lambda *a: pp.phase_windows_mxu(*a, 8, 4), pp.phase_windows_reference,
                       pp.phase_windows_mxu),
    "P3 8,4 binades": (lambda *a: pp.phase_windows_roll(*a, 8, 4), pp.phase_windows_reference,
                       pp.phase_windows_roll),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_KERNELS))
def test_probe_kernel_matches_plain(cuda, name):
    fn, ref, wrapper = _KERNELS[name]
    img, ys, xs = _torch(*_level(2, 376, 1241, 300, 3))
    if name.endswith("binades"):
        img = torch.from_numpy(tprobe.binade_levels(2, 376, 1241, seed=3))
    before = wrapper.launches
    got = fn(img.to(cuda), ys.to(cuda), xs.to(cuda))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got.cpu(), ref(img, ys, xs))


def test_phase_ablation_cuts_apply():
    """Each of tools/phase_ablation's cuts changes csrc/patch_probe.cu in
    the one place it names (the tool itself runs on a card only)."""
    from tpu_vo_torch.ops import _build as pp_build
    from tpu_vo_torch.tools import phase_ablation

    with open(os.path.join(pp_build.CSRC, "patch_probe.cu")) as f:
        full = f.read()
    for cut, (old, new) in phase_ablation.CUT.items():
        src = phase_ablation._source(cut)
        assert src != full and src.count(new) == 1
    assert {c for _, _, c, _ in phase_ablation.VARIANTS} == {None, *phase_ablation.CUT}


@pytest.mark.cuda
def test_probe_kernel_refuses_slots_that_do_not_fit(cuda):
    img = torch.zeros((1, 64, 300), device=cuda)
    ys = xs = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        pp.phase_windows_mxu(img, ys, xs, 32, 16)
