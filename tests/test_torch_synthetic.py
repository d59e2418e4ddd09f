"""The port's corridor, pan and planes scenes (utils/synthetic, numpy and
scipy; the planes are make_sequence's) against tpu_vo's cv2 renders:
poses and K equal bit for bit; frames within one grey level, on at most
0.2% of the pixels (measured at 320x240, T = 3, seed 3: 96 and 116 of
230,400 pixels differ, all by 1, in the corridor and the pan). The steps that make them are held against
cv2 one by one."""

import functools

import cv2
import numpy as np
import pytest

from tpu_vo.utils import synthetic as js
from tpu_vo_torch.utils import synthetic as ts

W, H, T, SEED = 320, 240, 3, 3
MAX_DIFF_SHARE = 0.002


@functools.lru_cache(maxsize=None)
def _both(scene):
    make = js.make_sequence if scene == "planes" else getattr(js, f"make_{scene}_sequence")
    return make(n_frames=T, width=W, height=H, seed=SEED), ts.render(scene, T, W, H, SEED)


@pytest.mark.parametrize("scene", ["corridor", "pan", "planes"])
def test_poses_and_K_equal_bit_for_bit(scene):
    (_, Rj, tj, Kj), (_, Rt, tt, Kt) = _both(scene)
    assert len(Rj) == len(Rt) == T
    for a, b in zip(Rj + tj + [Kj], Rt + tt + [Kt]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("scene", ["corridor", "pan", "planes"])
def test_frames_within_one_grey_level(scene):
    (fj, *_), (ft, *_) = _both(scene)
    a, b = np.stack(fj).astype(np.int32), np.stack(ft).astype(np.int32)
    assert a.shape == b.shape == (T, H, W) and np.stack(ft).dtype == np.uint8
    d = np.abs(a - b)
    assert d.max() <= 1 and (d > 0).mean() <= MAX_DIFF_SHARE, (d.max(), (d > 0).mean())
    assert a.std() > 20  # textured, not blank


def test_frames_sha256_covers_every_byte_in_order():
    rng = np.random.default_rng(3)
    a = [rng.integers(0, 256, (4, 5)).astype(np.uint8) for _ in range(3)]
    h = ts.frames_sha256(a)
    assert len(h) == 64 and h == ts.frames_sha256([f.copy() for f in a])
    assert h == ts.frames_sha256(np.stack(a))
    b = [f.copy() for f in a]
    b[2][3, 4] ^= 1
    assert ts.frames_sha256(b) != h and ts.frames_sha256(a[::-1]) != h


def test_blur_equals_cv2_gaussian():
    img = np.random.default_rng(0).uniform(-1, 1, (96, 300)).astype(np.float32)
    for sigma in (2.0, 8.0, 32.0):
        want = cv2.GaussianBlur(img, (0, 0), sigma)
        got = ts._blur(img.astype(np.float64), sigma)
        np.testing.assert_allclose(got, want, atol=2e-6)


def test_area_half_equals_cv2_inter_area():
    img = np.random.default_rng(1).integers(0, 256, (120, 160)).astype(np.uint8)
    want = cv2.resize(img, (80, 60), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(ts._area_half(img), want)


def test_warps_follow_cv2():
    """Bilinear (border 0) and nearest (border inf) perspective warps of a
    noise texture: the bilinear within 1 on < 0.1% of pixels, the
    nearest equal but on rounding ties."""
    rng = np.random.default_rng(2)
    tex = rng.integers(0, 256, (150, 250)).astype(np.uint8)
    zmap = rng.random((150, 250)).astype(np.float32)
    Hm = np.array([[1.3, 0.2, -40.0], [0.05, 1.1, -20.0], [0.0004, 0.0002, 1.0]])
    want = cv2.warpPerspective(tex, Hm, (320, 240), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    X, Y = ts._source_coords(Hm.tolist(), 320, 240)
    d = np.abs(ts._bilinear(tex, X, Y).astype(int) - want)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    zw = cv2.warpPerspective(zmap, Hm, (320, 240), flags=cv2.INTER_NEAREST,
                             borderMode=cv2.BORDER_CONSTANT, borderValue=np.inf)
    u, v = np.rint(X), np.rint(Y)
    inside = (u >= 0) & (u < 250) & (v >= 0) & (v < 150)
    got = np.where(inside, zmap[np.clip(v, 0, 149).astype(int), np.clip(u, 0, 249).astype(int)],
                   np.inf)
    assert (got != zw).mean() < 1e-4
