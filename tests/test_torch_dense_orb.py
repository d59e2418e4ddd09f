"""The dense ORB route of the port (harris_at, the fast.detect selection,
moment maps and the three ic_angles forms, full-frame gaussian_blur,
descriptor_bits, unpack_u8) against tpu_vo on the same float32 arrays,
and the dense route against the port's own patch route.

The JAX functions run op by op (no jax.jit): jitted XLA:CPU contracts
a*b + c into FMAs, which moves Harris, the blur and the steering by an
ulp. Only fast.detect is jitted inside tpu_vo's selection (integer
subtractions, mins and maxes, which no fusion rounds differently), to
save its per-op compiles. So run, every comparison is bit for bit:
moment sums are integers below 2^24, exact in float32 in any order, and
the blur keeps tpu_vo's order of operations.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_vo.configs import ORBConfig as JORBConfig
from tpu_vo.features import brief as jbrief, fast as jfast, harris as jharris, orb as jorb
from tpu_vo.features import orientation as jori
from tpu_vo.image import filters as jfilters
from tpu_vo.utils.synthetic import make_sequence
from tpu_vo_torch.configs import ORBConfig
from tpu_vo_torch.features import brief, harris, orb, orientation, patches
from tpu_vo_torch.image import filters
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops.patch import extract_patches
from _torch_threads import _one_thread  # noqa: F401

H, W, N = 64, 96, 40


@pytest.fixture(scope="module")
def data():
    """Two integer-grid frames and N keypoints per frame, 15 px inside,
    plus a few on the edge (the clamps must agree)."""
    rng = np.random.default_rng(0)
    img = np.round(rng.random((2, H, W)) * 255).astype(np.float32)
    ys = rng.integers(15, H - 15, (2, N)).astype(np.int32)
    xs = rng.integers(15, W - 15, (2, N)).astype(np.int32)
    ys[:, :3], xs[:, :3] = [0, H - 1, 5], [W - 1, 0, 3]
    return img, ys, xs


def _per_frame(fn, *arrays):
    """tpu_vo's single-image fn applied to each frame, stacked."""
    return np.stack([np.asarray(fn(*(jnp.asarray(a[i]) for a in arrays)))
                     for i in range(arrays[0].shape[0])])


def test_harris_at_matches(data):
    img, ys, xs = data
    ref = _per_frame(jharris.harris_at, img, ys, xs)
    t = torch.from_numpy
    got = harris.harris_at(t(img), t(ys), t(xs))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(harris.harris_at(t(img[1]), t(ys[1]), t(xs[1])).numpy(),
                                  ref[1])


def test_moment_maps_match(data):
    img = data[0]
    j01, j10 = jori.moment_maps(jnp.asarray(img[0]))
    t01, t10 = orientation.moment_maps(torch.from_numpy(img))
    np.testing.assert_array_equal(t01[0].numpy(), np.asarray(j01))
    np.testing.assert_array_equal(t10[0].numpy(), np.asarray(j10))


@pytest.mark.parametrize("name", ["ic_angles", "ic_angles_gather", "ic_angles_prefix"])
def test_orientation_matches(data, name):
    img, ys, xs = data
    ref = _per_frame(getattr(jori, name), img, ys, xs)
    got = getattr(orientation, name)(*(torch.from_numpy(a) for a in (img, ys, xs)))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(2, 37, 53), (29, 101)])
@pytest.mark.parametrize("quantize", [True, False])
def test_gaussian_blur_matches(shape, quantize):
    img = np.round(np.random.default_rng(3).random(shape) * 255).astype(np.float32)
    ref = np.asarray(jfilters.gaussian_blur(jnp.asarray(img), quantize=quantize))
    got = filters.gaussian_blur(torch.from_numpy(img), quantize=quantize)
    np.testing.assert_array_equal(got.numpy(), ref)
    for axis in (-1, -2):
        np.testing.assert_array_equal(
            filters._reflect101_pad(torch.from_numpy(img), 3, axis).numpy(),
            np.asarray(jfilters._reflect101_pad(jnp.asarray(img), 3, axis)))


def test_descriptor_bits_and_unpack_match(data):
    img, ys, xs = data
    blurred = np.array(jfilters.gaussian_blur(jnp.asarray(img)))
    ang = np.random.default_rng(4).uniform(0, 360, (2, N)).astype(np.float32)
    ref = _per_frame(jbrief.descriptor_bits, blurred, ys, xs, ang)
    got = brief.descriptor_bits(*(torch.from_numpy(a) for a in (blurred, ys, xs, ang)))
    np.testing.assert_array_equal(got.numpy(), ref)
    desc = np.asarray(jbrief.pack_bits_u8(jnp.asarray(ref[0])))
    np.testing.assert_array_equal(brief.unpack_u8(torch.from_numpy(desc)).numpy(),
                                  np.asarray(jbrief.unpack_u8(jnp.asarray(desc))))


@pytest.fixture(scope="module")
def pyramid():
    frames = np.stack(make_sequence(n_frames=2, width=160, height=120, seed=5)[0])
    return [lv.contiguous() for lv in build_pyramid(torch.from_numpy(frames), 3, 1.2)]


@pytest.mark.parametrize("keep_ties", [False, True])
def test_dense_selection_matches(pyramid, keep_ties, monkeypatch):
    """orb._select_level_keypoints, batched over frames, against tpu_vo's
    on each frame (its CPU route is the fast.detect branch), on the same
    levels of a 3-level pyramid."""
    monkeypatch.setattr(jfast, "detect", jax.jit(jfast.detect, static_argnums=2))
    budgets = orb.features_per_level(300, 3, 1.2)
    tcfg = ORBConfig(retain_best_keep_ties=keep_ties)
    jcfg = JORBConfig(retain_best_keep_ties=keep_ties)
    n_valid = 0
    for lvl, n in zip(pyramid, budgets):
        got = [a.numpy() for a in orb._select_level_keypoints(lvl, n, tcfg)]
        for i in range(lvl.shape[0]):
            ref = [np.asarray(a) for a in
                   jorb._select_level_keypoints(jnp.asarray(lvl[i].numpy()), n, jcfg)]
            for name, r, g in zip(("ys", "xs", "response", "valid"), ref, got):
                np.testing.assert_array_equal(g[i], r, err_msg=name)
            n_valid += int(ref[3].sum())
    assert n_valid > 300


def test_dense_route_equals_patch_route():
    """ic_angles_prefix + gaussian_blur + descriptor_bits equal
    angles_from_patches + descriptor_bits_from_patches on the 43x43
    windows, bit for bit, for keypoints 31 px inside the level."""
    rng = np.random.default_rng(5)
    img = torch.from_numpy(np.round(rng.random((2, 120, 180)) * 255).astype(np.float32))
    ys = torch.from_numpy(rng.integers(31, 120 - 31, (2, 64)).astype(np.int32))
    xs = torch.from_numpy(rng.integers(31, 180 - 31, (2, 64)).astype(np.int32))
    ang = orientation.ic_angles_prefix(img, ys, xs)
    bits = brief.descriptor_bits(filters.gaussian_blur(img), ys, xs, ang)
    raw = extract_patches(img, ys, xs)
    pang = patches.angles_from_patches(raw)
    assert torch.equal(pang, ang)
    assert torch.equal(patches.descriptor_bits_from_patches(raw, pang), bits)
