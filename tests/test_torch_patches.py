"""Kernel B2's plain version (tpu_vo_torch.ops.patch) against tpu_vo's
Pallas `extract_patches_pallas` (interpret mode) and XLA
`extract_patches`; then orientation, blur and descriptor bits from the
windows against tpu_vo.features.patches, run op by op.

Windows, angles and blur are exact. Descriptor bits: sin/cos of the
steering angle may differ by an ulp between torch and XLA, which can move
one rounded sample offset; at most 1 differing bit in at most 0.5% of the
descriptors is allowed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_vo.features import brief as jbrief, patches as jpatches
from tpu_vo.ops.patch_pallas import extract_patches_pallas
from tpu_vo.utils.synthetic import make_sequence
from tpu_vo_torch.features import brief as tbrief, patches as tpatches
from tpu_vo_torch.ops import patch as tpatch
from _torch_threads import _one_thread  # noqa: F401


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B2 has no CPU mode")
    return torch.device("cuda")


def _level_and_keypoints(n=300, seed=0):
    img = make_sequence(n_frames=1, width=480, height=360, seed=3)[0][0].astype(np.float32)
    rng = np.random.default_rng(seed)
    ys = rng.integers(31, img.shape[0] - 31, n).astype(np.int32)
    xs = rng.integers(31, img.shape[1] - 31, n).astype(np.int32)
    return img, ys, xs


@pytest.mark.skipif(jax.default_backend() != "cpu",
                    reason="interpret-mode Pallas runs on the CPU backend only")
def test_extract_patches_matches_pallas():
    h, w = 96, 300
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (h, w)).astype(np.float32)
    ys = rng.integers(31, h - 31, 40).astype(np.int32)
    xs = rng.integers(31, w - 31, 40).astype(np.int32)
    ys[:3], xs[:3] = 0, 0      # invalid slots sit at (0, 0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(extract_patches_pallas(jnp.asarray(img), jnp.asarray(ys),
                                                jnp.asarray(xs)))
    got = tpatch.extract_patches(torch.from_numpy(img)[None], torch.from_numpy(ys)[None],
                                 torch.from_numpy(xs)[None])[0].numpy()
    np.testing.assert_array_equal(got, ref[:, :43, :])


@pytest.mark.parametrize("shape", [(360, 480), (30, 60), (40, 200)])
def test_extract_patches_matches_xla_every_slot(shape):
    """Slots anywhere from 21 px inside to past the bottom/right edge, and
    levels smaller than the window. (A start below 0 differs: XLA's
    dynamic_slice counts a negative start from the end, so tpu_vo's XLA
    path reads an invalid (0, 0) slot's window from the bottom-right
    corner; the Pallas kernel and the port clamp it to the top-left, see
    test_extract_patches_matches_pallas.)"""
    h, w = shape
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (h, w)).astype(np.float32)
    ys = rng.integers(21, h + 5, 64).astype(np.int32)
    xs = rng.integers(21, w + 5, 64).astype(np.int32)
    ref = np.asarray(jpatches.extract_patches(jnp.asarray(img), jnp.asarray(ys),
                                              jnp.asarray(xs)))
    got = tpatch.extract_patches(torch.from_numpy(img)[None], torch.from_numpy(ys)[None],
                                 torch.from_numpy(xs)[None])[0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_extract_patches_rejects_bad_input():
    img = torch.zeros(1, 64, 64)
    with pytest.raises(ValueError):
        tpatch.extract_patches(img, torch.zeros(1, 4, dtype=torch.int64),
                               torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tpatch.extract_patches(img, torch.zeros(2, 4, dtype=torch.int32),
                               torch.zeros(2, 4, dtype=torch.int32))


def test_angles_and_blur_exact():
    img, ys, xs = _level_and_keypoints()
    raw_j = jpatches.extract_patches(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))
    raw_t = torch.from_numpy(np.asarray(raw_j).copy())
    np.testing.assert_array_equal(np.asarray(jpatches.angles_from_patches(raw_j)),
                                  tpatches.angles_from_patches(raw_t).numpy())
    np.testing.assert_array_equal(np.asarray(jpatches.blur_patches(raw_j)),
                                  tpatches.blur_patches(raw_t).numpy())


def test_descriptor_bits_and_packing():
    img, ys, xs = _level_and_keypoints(n=600, seed=2)
    raw_j = jpatches.extract_patches(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))
    raw_t = torch.from_numpy(np.asarray(raw_j).copy())
    ang_j = jpatches.angles_from_patches(raw_j)
    ang_t = torch.from_numpy(np.asarray(ang_j).copy())
    bits_j = np.array(jpatches.descriptor_bits_from_patches(raw_j, ang_j))
    bits_t = tpatches.descriptor_bits_from_patches(raw_t, ang_t)
    diff = (bits_j != bits_t.numpy()).sum(-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, (diff.max(), (diff > 0).mean())

    dy_j, dx_j = jbrief.steered_offsets(ang_j)
    dy_t, dx_t = tbrief.steered_offsets(ang_t)
    moved = ((np.asarray(dy_j) != dy_t.numpy()) | (np.asarray(dx_j) != dx_t.numpy())).any(-1)
    assert moved.mean() <= 0.005

    np.testing.assert_array_equal(np.asarray(jbrief.pack_bits_u8(jnp.asarray(bits_j))),
                                  tbrief.pack_bits_u8(torch.from_numpy(bits_j)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jbrief.pack_bits_u32(jnp.asarray(bits_j))),
        tbrief.pack_bits_u32(torch.from_numpy(bits_j)).numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 376, 1241), (2, 30, 60)])
def test_patch_kernel_matches_plain(cuda, shape):
    b, h, w = shape
    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, shape, generator=g).float()
    ys = torch.randint(-5, h + 5, (b, 300), generator=g, dtype=torch.int32)
    xs = torch.randint(-5, w + 5, (b, 300), generator=g, dtype=torch.int32)
    before = tpatch.extract_patches.launches
    k = tpatch.extract_patches(img.to(cuda), ys.to(cuda), xs.to(cuda))
    torch.cuda.synchronize()
    assert tpatch.extract_patches.launches == before + 1
    assert torch.equal(k.cpu(), tpatch.extract_patches_reference(img, ys, xs))
