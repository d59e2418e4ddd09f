"""Port pyramid against tpu_vo's.

Integer levels are equal, except that a 2-tap f32 resize value within
one ulp of a .5 rounding boundary may round the other way: XLA:CPU runs
the JAX package's banded matmul with or without fused multiply-adds
depending on the block shape, and the port's matmul differs in that
choice for some blocks (ROADMAP.md Queue C). Each level is therefore
compared from the SAME input level, and every differing pixel must be
off by exactly 1 with an exact (float64) value within 5e-5 of a .5
boundary; the cascaded pyramids are also counted.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_vo.image import filters as jfilt, pyramid as jpyr
from tpu_vo.utils.synthetic import make_sequence
from tpu_vo_torch.image import filters as tfilt, pyramid as tpyr
from _torch_threads import _one_thread  # noqa: F401


def _frames():
    frame = make_sequence(n_frames=1, width=480, height=360, seed=3)[0][0]
    noise = np.random.default_rng(0).integers(0, 256, (376, 1241)).astype(np.uint8)
    return {"make_sequence_480x360": frame, "uniform_noise_1241x376": noise}


def test_gaussian_kernel_and_level_sizes():
    np.testing.assert_array_equal(jfilt.gaussian_kernel_1d(7, 2.0),
                                  tfilt.gaussian_kernel_1d(7, 2.0))
    assert jpyr.level_sizes(376, 1241, 8, 1.2) == tpyr.level_sizes(376, 1241, 8, 1.2)
    np.testing.assert_array_equal(jpyr._resize_matrix(313, 376),
                                  tpyr._resize_matrix(313, 376))


@pytest.mark.parametrize("name", list(_frames()))
def test_build_pyramid_levels_equal(name):
    img = _frames()[name]
    jl = [np.asarray(x) for x in jpyr.build_pyramid(jnp.asarray(img.astype(np.float32)), 8, 1.2)]
    tl = tpyr.build_pyramid(torch.from_numpy(img), 8, 1.2)
    assert [x.shape for x in jl] == [tuple(x.shape) for x in tl]
    np.testing.assert_array_equal(jl[0], tl[0].numpy())
    total = 0
    for L in range(1, 8):
        src = jl[L - 1]
        lh, lw = jl[L].shape
        t = torch.clamp(torch.round(tpyr.resize_bilinear(torch.from_numpy(src.copy()), lh, lw)),
                        0, 255).numpy()
        d = t != jl[L]
        total += int(d.sum())
        if d.any():
            exact = (jpyr._resize_matrix(lh, src.shape[0]).astype(np.float64).T
                     @ src.astype(np.float64)
                     @ jpyr._resize_matrix(lw, src.shape[1]).astype(np.float64))
            np.testing.assert_array_equal(np.abs(t[d] - jl[L][d]), 1.0)
            assert np.abs(exact[d] - np.floor(exact[d]) - 0.5).max() < 5e-5
        assert d.mean() < 1e-3, (L, int(d.sum()))
    assert total <= 40, total
    # the cascade carries a boundary flip into the next levels; it stays rare
    cascade = sum(int((a != b.numpy()).sum()) for a, b in zip(jl, tl))
    assert cascade <= 100, cascade


def test_build_pyramid_batch_matches_single_frames():
    frames = np.stack([_frames()["make_sequence_480x360"]] * 2)
    frames[1] = 255 - frames[1]
    batch = tpyr.build_pyramid(torch.from_numpy(frames), 8, 1.2)
    for i in range(2):
        single = tpyr.build_pyramid(torch.from_numpy(frames[i]), 8, 1.2)
        for b, s in zip(batch, single):
            np.testing.assert_array_equal(b[i].numpy(), s.numpy())
