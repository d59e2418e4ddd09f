"""Port matching against tpu_vo: Hamming distances, the cross-check, the
adaptive threshold and the ratio test are exact, ties included (lowest
index first; a tie at the first distance fails the ratio test)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_vo.matching import filter as jfilter, hamming as jham
from tpu_vo_torch.matching import filter as tfilter, hamming as tham
from _torch_threads import _one_thread  # noqa: F401


def _descriptors(seed, n, m):
    """Random 256-bit descriptors with duplicated rows and near copies, so
    that distances tie; some slots invalid."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    d2[: n // 3] = d1[: n // 3] ^ (1 << rng.integers(0, 32, (n // 3, 8))).astype(np.uint32) * \
        (rng.random((n // 3, 8)) < 0.3)
    d2[n // 3: n // 3 + 10] = d2[:10]          # duplicated train rows -> ties
    d1[n // 2: n // 2 + 10] = d1[:10]          # duplicated query rows -> ties
    v1 = rng.random(n) > 0.1
    v2 = rng.random(m) > 0.1
    return d1, d2, v1, v2


def _t(d):
    return torch.from_numpy(d.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_hamming_distances_exact(seed):
    d1, d2, _, _ = _descriptors(seed, 120, 100)
    for method in ("mxu", "popcount"):
        ref = np.asarray(jham.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2), method))
        np.testing.assert_array_equal(ref, tham.hamming_distance_matrix(_t(d1), _t(d2)).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutual_nearest_and_filter_exact(seed):
    d1, d2, v1, v2 = _descriptors(seed, 150, 140)
    jm = jham.mutual_nearest_match(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
                                   jnp.asarray(v2))
    tm = tham.mutual_nearest_match(_t(d1), _t(d2), torch.from_numpy(v1), torch.from_numpy(v2))
    assert np.asarray(jm.valid).sum() >= 40
    np.testing.assert_array_equal(np.asarray(jm.valid), tm.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jm.train_idx), tm.train_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jm.distance), tm.distance.numpy())

    jf, js = jfilter.adaptive_threshold_filter(jm)
    tf, ts = tfilter.adaptive_threshold_filter(tm)
    np.testing.assert_array_equal(np.asarray(jf.valid), tf.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jf.distance), tf.distance.numpy())
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_batched_matching_equals_per_pair():
    pairs = [_descriptors(s, 90, 90) for s in range(3)]
    d1 = torch.stack([_t(p[0]) for p in pairs])
    d2 = torch.stack([_t(p[1]) for p in pairs])
    v1 = torch.stack([torch.from_numpy(p[2]) for p in pairs])
    v2 = torch.stack([torch.from_numpy(p[3]) for p in pairs])
    batched, bstats = tfilter.adaptive_threshold_filter(tham.mutual_nearest_match(d1, d2, v1, v2))
    for i in range(3):
        single, sstats = tfilter.adaptive_threshold_filter(
            tham.mutual_nearest_match(d1[i], d2[i], v1[i], v2[i]))
        for a, b in zip(batched, single):
            assert torch.equal(a[i], b)
        for a, b in zip(bstats, sstats):
            assert torch.equal(a[i], b)


def test_empty_and_all_invalid():
    d1, d2, v1, v2 = _descriptors(3, 20, 20)
    v1[:] = False
    jm = jham.mutual_nearest_match(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
                                   jnp.asarray(v2))
    tm = tham.mutual_nearest_match(_t(d1), _t(d2), torch.from_numpy(v1), torch.from_numpy(v2))
    _, js = jfilter.adaptive_threshold_filter(jm)
    _, ts = tfilter.adaptive_threshold_filter(tm)
    assert not tm.valid.any()
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed, ratio", [(0, 0.75), (1, 0.75), (2, 0.9)])
def test_ratio_test_match_exact(seed, ratio):
    d1, d2, v1, v2 = _descriptors(seed, 150, 140)
    jm = jham.ratio_test_match(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
                               jnp.asarray(v2), ratio)
    tm = tham.ratio_test_match(_t(d1), _t(d2), torch.from_numpy(v1), torch.from_numpy(v2),
                               ratio)
    # the duplicated train rows give rows whose two nearest distances tie
    dist = tham.masked_distances(_t(d1), _t(d2), torch.from_numpy(v1), torch.from_numpy(v2))
    two = torch.sort(dist, dim=-1).values[:, :2]
    assert ((two[:, 0] == two[:, 1]) & (two[:, 0] < tham.MAX_DIST)).sum() >= 5
    assert 10 <= np.asarray(jm.valid).sum() < 150
    np.testing.assert_array_equal(np.asarray(jm.valid), tm.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jm.train_idx), tm.train_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jm.distance), tm.distance.numpy())
    for a, b in zip(jfilter.match_statistics(jm), tfilter.match_statistics(tm)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    batched = tham.ratio_test_match(_t(d1)[None], _t(d2)[None], torch.from_numpy(v1)[None],
                                    torch.from_numpy(v2)[None], ratio)
    for a, b in zip(batched, tm):
        assert torch.equal(a[0], b)
