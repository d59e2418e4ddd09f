"""Port estimation (8-point, recover_pose, SoA 5-point, RANSAC) against
tpu_vo.

  8-point: E equal up to sign and scale within 1e-4.
  recover_pose: R and t within 1e-4 on the same E.
  5-point: candidate sets equal up to sign and scale (||.||_F < 1e-3 for
    every valid tpu_vo candidate) on >= 99% of samples in float64. In
    float32 the degree-10 root iteration is chaotic: tpu_vo's own f32
    candidate sets agree with its f64 ones on only ~50-75% of samples,
    so there both solvers must recover the true E equally often (within
    3 points).
  RANSAC: through the `idx` seam, fed tpu_vo's `_draw_samples`; the
    winning pose within 0.1 deg of tpu_vo's on >= 90% of the pairs of a
    make_sequence scene in float64, num_inliers within 2%; in float32
    the winner may move within the estimator's noise (see the test). On
    two-view scenes with outliers in float64, every option (count
    scoring, 8-point samples, with and without the prescreen) picks
    tpu_vo's winner: E up to sign within 1e-5, inliers equal.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_vo.estimation import eight_point as j8, five_point as j5, ransac as jr
from tpu_vo.estimation import recover_pose as jrp
from tpu_vo.utils.synthetic import make_sequence
from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.estimation import eight_point as t8, five_point as t5, ransac as tr
from tpu_vo_torch.estimation import recover_pose as trp
from tpu_vo_torch.features.orb import ORBFeatures, detect_and_compute
from tpu_vo_torch.geometry.camera import intrinsics, normalize_points
from tpu_vo_torch.matching.filter import adaptive_threshold_filter
from tpu_vo_torch.matching.hamming import mutual_nearest_match
from _torch_threads import _one_thread  # noqa: F401


def _rot(axis_angle):
    th = np.linalg.norm(axis_angle)
    k = axis_angle / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _two_view(rng, n, batch, noise=0.0, depth=(2, 10), base=0.5):
    """(batch, n) correspondences of random scenes, true R, t, E."""
    X = np.concatenate([rng.uniform(-3, 3, (batch, n, 2)),
                        rng.uniform(*depth, (batch, n, 1))], -1)
    x1, x2, Rs, ts, Es = [], [], [], [], []
    for b in range(batch):
        R = _rot(rng.uniform(-0.1, 0.1, 3))
        t = rng.normal(size=3)
        t = t / np.linalg.norm(t) * base
        Xc = X[b] @ R.T + t
        x1.append(X[b, :, :2] / X[b, :, 2:])
        x2.append(Xc[:, :2] / Xc[:, 2:])
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E = tx @ R
        Rs.append(R), ts.append(t), Es.append(E / np.linalg.norm(E))
    x1 = np.asarray(x1) + rng.normal(0, noise, (batch, n, 2))
    x2 = np.asarray(x2) + rng.normal(0, noise, (batch, n, 2))
    return x1, x2, np.asarray(Rs), np.asarray(ts), np.asarray(Es)


def _up_to_sign_scale(a, b):
    a = a / np.linalg.norm(a, axis=(-2, -1), keepdims=True)
    b = b / np.linalg.norm(b, axis=(-2, -1), keepdims=True)
    return np.minimum(np.abs(a - b).max((-2, -1)), np.abs(a + b).max((-2, -1)))


def test_eight_point_matches():
    rng = np.random.default_rng(0)
    x1, x2, _, _, _ = _two_view(rng, 60, 16, noise=1e-3)
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    mask = rng.random((16, 60)) > 0.2
    Ej = np.asarray(j8.estimate_essential_8pt(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask)))
    Et = t8.estimate_essential_8pt(torch.from_numpy(x1), torch.from_numpy(x2),
                                   torch.from_numpy(mask)).numpy()
    assert _up_to_sign_scale(Ej, Et).max() < 1e-4


def test_recover_pose_matches():
    rng = np.random.default_rng(1)
    x1, x2, _, _, Es = _two_view(rng, 80, 16, noise=5e-4)
    x1, x2, Es = x1.astype(np.float32), x2.astype(np.float32), Es.astype(np.float32)
    mask = rng.random((16, 80)) > 0.1
    j = jrp.recover_pose_from_essential(jnp.asarray(Es), jnp.asarray(x1), jnp.asarray(x2),
                                        jnp.asarray(mask), 50.0)
    t = trp.recover_pose_from_essential(torch.from_numpy(Es), torch.from_numpy(x1),
                                        torch.from_numpy(x2), torch.from_numpy(mask), 50.0)
    np.testing.assert_allclose(np.asarray(j.R), t.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(j.t), t.t.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(j.num_valid), t.num_valid.numpy())
    np.testing.assert_array_equal(np.asarray(j.mask), t.mask.numpy())


def _set_agreement(Ea, va, Eb, vb, tol=1e-3):
    """Fraction of samples where every valid candidate of (Ea, va) has a
    candidate of (Eb, vb) within tol (Frobenius), up to sign."""
    d = np.minimum(np.linalg.norm(Ea[:, :, None] - Eb[:, None], axis=(-2, -1)),
                   np.linalg.norm(Ea[:, :, None] + Eb[:, None], axis=(-2, -1)))
    d = np.where(vb[:, None, :], d, np.inf).min(-1)
    return float((np.where(va, d < tol, True)).all(-1).mean())


def _true_hit(E, v, Etrue, tol=1e-3):
    d = np.minimum(np.linalg.norm(E - Etrue[:, None], axis=(-2, -1)),
                   np.linalg.norm(E + Etrue[:, None], axis=(-2, -1)))
    return float((np.where(v, d, np.inf).min(-1) < tol).mean())


def test_five_point_candidate_sets_f64():
    x1, x2, _, _, _ = _two_view(np.random.default_rng(2), 5, 256)
    Ej, vj = (np.asarray(a) for a in jax.jit(j5.five_point_candidates_batched)(
        jnp.asarray(x1), jnp.asarray(x2)))
    Et, vt = (a.numpy() for a in t5.five_point_candidates_batched(torch.from_numpy(x1),
                                                                  torch.from_numpy(x2)))
    assert vj.sum() > 256
    assert _set_agreement(Ej, vj, Et, vt) >= 0.99
    assert _set_agreement(Et, vt, Ej, vj) >= 0.99


def test_five_point_true_solution_f32():
    x1, x2, _, _, Etrue = _two_view(np.random.default_rng(3), 5, 512)
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    Ej, vj = (np.asarray(a) for a in jax.jit(j5.five_point_candidates_batched)(
        jnp.asarray(x1), jnp.asarray(x2)))
    Et, vt = (a.numpy() for a in t5.five_point_candidates_batched(torch.from_numpy(x1),
                                                                  torch.from_numpy(x2)))
    hj, ht = _true_hit(Ej, vj, Etrue), _true_hit(Et, vt, Etrue)
    assert hj > 0.6 and abs(hj - ht) <= 0.03, (hj, ht)


@pytest.fixture(scope="module")
def scene_pairs():
    """Normalized matched correspondences of the 7 pairs of the
    tests/test_pipeline.py scene, made with the port (whose features and
    matches equal tpu_vo's)."""
    w, h, T = 480, 360, 8
    cfg = VOConfig(image_width=w, image_height=h)
    frames = torch.from_numpy(np.stack(make_sequence(n_frames=T, width=w, height=h, seed=3)[0]))
    f = detect_and_compute(frames, cfg.orb)
    prev = ORBFeatures(*(a[:-1] for a in f))
    cur = ORBFeatures(*(a[1:] for a in f))
    good, _ = adaptive_threshold_filter(
        mutual_nearest_match(prev.desc32, cur.desc32, prev.valid, cur.valid), cfg.match)
    K = intrinsics(*cfg.intrinsics)
    p2 = torch.gather(cur.xy, 1, good.train_idx[..., None].expand(-1, -1, 2))
    x1n = normalize_points(prev.xy, K).numpy()
    x2n = normalize_points(p2, K).numpy()
    thr = np.float32(tr.pixel_threshold_to_normalized(2.0, K).item())
    return x1n, x2n, good.valid.numpy(), thr


def _ransac_both(x1n, x2n, mask, thr):
    """Winning rotations and inlier counts of tpu_vo's RANSAC (per pair,
    jitted) and the port's (batched, fed tpu_vo's sample indices)."""
    P = x1n.shape[0]
    ransac = jax.jit(jr.find_essential_ransac)
    idx, Rj, nj = [], [], []
    for p in range(P):
        key = jax.random.fold_in(jax.random.PRNGKey(0), p + 1)
        m = jnp.asarray(mask[p])
        idx.append(np.asarray(jr._draw_samples(key, m, 256, 5)))
        res = ransac(jnp.asarray(x1n[p]), jnp.asarray(x2n[p]), m, key, jnp.asarray(thr))
        rec = jrp.recover_pose_from_essential(res.E, jnp.asarray(x1n[p]), jnp.asarray(x2n[p]),
                                              res.inliers, 50.0)
        Rj.append(np.asarray(rec.R, np.float64))
        nj.append(int(res.num_inliers))
    res = tr.find_essential_ransac(torch.from_numpy(x1n), torch.from_numpy(x2n),
                                   torch.from_numpy(mask), float(thr),
                                   idx=torch.from_numpy(np.stack(idx).astype(np.int64)))
    rec = trp.recover_pose_from_essential(res.E, torch.from_numpy(x1n), torch.from_numpy(x2n),
                                          res.inliers, 50.0)
    assert res.success.all()
    ang = np.asarray([np.degrees(np.arccos(np.clip((np.trace(a.T @ b) - 1) / 2, -1, 1)))
                      for a, b in zip(Rj, rec.R.double().numpy())])
    return ang, res.num_inliers.numpy(), np.asarray(nj)


def test_ransac_through_idx_seam_f64(scene_pairs):
    x1n, x2n, mask, thr = scene_pairs
    ang, nt, nj = _ransac_both(x1n.astype(np.float64), x2n.astype(np.float64), mask,
                               np.float64(thr))
    assert np.mean(ang < 0.1) >= 0.9, ang
    assert np.all(np.abs(nt - nj) <= 0.02 * nj), (nt, nj)


def test_ransac_through_idx_seam_f32(scene_pairs):
    """In float32 the chaotic 5-point roots (see the 5-point tests) give
    the two implementations different near-tied candidates, so the winner
    can move within the estimator's noise (measured: 4 of 7 pairs within
    0.1 deg, the rest 0.16-0.36 deg; the per-pair rotation error against
    ground truth is ~0.25 deg on this scene)."""
    ang, nt, nj = _ransac_both(*scene_pairs)
    assert np.mean(ang < 0.1) >= 0.5 and ang.max() < 1.0, ang
    assert np.all(np.abs(nt - nj) <= 0.02 * nj), (nt, nj)


def _ransac_equals_tpu_vo_f64(n, score="msac", use_five_point=True, max_iters=256):
    """Through the `idx` seam in float64, fed tpu_vo's draws: inliers,
    inlier count and success equal tpu_vo's, and E up to its sign within
    1e-5 (the 8-point tolerance of test_eight_point_matches is 1e-4)."""
    rng = np.random.default_rng(n)
    P = 4
    x1, x2, _, _, _ = _two_view(rng, n, P, noise=3e-4)
    out = rng.random((P, n)) < 0.25
    x2 = np.where(out[..., None], rng.uniform(-0.5, 0.5, x2.shape), x2)
    mask = rng.random((P, n)) > 0.1
    thr = np.float64(2.0 / 718.856)
    kw = dict(max_iters=max_iters, use_five_point=use_five_point, score=score)
    ransac = jax.jit(functools.partial(jr.find_essential_ransac, **kw))
    idx, jres = [], []
    for p in range(P):
        key = jax.random.fold_in(jax.random.PRNGKey(0), p + 1)
        m = jnp.asarray(mask[p])
        idx.append(np.asarray(jr._draw_samples(key, m, max_iters, 5 if use_five_point else 8)))
        jres.append(ransac(jnp.asarray(x1[p]), jnp.asarray(x2[p]), m, key, jnp.asarray(thr)))
    res = tr.find_essential_ransac(torch.from_numpy(x1), torch.from_numpy(x2),
                                   torch.from_numpy(mask), float(thr),
                                   idx=torch.from_numpy(np.stack(idx).astype(np.int64)), **kw)
    assert res.E.dtype == torch.float64 and res.success.all()
    for p, j in enumerate(jres):
        Ej, Et = np.asarray(j.E), res.E[p].numpy()
        # E and -E are one model; the LO refit's 8-point SVD picks the sign
        # and, run by LAPACK in another order, differs in the 6th decimal
        sign = np.sign((Ej * Et).sum())
        np.testing.assert_allclose(Et, sign * Ej, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(res.inliers[p].numpy(), np.asarray(j.inliers))
        assert int(res.num_inliers[p]) == int(j.num_inliers)
        assert bool(res.success[p]) == bool(j.success)


@pytest.mark.parametrize("n", [64, 128])
def test_ransac_without_prescreen_equals_tpu_vo_f64(n):
    """N <= prescreen (128): tpu_vo scores every hypothesis on the full set
    (no finalist cut, no cheirality gate, sigma adapted on the full set),
    and the port picks the same winner."""
    _ransac_equals_tpu_vo_f64(n)


@pytest.mark.parametrize("n, score, use_five_point, max_iters", [
    (200, "count", True, 256),    # count ranking on the subset, then the finalists
    (100, "count", True, 256),    # count ranking on the full set (N <= 128)
    (200, "msac", False, 256),    # 8-point samples, two-phase MSAC
    (100, "count", False, 256),   # 8-point samples, counted on the full set
    (200, "count", False, 12),    # 12 8-point models: the 16 finalists cut to 12
])
def test_ransac_options_equal_tpu_vo_f64(n, score, use_five_point, max_iters):
    """score="count" (first-maximum winner, the count refit) and 8-point
    samples (every model valid, success at 8 inliers) pick tpu_vo's
    winner through the `idx` seam."""
    _ransac_equals_tpu_vo_f64(n, score, use_five_point, max_iters)


def test_first_argmax_takes_the_first_maximum():
    x = torch.tensor([[3, 7, 7, 1], [-1, -1, -1, -1], [0, 2, 5, 5]])
    np.testing.assert_array_equal(tr.first_argmax(x).numpy(), np.argmax(x.numpy(), -1))


def test_ransac_on_an_all_invalid_mask_is_finite_and_masked():
    """The first frame of the streaming path estimates against an empty
    feature set: every option draws from slot 0 and returns finite,
    failed results."""
    x = torch.rand((2, 150, 2), generator=torch.Generator().manual_seed(0))
    mask = torch.zeros((2, 150), dtype=torch.bool)
    for five, score in ((True, "msac"), (True, "count"), (False, "msac"), (False, "count")):
        for n in (150, 64):
            gens = [torch.Generator().manual_seed(i) for i in range(2)]
            idx = tr.draw_samples(gens, mask[:, :n], 256, 5 if five else 8)
            assert (idx == 0).all()
            res = tr.find_essential_ransac(x[:, :n], x[:, :n], mask[:, :n], 0.003, idx=idx,
                                           use_five_point=five, score=score)
            assert torch.isfinite(res.E).all()
            assert not res.success.any() and not res.inliers.any()
            assert (res.num_inliers == 0).all()


def test_ransac_refuses_two_phase_scoring_without_finalists():
    x = torch.zeros((1, 200, 2))
    idx = torch.zeros((1, 4, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="at least 1"):
        tr.find_essential_ransac(x, x, torch.ones((1, 200), dtype=torch.bool), 0.01,
                                 idx=idx, max_iters=4, finalists=-1)


def test_ransac_generator_draws_do_not_depend_on_batching(scene_pairs):
    from tpu_vo_torch.pipeline.runner import pair_generators

    x1n, x2n, mask = (torch.from_numpy(a) for a in scene_pairs[:3])
    thr = float(scene_pairs[3])
    full = tr.find_essential_ransac(x1n, x2n, mask, thr,
                                    generators=pair_generators(0, range(1, 8)))
    part = tr.find_essential_ransac(x1n[3:], x2n[3:], mask[3:], thr,
                                    generators=pair_generators(0, range(4, 8)))
    assert torch.equal(full.num_inliers[3:], part.num_inliers)
    assert torch.allclose(full.E[3:], part.E, atol=1e-6)
