"""Port geometry (se3, camera, epipolar, triangulation) against tpu_vo on
random float32 batches: rtol 1e-5, atol 1e-6."""

import numpy as np
import jax.numpy as jnp
import torch

from tpu_vo.geometry import camera as jcam, epipolar as jepi, se3 as jse3
from tpu_vo.geometry import triangulation as jtri
from tpu_vo_torch.geometry import camera as tcam, epipolar as tepi, se3 as tse3
from tpu_vo_torch.geometry import triangulation as ttri
from tpu_vo_torch import interop
from _torch_threads import _one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    return R.astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=RTOL, atol=ATOL)


def test_se3_compose_invert_skew():
    rng = np.random.default_rng(0)
    Ra, Rb = _rot(rng, 64), _rot(rng, 64)
    ta, tb = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    j = jse3.compose(jse3.Pose(jnp.asarray(Ra), jnp.asarray(ta)),
                     jse3.Pose(jnp.asarray(Rb), jnp.asarray(tb)))
    t = tse3.compose(interop.pose_from_numpy(Ra, ta), interop.pose_from_numpy(Rb, tb))
    _close(j.R, t.R)
    _close(j.t, t.t)
    for a, b in zip(jse3.invert_relative(jnp.asarray(Ra), jnp.asarray(ta)),
                    tse3.invert_relative(torch.from_numpy(Ra), torch.from_numpy(ta))):
        _close(a, b)
    _close(jse3.skew(jnp.asarray(ta)), tse3.skew(torch.from_numpy(ta)))


def test_cumulative_compose():
    rng = np.random.default_rng(1)
    for n in (1, 2, 7, 31):
        R = _rot(rng, n)
        t = (0.3 * rng.normal(size=(n, 3))).astype(np.float32)
        j = jse3.cumulative_compose(jse3.Pose(jnp.asarray(R), jnp.asarray(t)))
        c = tse3.cumulative_compose(tse3.Pose(torch.from_numpy(R), torch.from_numpy(t)))
        np.testing.assert_allclose(np.asarray(j.R), c.R.numpy(), rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(np.asarray(j.t), c.t.numpy(), rtol=RTOL, atol=1e-5)


def test_camera():
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    Kj = jcam.intrinsics(640.0, 640.0, 320.0, 240.0, dtype=jnp.float32)
    Kt = tcam.intrinsics(640.0, 640.0, 320.0, 240.0)
    _close(Kj, Kt)
    _close(jcam.invert_intrinsics(Kj), tcam.invert_intrinsics(Kt))
    _close(jcam.normalize_points(jnp.asarray(pts), Kj),
           tcam.normalize_points(torch.from_numpy(pts), Kt))


def test_epipolar():
    rng = np.random.default_rng(3)
    E = rng.normal(size=(8, 3, 3)).astype(np.float32)
    x1 = rng.uniform(-0.5, 0.5, (8, 40, 2)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (8, 40, 2)).astype(np.float32)
    K = np.array([[640, 0, 320], [0, 640, 240], [0, 0, 1]], np.float32)
    _close(jepi.sampson_error(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2)),
           tepi.sampson_error(torch.from_numpy(E), torch.from_numpy(x1), torch.from_numpy(x2)))
    Fj = jepi.fundamental_from_essential(jnp.asarray(E), jnp.asarray(K))
    Ft = tepi.fundamental_from_essential(torch.from_numpy(E), torch.from_numpy(K))
    _close(Fj, Ft)
    p1 = (x1 * 640 + 300).astype(np.float32)
    p2 = (x2 * 640 + 300).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jepi.algebraic_residual(Fj, jnp.asarray(p1), jnp.asarray(p2))),
        tepi.algebraic_residual(Ft, torch.from_numpy(p1), torch.from_numpy(p2)).numpy(),
        rtol=1e-4, atol=1e-6)  # |x2^T F x1| cancels terms of 1e3 magnitude


def test_cheirality_mask():
    """Points in front of, behind and beyond the depth cutoff of both
    views give the same mask; none sits within 1e-3 of a boundary."""
    rng = np.random.default_rng(5)
    n = 400
    X = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                        rng.choice([-1.0, 1.0], (n, 1)) * rng.uniform(1, 80, (n, 1))], -1)
    R = _rot(rng, 1)[0]
    R = (np.eye(3) + 0.05 * (R - np.eye(3))).astype(np.float64)
    U, _, Vt = np.linalg.svd(R)
    R = (U @ Vt).astype(np.float32)
    t = np.array([0.4, -0.1, 0.2], np.float32)
    Xc = X @ R.T + t
    keep = (np.abs(X[:, 2]) > 1e-3) & (np.abs(Xc[:, 2]) > 1e-3)
    keep &= (np.abs(np.abs(X[:, 2]) - 50) > 0.5) & (np.abs(np.abs(Xc[:, 2]) - 50) > 0.5)
    x1 = (X[keep, :2] / X[keep, 2:]).astype(np.float32)
    x2 = (Xc[keep, :2] / Xc[keep, 2:]).astype(np.float32)
    j = np.asarray(jtri.cheirality_mask(jnp.asarray(R), jnp.asarray(t),
                                        jnp.asarray(x1), jnp.asarray(x2), 50.0))
    c = ttri.cheirality_mask(torch.from_numpy(R), torch.from_numpy(t),
                             torch.from_numpy(x1), torch.from_numpy(x2), 50.0).numpy()
    assert 0.2 < j.mean() < 0.8
    np.testing.assert_array_equal(j, c)
