"""The rest of the port's geometry (camera, se3, epipolar, triangulation:
the functions the pipeline does not call) against tpu_vo on random
float64 batches, within 1e-10 (the DLT's homogeneous points up to sign
and scale; its masks equal)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_vo.geometry import camera as jcam, epipolar as jepi, se3 as jse3
from tpu_vo.geometry import triangulation as jtri
from tpu_vo_torch.geometry import camera as tcam, epipolar as tepi, se3 as tse3
from tpu_vo_torch.geometry import triangulation as ttri
from _torch_threads import _one_thread  # noqa: F401

TOL = 1e-10


def _rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.asarray(jse3.quaternion_to_rotation(jnp.asarray(q)))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=tol, atol=tol)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_camera_functions():
    rng = np.random.default_rng(0)
    _close(jcam.intrinsics_from_image_size(1241, 376, jnp.float64),
           tcam.intrinsics_from_image_size(1241, 376, torch.float64))
    K = np.asarray(jcam.intrinsics(718.9, 700.1, 607.2, 185.2, jnp.float64))
    pts = rng.normal(size=(4, 50, 2))
    _close(jcam.denormalize_points(jnp.asarray(pts), jnp.asarray(K)),
           tcam.denormalize_points(_t(pts), _t(K)))
    P = np.concatenate([rng.normal(size=(4, 50, 2)), rng.uniform(1, 9, (4, 50, 1))], -1)
    _close(jcam.project(jnp.asarray(P), jnp.asarray(K)), tcam.project(_t(P), _t(K)))


def test_se3_functions():
    rng = np.random.default_rng(1)
    R, t = _rot(rng, 32), rng.normal(size=(32, 3))
    _close(jse3.homogeneous(jnp.asarray(R), jnp.asarray(t)), tse3.homogeneous(_t(R), _t(t)))
    _close(jse3.homogeneous(jnp.asarray(R[0]), jnp.asarray(t)),
           tse3.homogeneous(_t(R[0]), _t(t)))
    ji = jse3.inverse(jse3.Pose(jnp.asarray(R), jnp.asarray(t)))
    ti = tse3.inverse(tse3.Pose(_t(R), _t(t)))
    _close(ji.R, ti.R)
    _close(ji.t, ti.t)
    pts = rng.normal(size=(32, 3))
    _close(jse3.transform_points(jse3.Pose(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(pts)),
           tse3.transform_points(tse3.Pose(_t(R), _t(t)), _t(pts)))
    axis, ang = rng.normal(size=(32, 3)), rng.uniform(-3, 3, 32)
    _close(jse3.rotation_from_axis_angle(jnp.asarray(axis), jnp.asarray(ang)),
           tse3.rotation_from_axis_angle(_t(axis), _t(ang)))
    R2 = _rot(rng, 32)
    _close(jse3.geodesic_rotation_distance(jnp.asarray(R), jnp.asarray(R2)),
           tse3.geodesic_rotation_distance(_t(R), _t(R2)), 1e-8)
    d0 = tse3.geodesic_rotation_distance(_t(R), _t(R))
    assert float(d0.abs().max()) < 1e-6


def test_epipolar_functions():
    rng = np.random.default_rng(2)
    R, t = _rot(rng, 8), rng.normal(size=(8, 3))
    E = np.asarray(jepi.essential_from_Rt(jnp.asarray(R), jnp.asarray(t)))
    _close(E, tepi.essential_from_Rt(_t(R), _t(t)))
    K = np.asarray(jcam.intrinsics_from_image_size(640, 480, jnp.float64))
    F = np.asarray(jepi.fundamental_from_essential(jnp.asarray(E), jnp.asarray(K)))
    _close(jepi.essential_from_fundamental(jnp.asarray(F), jnp.asarray(K)),
           tepi.essential_from_fundamental(_t(F), _t(K)))
    x1, x2 = rng.uniform(0, 640, (8, 40, 2)), rng.uniform(0, 640, (8, 40, 2))
    lj = jepi.epipolar_line(jnp.asarray(F), jnp.asarray(x1))
    lt = tepi.epipolar_line(_t(F), _t(x1))
    _close(lj, lt)
    lines = np.asarray(lj).copy()
    lines[0, :3, :2] = 0.0  # degenerate lines: inf
    _close(jepi.point_line_distance(jnp.asarray(lines), jnp.asarray(x2)),
           tepi.point_line_distance(_t(lines), _t(x2)))
    Fz = F.copy()
    Fz[1] = 0.0
    _close(jepi.normalize_frobenius(jnp.asarray(Fz)), tepi.normalize_frobenius(_t(Fz)))
    _close(jepi.one_based_shift_matrix(), tepi.one_based_shift_matrix())
    F1 = jepi.convert_F_0based_to_1based(jnp.asarray(F))
    _close(F1, tepi.convert_F_0based_to_1based(_t(F)))
    _close(jepi.convert_F_1based_to_0based(F1), tepi.convert_F_1based_to_0based(_t(F1)))


def _scene(rng, batch, n, noise):
    ang = rng.normal(size=(batch, 3)) * 0.05
    R = np.asarray(jse3.rotation_from_axis_angle(jnp.asarray(ang),
                                                 jnp.linalg.norm(jnp.asarray(ang), axis=-1)))
    t = rng.normal(size=(batch, 3))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    X = np.concatenate([rng.uniform(-3, 3, (batch, n, 2)), rng.uniform(-4, 70, (batch, n, 1))], -1)
    Xc = np.einsum("bij,bnj->bni", R, X) + t[:, None]
    x1 = X[..., :2] / X[..., 2:] + rng.normal(0, noise, (batch, n, 2))
    x2 = Xc[..., :2] / Xc[..., 2:] + rng.normal(0, noise, (batch, n, 2))
    return R, t, x1, x2


def test_triangulation_functions():
    rng = np.random.default_rng(3)
    R, t, x1, x2 = _scene(rng, 6, 80, 1e-3)
    P0 = np.asarray(jtri.projection_matrix(jnp.asarray(R), jnp.asarray(t)))
    _close(P0, ttri.projection_matrix(_t(R), _t(t)))
    eye = np.broadcast_to(np.eye(3), R.shape)
    Pa = jtri.projection_matrix(jnp.asarray(eye), jnp.zeros((6, 3)))
    Qj = np.asarray(jtri.triangulate_dlt(Pa, jnp.asarray(P0), jnp.asarray(x1), jnp.asarray(x2)))
    Pt = ttri.projection_matrix(_t(eye), torch.zeros(6, 3, dtype=torch.float64))
    Qt = ttri.triangulate_dlt(Pt, _t(P0), _t(x1), _t(x2)).numpy()
    # null vectors agree up to sign
    s = np.sign((Qj * Qt).sum(-1, keepdims=True))
    np.testing.assert_allclose(Qj, s * Qt, atol=1e-8)
    for dist in (50.0, 20.0):
        mj = np.asarray(jtri.cheirality_mask(jnp.asarray(R), jnp.asarray(t), jnp.asarray(x1),
                                             jnp.asarray(x2), dist, method="dlt"))
        mt = ttri.cheirality_mask(_t(R), _t(t), _t(x1), _t(x2), dist, method="dlt").numpy()
        np.testing.assert_array_equal(mj, mt)
        assert 0 < mt.mean() < 1
    zj = jtri.depths_in_both_views(jnp.asarray(R), jnp.asarray(t), jnp.asarray(x1),
                                   jnp.asarray(x2))
    zt = ttri.depths_in_both_views(_t(R), _t(t), _t(x1), _t(x2))
    for a, b in zip(zj, zt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-7, atol=1e-8)
    Xw = rng.normal(size=(6, 80, 3)) + [0, 0, 5]
    _close(jtri.reprojection_error(jnp.asarray(P0), jnp.asarray(Xw), jnp.asarray(x2)),
           ttri.reprojection_error(_t(P0), _t(Xw), _t(x2)), 1e-9)
    with pytest.raises(ValueError):
        ttri.cheirality_mask(_t(R), _t(t), _t(x1), _t(x2), method="svd")
