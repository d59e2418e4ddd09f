"""The port's window refinement (models/refinement) against tpu_vo's:
so3_exp at and near 0 and at pi; refine_relative_pose_lm and
refine_window in float64 within 1e-9, in float32 within 2e-4 (rotation
and translation entries; measured up to 7.4e-5) and costs within 1e-4
relative (measured up to 5.4e-6), the improved flags equal; the analytic Jacobians equal torch.func.jacfwd's within 1e-11
relative; a singular normal system (every point masked, lambda0 = 0) is
rejected, not raised, in a batch whose other pairs still refine."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_vo.models import refinement as jref
from tpu_vo_torch.models import refinement as tref
from _torch_threads import _one_thread  # noqa: F401

F64_TOL = 1e-9
F32_TOL, F32_COST_RTOL = 2e-4, 1e-4


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _window(seed, P=5, N=80, noise=2e-3, outliers=0.2):
    """(x1, x2, mask, R0, t0): P noisy two-view pairs with outliers under
    the mask's False, and RANSAC-like starts perturbed from the truth."""
    rng = np.random.default_rng(seed)
    x1s, x2s, R0s, t0s = [], [], [], []
    for _ in range(P):
        R = _rodrigues(rng.normal(size=3) * 0.05)
        t = np.array([0.1, 0.0, 1.0]) + rng.normal(size=3) * 0.1
        t /= np.linalg.norm(t)
        X = np.concatenate([rng.uniform(-3, 3, (N, 2)), rng.uniform(3, 20, (N, 1))], -1)
        Xc = X @ R.T + t
        x1s.append(X[:, :2] / X[:, 2:] + rng.normal(0, noise, (N, 2)))
        x2s.append(Xc[:, :2] / Xc[:, 2:] + rng.normal(0, noise, (N, 2)))
        R0s.append(_rodrigues(rng.normal(size=3) * 0.01) @ R)
        t0 = t + rng.normal(size=3) * 0.05
        t0s.append(t0 / np.linalg.norm(t0))
    mask = rng.random((P, N)) > outliers
    return np.asarray(x1s), np.asarray(x2s), mask, np.asarray(R0s), np.asarray(t0s)


def _both_window(data, dtype, iters=8):
    x1, x2, mask, R0, t0 = data
    cast = [a.astype(dtype) if a.dtype != bool else a for a in data]
    j = jref.refine_window(*(jnp.asarray(a) for a in cast), iters=iters)
    t = tref.refine_window(*(torch.from_numpy(a) for a in cast), iters=iters)
    return j, t


def test_so3_exp_near_zero_and_at_pi():
    ws = np.array([[0.0, 0.0, 0.0], [1e-8, -2e-8, 5e-9], [1e-4, 2e-3, -1e-3],
                   [np.pi, 0.0, 0.0], [0.0, np.pi / np.sqrt(2), np.pi / np.sqrt(2)]])
    got = tref.so3_exp(torch.from_numpy(ws)).numpy()
    want = np.asarray(jref.so3_exp(jnp.asarray(ws)))
    np.testing.assert_allclose(got, want, atol=1e-15)
    np.testing.assert_array_equal(got[0], np.eye(3))
    np.testing.assert_allclose(got[1], np.eye(3), atol=3e-8)
    for w, R in zip(ws[2:], got[2:]):
        np.testing.assert_allclose(R, _rodrigues(w), atol=1e-14)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-14)
    np.testing.assert_allclose(np.trace(got[3]), -1.0, atol=1e-14)   # a half turn
    # the derivative at 0 is the generator (the series branch)
    J = torch.func.jacfwd(tref.so3_exp)(torch.zeros(3, dtype=torch.float64))
    np.testing.assert_allclose(J[..., 2].numpy(), [[0, -1, 0], [1, 0, 0], [0, 0, 0]])


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_window_f64(seed):
    j, t = _both_window(_window(seed), np.float64)
    assert t.R_rel.dtype == torch.float64 and bool(t.improved.any())
    np.testing.assert_array_equal(np.asarray(j.improved), t.improved.numpy())
    for a, b in ((j.R_rel, t.R_rel), (j.t_rel, t.t_rel), (j.cost, t.cost)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=F64_TOL, atol=F64_TOL)


def test_refine_window_f32():
    j, t = _both_window(_window(2), np.float32)
    assert t.R_rel.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(j.improved), t.improved.numpy())
    for a, b in ((j.R_rel, t.R_rel), (j.t_rel, t.t_rel)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=F32_TOL)
    np.testing.assert_allclose(np.asarray(j.cost), t.cost.numpy(), rtol=F32_COST_RTOL)


def test_refine_relative_pose_lm_single_pair_f64():
    x1, x2, mask, R0, t0 = (a[3] for a in _window(3))
    j = jref.refine_relative_pose_lm(*(jnp.asarray(a) for a in (x1, x2, mask, R0, t0)), iters=5)
    t = tref.refine_relative_pose_lm(*(torch.from_numpy(a) for a in (x1, x2, mask, R0, t0)),
                                     iters=5)
    assert t.R.shape == (3, 3) and t.t.shape == (3,) and t.cost.shape == ()
    for a, b in zip(j, t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=F64_TOL, atol=F64_TOL)
    # the refined cost is no higher than the start's
    j0 = jref.refine_relative_pose_lm(*(jnp.asarray(a) for a in (x1, x2, mask, R0, t0)), iters=0)
    assert float(t.cost) <= float(j0.cost)


def test_singular_system_is_rejected_not_raised():
    x1, x2, mask, R0, t0 = _window(4, P=3)
    mask[1] = False   # J = 0 and lambda0 = 0: the normal matrix is exactly 0
    args = [torch.from_numpy(a) for a in (x1, x2, mask, R0, t0)]
    out = tref.refine_relative_pose_lm(*args, iters=4, lambda0=0.0)
    assert bool(torch.isfinite(out.R).all() and torch.isfinite(out.t).all())
    assert not bool(out.improved[1]) and bool(out.improved[0]) and bool(out.improved[2])
    assert torch.equal(out.R[1], args[3][1]) and torch.equal(out.t[1], args[4][1])
    j = jref.refine_relative_pose_lm(*(jnp.asarray(a[1]) for a in (x1, x2, mask, R0, t0)),
                                     iters=4, lambda0=0.0)
    assert not bool(j.improved)
    np.testing.assert_array_equal(np.asarray(j.R), out.R[1].numpy())
    A = torch.zeros(2, 6, 6, dtype=torch.float64)
    A[0] = torch.eye(6)
    _, info = torch.linalg.solve_ex(A, torch.ones(2, 6, dtype=torch.float64))
    assert info.tolist()[0] == 0 and info.tolist()[1] != 0


@pytest.mark.parametrize("scale", [0.0, 1e-9, 1e-3, 0.3, 2.0])
def test_analytic_jacobian_equals_jacfwd(scale):
    x1, x2, mask, R0, t0 = (torch.from_numpy(a) for a in _window(6))
    g = torch.Generator().manual_seed(int(scale * 1e9) % 1000)
    p = torch.randn(x1.shape[0], 6, dtype=torch.float64, generator=g) * scale
    w = mask.double()
    r, J = tref._residuals_and_jacobian(p, x1, x2, w, R0, t0)
    want = torch.func.vmap(torch.func.jacfwd(tref._residuals))(p, x1, x2, w, R0, t0)
    assert torch.equal(r, tref._residuals(p, x1, x2, w, R0, t0))
    assert float((J - want).abs().max()) <= 1e-11 * float(want.abs().max())


def test_triangulate_pair_points():
    x1, x2, _, R0, t0 = _window(5, P=2)
    for p in range(2):
        j = jref.triangulate_pair_points(jnp.asarray(R0[p]), jnp.asarray(t0[p]),
                                         jnp.asarray(x1[p]), jnp.asarray(x2[p]))
        t = tref.triangulate_pair_points(torch.from_numpy(R0[p]), torch.from_numpy(t0[p]),
                                         torch.from_numpy(x1[p]), torch.from_numpy(x2[p]))
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-10, atol=1e-10)
    tb = tref.triangulate_pair_points(*(torch.from_numpy(a) for a in (R0, t0, x1, x2)))
    np.testing.assert_allclose(tb[1].numpy(), t.numpy(), rtol=1e-12, atol=1e-12)
