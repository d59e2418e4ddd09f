"""The port's array-of-structures 5-point helpers against tpu_vo's in
float64, on 64 samples of a random two-view scene (5 exact
correspondences each). Each helper gets tpu_vo's own input for its
stage, so no error compounds; the errors are relative to the largest
magnitude of each sample's reference output. The roots are compared as
sorted real parts where tpu_vo's backward error is below 1e-8, and the
AoS chain's real roots against the SoA chain's (the main path's form).
Float32 is not compared: the roots are chaotic there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_vo.estimation import five_point as j5
from tpu_vo_torch.estimation import five_point as t5

REL = 1e-10        # the polynomial and linear-algebra helpers
ROOTS = 1e-8       # roots, as sorted real parts
N = 64


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _samples(seed=0, n=N):
    """(x1, x2) (n, 5, 2): 5 points of a random scene seen from two poses."""
    rng = np.random.default_rng(seed)
    x1, x2 = [], []
    for _ in range(n):
        R = _rodrigues(rng.uniform(-0.1, 0.1, 3))
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        X = np.concatenate([rng.uniform(-3, 3, (5, 2)), rng.uniform(2, 10, (5, 1))], -1)
        Xc = X @ R.T + t
        x1.append(X[:, :2] / X[:, 2:])
        x2.append(Xc[:, :2] / Xc[:, 2:])
    return np.asarray(x1), np.asarray(x2)


def _scaled(A):
    return A / jnp.maximum(jnp.max(jnp.abs(A), axis=-1, keepdims=True), 1e-30)


@pytest.fixture(scope="module")
def ref():
    """tpu_vo's chain, stage by stage, per sample (vmap)."""
    x1, x2 = _samples()
    basis = jax.vmap(j5._nullspace_basis)(jnp.asarray(x1), jnp.asarray(x2))
    A = jax.vmap(j5._constraint_matrix)(basis)
    Ared = jax.vmap(j5._gauss_jordan)(_scaled(A))
    B = jax.vmap(j5._action_polynomials)(Ared[:, :, 10:])
    p = jax.vmap(j5._det_poly)(B)
    roots, ok = jax.vmap(j5._poly_roots)(p)
    berr = jax.vmap(j5._poly_backward_error)(p, roots)
    z = jax.vmap(j5._newton_real)(p, jnp.real(roots))
    return {k: np.asarray(v) if not isinstance(v, list) else v for k, v in dict(
        x1=x1, x2=x2, basis=basis, A=A, Ared=Ared, B=B, p=p, roots=roots, ok=ok,
        berr=berr, z=z).items()}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).reshape(len(want), -1).max(-1)
    err = np.abs(got - want).reshape(len(want), -1).max(-1)
    return float((err / np.maximum(scale, 1e-300)).max())


def _pairs(seed, la, lb):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, la)), rng.normal(size=(N, lb))


def _run(name, r):
    """(port output, tpu_vo output) of helper `name` on tpu_vo's input."""
    if name == "_nullspace_basis":
        return t5._nullspace_basis(_t(r["x1"]), _t(r["x2"])), r["basis"]
    if name == "_constraint_matrix":
        return t5._constraint_matrix(_t(r["basis"])), r["A"]
    if name == "_gauss_jordan":
        A = np.asarray(_scaled(jnp.asarray(r["A"])))
        return t5._gauss_jordan(_t(A)), r["Ared"]
    if name == "_action_polynomials":
        got = t5._action_polynomials(_t(r["Ared"][:, :, 10:]))
        return (torch.cat([torch.cat(row, -1) for row in got], -1),
                np.concatenate([np.concatenate([np.asarray(b) for b in row], -1)
                                for row in r["B"]], -1))
    if name == "_det_poly":
        B = [tuple(_t(np.asarray(b)) for b in row) for row in r["B"]]
        return t5._det_poly(B), r["p"]
    if name in ("_mul11", "_mul21", "_conv"):
        la, lb = {"_mul11": (4, 4), "_mul21": (10, 4), "_conv": (5, 7)}[name]
        p, q = _pairs(len(name), la, lb)
        fn = j5._conv if name == "_conv" else getattr(j5, name)
        return getattr(t5, name)(_t(p), _t(q)), jax.vmap(fn)(jnp.asarray(p), jnp.asarray(q))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["_nullspace_basis", "_constraint_matrix", "_gauss_jordan",
                                  "_action_polynomials", "_det_poly", "_mul11", "_mul21",
                                  "_conv"])
def test_aos_helper_matches_tpu_vo(ref, name):
    got, want = _run(name, ref)
    assert got.dtype == torch.float64
    assert tuple(got.shape) == np.asarray(want).shape
    assert _rel_err(got.numpy(), want) < REL


def test_poly_roots_match_tpu_vo(ref):
    roots, ok = t5._poly_roots(_t(ref["p"]))
    assert roots.dtype == torch.complex128
    np.testing.assert_array_equal(ok.numpy(), ref["ok"])
    good = ref["berr"].max(-1) < 1e-8
    assert good.sum() >= N // 2, good.sum()
    got = np.sort(roots.real.numpy(), -1)[good]
    want = np.sort(np.real(ref["roots"]), -1)[good]
    assert np.abs(got - want).max() < ROOTS
    berr = t5._poly_backward_error(_t(ref["p"]), roots).numpy()
    assert berr[good].max() < 1e-8


def test_newton_real_matches_tpu_vo(ref):
    """Newton from every root's real part; compared on the roots it
    polishes, those whose iterate lies near the real axis (from the real
    part of a complex root, 8 steps off the axis amplify XLA's fused
    multiply-adds to about 2e-9)."""
    z = t5._newton_real(_t(ref["p"]), _t(np.real(ref["roots"]))).numpy()
    roots = ref["roots"]
    near = np.abs(np.imag(roots)) < 1e-6 * (1.0 + np.abs(np.real(roots)))
    assert near.sum() >= N
    np.testing.assert_array_equal(np.isfinite(z), np.isfinite(ref["z"]))
    assert (np.abs(z - ref["z"])[near] / np.maximum(1.0, np.abs(ref["z"][near]))).max() < REL


def _real_roots(z, roots):
    """Sorted polished roots whose iterate lies near the real axis."""
    near = np.abs(np.imag(roots)) < 1e-6 * (1.0 + np.abs(np.real(roots)))
    return [np.sort(zi[ni]) for zi, ni in zip(z, near)]


def test_aos_chain_real_roots_equal_soa_chain(ref):
    """The port's AoS chain and its SoA chain (root_method "dk", 100
    iterations, 8 Newton steps, as the AoS chain) find the same real
    roots on every sample where tpu_vo's backward error is below 1e-8."""
    x1, x2 = _t(ref["x1"]), _t(ref["x2"])
    basis = t5._nullspace_basis(x1, x2)
    A = t5._constraint_matrix(basis)
    A = A / torch.clamp(torch.abs(A).amax(-1, keepdim=True), min=1e-30)
    p = t5._det_poly(t5._action_polynomials(t5._gauss_jordan(A)[..., 10:]))
    roots, _ = t5._poly_roots(p)
    aos = _real_roots(t5._newton_real(p, roots.real).numpy(), roots.numpy())

    sb = t5._soa_nullspace(x1, x2)
    sA = t5._soa_constraint_matrix(sb)
    sA = sA / torch.clamp(torch.abs(sA).amax(-2, keepdim=True), min=1e-30)
    _, _, _, sp = t5._soa_action_det(t5._soa_gauss_jordan(sA)[..., :, 10:, :])
    sroots, _ = t5._soa_poly_roots(sp, iters=100, method="dk")
    sp, sroots = sp.T, sroots.T                      # (n, 11), (n, 10)
    soa = _real_roots(t5._newton_real(sp, sroots.real).numpy(), sroots.numpy())

    good = ref["berr"].max(-1) < 1e-8
    for i in np.flatnonzero(good):
        assert len(aos[i]) == len(soa[i]) >= 1, i
        assert np.abs(aos[i] - soa[i]).max() < ROOTS * max(1.0, np.abs(soa[i]).max()), i
