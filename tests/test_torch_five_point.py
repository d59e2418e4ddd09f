"""The port's remaining 5-point entry points against tpu_vo's in float64:
the per-sample five_point_candidates, and root_method="dk"
(Durand-Kerner) at 100 iterations on the batched solver. Every valid
candidate of one has a valid candidate of the other within 1e-4
(Frobenius, up to sign) on every sample (63 of the 64 DK samples agree
within 1e-6; the other, ill-conditioned, within 6.2e-6 under either root
method), and each finds the true E within 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_vo.estimation import five_point as j5
from tpu_vo_torch.estimation import five_point as t5
from _torch_threads import _one_thread  # noqa: F401

TOL = 1e-4        # candidate sets of the two packages
TRUTH_TOL = 1e-6  # a candidate that is the true E


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _samples(seed, n):
    """(x1, x2) (n, 5, 2) exact correspondences and the true E (n, 3, 3)."""
    rng = np.random.default_rng(seed)
    x1, x2, Es = [], [], []
    for _ in range(n):
        R = _rodrigues(rng.uniform(-0.1, 0.1, 3))
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        X = np.concatenate([rng.uniform(-3, 3, (5, 2)), rng.uniform(2, 10, (5, 1))], -1)
        Xc = X @ R.T + t
        x1.append(X[:, :2] / X[:, 2:])
        x2.append(Xc[:, :2] / Xc[:, 2:])
        E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R
        Es.append(E / np.linalg.norm(E))
    return np.asarray(x1), np.asarray(x2), np.asarray(Es)


def _dist(Ea, Eb):
    """(..., 10, 10) Frobenius distances up to sign."""
    return np.minimum(np.linalg.norm(Ea[..., :, None, :, :] - Eb[..., None, :, :, :], axis=(-2, -1)),
                      np.linalg.norm(Ea[..., :, None, :, :] + Eb[..., None, :, :, :], axis=(-2, -1)))


def _same_sets(Ea, va, Eb, vb):
    d = _dist(Ea, Eb)
    a_in_b = np.where(vb[..., None, :], d, np.inf).min(-1) < TOL
    b_in_a = np.where(va[..., :, None], d, np.inf).min(-2) < TOL
    return bool(np.where(va, a_in_b, True).all() and np.where(vb, b_in_a, True).all())


def _hits_truth(E, v, Etrue):
    d = np.minimum(np.linalg.norm(E - Etrue[..., None, :, :], axis=(-2, -1)),
                   np.linalg.norm(E + Etrue[..., None, :, :], axis=(-2, -1)))
    return np.where(v, d, np.inf).min(-1) < TRUTH_TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_five_point_candidates_per_sample(seed):
    x1, x2, Etrue = _samples(seed, 1)
    Ej, vj = (np.asarray(a) for a in jax.jit(j5.five_point_candidates)(jnp.asarray(x1[0]),
                                                                       jnp.asarray(x2[0])))
    Et, vt = t5.five_point_candidates(torch.from_numpy(x1[0]), torch.from_numpy(x2[0]))
    assert Et.shape == (10, 3, 3) and vt.shape == (10,) and Et.dtype == torch.float64
    Et, vt = Et.numpy(), vt.numpy()
    assert vt.sum() >= 1 and _same_sets(Ej, vj, Et, vt)
    assert bool(_hits_truth(Et, vt, Etrue[0])) and bool(_hits_truth(Ej, vj, Etrue[0]))


def test_durand_kerner_100_iterations():
    x1, x2, Etrue = _samples(3, 64)
    run = jax.jit(lambda a, b: j5.five_point_candidates_batched(a, b, dk_iters=100,
                                                                root_method="dk"))
    Ej, vj = (np.asarray(a) for a in run(jnp.asarray(x1), jnp.asarray(x2)))
    Et, vt = (a.numpy() for a in t5.five_point_candidates_batched(
        torch.from_numpy(x1), torch.from_numpy(x2), dk_iters=100, root_method="dk"))
    assert _same_sets(Ej, vj, Et, vt)
    assert _hits_truth(Et, vt, Etrue).mean() >= 0.95
    assert _hits_truth(Et, vt, Etrue).mean() == _hits_truth(Ej, vj, Etrue).mean()
    # Aberth at its 24 finds the same true solutions as DK at 100
    Ea, va = (a.numpy() for a in t5.five_point_candidates_batched(torch.from_numpy(x1),
                                                                  torch.from_numpy(x2)))
    assert (_hits_truth(Ea, va, Etrue) >= _hits_truth(Et, vt, Etrue)).all()


def test_unknown_root_method_raises():
    x1, x2, _ = _samples(4, 1)
    with pytest.raises(ValueError):
        t5.five_point_candidates_batched(torch.from_numpy(x1), torch.from_numpy(x2),
                                         root_method="jenkins-traub")
