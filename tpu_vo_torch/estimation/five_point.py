"""Nister 5-point minimal essential-matrix solver in structure-of-arrays
form (port of tpu_vo/estimation/five_point.py,
`five_point_candidates_batched` and its `_soa_*` helpers, and the
per-sample `five_point_candidates`).

Every intermediate carries the sample axis last, (..., small, n):

  1. 4-dim nullspace of the 5x9 epipolar system by 5 unrolled
     Householder reflections;
  2. the 10 cubic constraints as a (10, 20) coefficient matrix, built
     with static monomial multiplication tables;
  3. Gauss-Jordan elimination with partial pivoting, then the degree-10
     hidden-variable determinant in z;
  4. its roots by simultaneous iteration in complex64 (a Python loop over
     the whole (pairs x samples) batch): Aberth-Ehrlich (the default) or
     Durand-Kerner (root_method="dk", the reference iteration), plus
     Newton polish on the real axis;
  5. back-substitution of (x, y) from the null vector of B(z): up to 10
     Frobenius-normalized candidates per sample with a validity mask.

On a CUDA device `five_point_candidates_batched` replays one CUDA graph
per call signature (utils/cuda_graphs.GraphCache; its spans
five_point.capture and five_point.replay): one launch in place of some
2,800, bit for bit the eager path. The signature holds the TF32 matmul
flag, which the capture fixes. CPU inputs and the per-sample
`five_point_candidates` run eagerly.

The array-of-structures helpers of tpu_vo (`_mul11` ... `_newton_real`),
which carry one sample's matrices minor-most and batch over leading
dims, are here too under their names: the main path does not run them;
tools/profile_5pt_micro and tools/profile_ransac time them beside the
SoA form.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_vo_torch.utils.cuda_graphs import GraphCache

# Copied from tpu_vo/estimation/five_point.py: monomial bases in Nister's
# ordering and their multiplication tables.
_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x, y, z, 1
_DEG2 = [
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
_DEG3 = [
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1),
    (1, 1, 1), (0, 2, 1), (2, 0, 0), (1, 1, 0), (0, 2, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]


def _mul_table(basis_a, basis_b, basis_out):
    idx = {m: i for i, m in enumerate(basis_out)}
    T = np.zeros((len(basis_a), len(basis_b), len(basis_out)), dtype=np.float32)
    for i, a in enumerate(basis_a):
        for j, b in enumerate(basis_b):
            m = (a[0] + b[0], a[1] + b[1], a[2] + b[2])
            T[i, j, idx[m]] = 1.0
    return T


_T11 = _mul_table(_DEG1, _DEG1, _DEG2)  # (4, 4, 10)
_T21 = _mul_table(_DEG2, _DEG1, _DEG3)  # (10, 4, 20)


# The 0/1 tables and index lists below are built and copied to the device
# once per (dtype, device): a copy from pageable host memory waits for
# the stream to drain.
@functools.lru_cache(maxsize=None)
def _table(key, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(s, t) 0/1 selection table: "t11" and "t21" are the multiplication
    tables flattened to (a*b, t); ("conv", lp, lq) is the full
    convolution of lengths lp and lq."""
    if key == "t11":
        S = _T11.reshape(16, 10)
    elif key == "t21":
        S = _T21.reshape(40, 20)
    else:
        _, lp, lq = key
        S = np.zeros((lp * lq, lp + lq - 1), dtype=np.float32)
        for i in range(lp):
            for j in range(lq):
                S[i * lq + j, i + j] = 1.0
    return torch.as_tensor(S, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _minor_index(device: torch.device):
    """Rows (i, j) of the three 2x2 minors taken in _soa_action_det."""
    return (torch.tensor([1, 0, 0], device=device),
            torch.tensor([2, 2, 1], device=device))


@functools.lru_cache(maxsize=None)
def _start_ring(deg: int, cdtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(deg, 1) unit-circle starting points of the Aberth iteration."""
    angles = 2.0 * np.pi * np.arange(deg) / deg + 0.7
    return torch.as_tensor(np.exp(1j * angles), device=device).to(cdtype)[:, None]


def _select(key, P: torch.Tensor) -> torch.Tensor:
    """einsum("st,...sn->...tn") with the static 0/1 table `key`."""
    return torch.matmul(_table(key, P.dtype, P.device).transpose(0, 1), P)


# ---------------------------------------------------------------------------
# Array-of-structures helpers (tpu_vo's per-sample form, batched over
# leading dims): not on the main path
# ---------------------------------------------------------------------------

def _mul11(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(..., 4) x (..., 4) -> (..., 10) polynomial product."""
    P = p[..., :, None] * q[..., None, :]
    return P.reshape(*P.shape[:-2], 16) @ _table("t11", p.dtype, p.device)


def _mul21(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(..., 10) x (..., 4) -> (..., 20) polynomial product."""
    P = p[..., :, None] * q[..., None, :]
    return P.reshape(*P.shape[:-2], 40) @ _table("t21", p.dtype, p.device)


def _nullspace_basis(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """4-dim nullspace of the 5x9 epipolar system of (..., 5, 2)
    correspondences, as (..., 4, 3, 3) matrices: 5 unrolled Householder
    reflections on A^T (9x5), then the last 4 identity columns pushed
    back through the reflectors."""
    dtype, dev = x1.dtype, x1.device
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)      # (..., 5, 9)
    M = A.transpose(-1, -2)                             # (..., 9, 5)
    rows = torch.arange(9, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    vs = []
    for k in range(5):
        x = torch.where(rows >= k, M[..., :, k], zero)  # (..., 9)
        nrm = torch.sqrt((x * x).sum(-1))
        sign = torch.where(x[..., k] >= 0, 1.0, -1.0).to(dtype)
        v = x + (sign * nrm)[..., None] * (rows == k).to(dtype)
        vnorm2 = torch.clamp((v * v).sum(-1), min=1e-30)
        vM = (v[..., :, None] * M).sum(-2)              # (..., 5)
        M = M - (2.0 / vnorm2)[..., None, None] * v[..., :, None] * vM[..., None, :]
        vs.append((v, vnorm2))

    B = (rows[:, None] == torch.arange(5, 9, device=dev)[None, :]).to(dtype)  # (9, 4)
    for v, vnorm2 in reversed(vs):
        vB = (v[..., :, None] * B).sum(-2)              # (..., 4)
        B = B - (2.0 / vnorm2)[..., None, None] * v[..., :, None] * vB[..., None, :]
    return B.transpose(-1, -2).reshape(*B.shape[:-2], 4, 3, 3)


def _constraint_matrix(basis: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraints on E(x, y, z) of a (..., 4, 3, 3) basis as
    a (..., 10, 20) coefficient matrix."""
    Ep = basis.movedim(-3, -1)                          # (..., 3, 3, 4)
    lead = Ep.shape[:-3]
    # EE^T (degree 2): P[i, j, a, b] = sum_k Ep[i, k, a] Ep[j, k, b]
    P = (Ep[..., :, None, :, :, None] * Ep[..., None, :, :, None, :]).sum(-3)
    EEt = P.reshape(*lead, 3, 3, 16) @ _table("t11", Ep.dtype, Ep.device)   # (..., 3, 3, 10)
    tr = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]         # (..., 10)

    # 2 EE^T E - tr(EE^T) E (degree 3): Q[i, j, t, a] = sum_k EEt[i, k, t] Ep[k, j, a]
    t21 = _table("t21", Ep.dtype, Ep.device)
    Q = (EEt[..., :, :, None, :, None] * Ep[..., None, :, :, None, :]).sum(-4)
    EEtE = Q.reshape(*lead, 3, 3, 40) @ t21
    trE = (tr[..., None, None, :, None] * Ep[..., :, :, None, :]).reshape(*lead, 3, 3, 40) @ t21
    C = 2.0 * EEtE - trE                                # (..., 3, 3, 20)

    # det(E) (degree 3): cofactor expansion along row 0
    def e(i, j):
        return Ep[..., i, j, :]

    m00 = _mul11(e(1, 1), e(2, 2)) - _mul11(e(1, 2), e(2, 1))
    m01 = _mul11(e(1, 0), e(2, 2)) - _mul11(e(1, 2), e(2, 0))
    m02 = _mul11(e(1, 0), e(2, 1)) - _mul11(e(1, 1), e(2, 0))
    det = _mul21(m00, e(0, 0)) - _mul21(m01, e(0, 1)) + _mul21(m02, e(0, 2))
    return torch.cat([det[..., None, :], C.reshape(*lead, 9, 20)], dim=-2)


def _gauss_jordan(A: torch.Tensor) -> torch.Tensor:
    """Reduce (..., 10, 20) to [I | M] with partial pivoting, branch-free
    (row swap, pivot divide and elimination as masked broadcasts)."""
    n = A.shape[-2]
    rows = torch.arange(n, device=A.device)
    minus1 = torch.full((), -1.0, dtype=A.dtype, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    for i in range(n):
        cand = torch.where(rows >= i, torch.abs(A[..., :, i]), minus1)
        p = torch.argmax(cand, dim=-1)                     # (...,)
        ei = (rows == i).to(A.dtype)[:, None]              # (n, 1)
        ep = (rows == p[..., None]).to(A.dtype)[..., None]  # (..., n, 1)
        Ai = A[..., i, :]
        Ap = (ep * A).sum(-2)                              # (..., 20)
        A = A + ei * (Ap - Ai)[..., None, :] + ep * (Ai - Ap)[..., None, :]
        piv = Ap[..., i]
        safe = torch.where(torch.abs(piv) > 1e-30, piv, torch.full_like(piv, 1e-30))
        Anew_i = Ap / safe[..., None]
        A = A * (1.0 - ei) + ei * Anew_i[..., None, :]
        factors = torch.where(rows == i, zero, A[..., :, i])
        A = A - factors[..., :, None] * Anew_i[..., None, :]
    return A


def _action_polynomials(M: torch.Tensor):
    """B(z) from the reduced tail M = A_reduced[..., :, 10:] (..., 10, 10):
    [(Bx, By, B1)] for the row pairs (4, 7), (5, 8), (6, 9), Bx and By
    (..., 4) and B1 (..., 5) descending in z."""
    def row_pair(ra, rb):
        a, b = M[..., ra, :], M[..., rb, :]
        Bx = torch.stack([-b[..., 0], a[..., 0] - b[..., 1], a[..., 1] - b[..., 2], a[..., 2]],
                         dim=-1)
        By = torch.stack([-b[..., 3], a[..., 3] - b[..., 4], a[..., 4] - b[..., 5], a[..., 5]],
                         dim=-1)
        B1 = torch.stack([-b[..., 6], a[..., 6] - b[..., 7], a[..., 7] - b[..., 8],
                          a[..., 8] - b[..., 9], a[..., 9]], dim=-1)
        return Bx, By, B1

    return [row_pair(4, 7), row_pair(5, 8), row_pair(6, 9)]


def _conv(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Full convolution of (..., lp) and (..., lq) -> (..., lp + lq - 1)."""
    lp, lq = p.shape[-1], q.shape[-1]
    P = p[..., :, None] * q[..., None, :]
    return P.reshape(*P.shape[:-2], lp * lq) @ _table(("conv", lp, lq), p.dtype, p.device)


def _det_poly(B) -> torch.Tensor:
    """det of the 3x3 polynomial matrix -> degree-10 poly (..., 11), descending."""
    (x0, y0, c0), (x1, y1, c1), (x2, y2, c2) = B
    d0 = _conv(c0, _conv(x1, y2) - _conv(y1, x2))
    d1 = _conv(c1, _conv(x0, y2) - _conv(y0, x2))
    d2 = _conv(c2, _conv(x0, y1) - _conv(y0, x1))
    return d0 - d1 + d2


def _polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner over the last axis of coeffs (..., d+1) at x (..., k)."""
    acc = torch.zeros((), dtype=torch.promote_types(coeffs.dtype, x.dtype), device=x.device)
    for k in range(coeffs.shape[-1]):
        acc = acc * x + coeffs[..., k, None]
    return acc


def _poly_roots(coeffs: torch.Tensor, iters: int = 100):
    """All 10 roots of degree-10 polynomials (..., 11) by Durand-Kerner,
    balanced by z = s*u so the constant term has unit magnitude. Returns
    (roots (..., 10) complex, lead_ok (...))."""
    n = coeffs.shape[-1] - 1
    dev = coeffs.device
    lead = coeffs[..., 0]
    lead_ok = torch.abs(lead) > 1e-25
    c = coeffs / torch.where(lead_ok, lead, torch.ones_like(lead))[..., None]

    tail = torch.abs(c[..., -1])
    big = tail > 1e-30
    s = torch.where(big, tail ** (1.0 / n), torch.ones_like(tail))
    powers = s[..., None] ** torch.arange(n, -1, -1, dtype=c.dtype, device=dev)
    cb = c * powers / torch.where(big, tail, torch.ones_like(tail))[..., None]

    cdtype = torch.complex128 if c.dtype == torch.float64 else torch.complex64
    radius = 1.0 + torch.abs(cb[..., 1:]).amax(-1) ** (1.0 / n)
    u = radius[..., None].to(cdtype) * _start_ring(n, cdtype, dev)[:, 0]   # (..., 10)
    cc = cb.to(cdtype)
    eye = torch.eye(n, dtype=cdtype, device=dev)
    for _ in range(iters):
        pu = _polyval(cc, u)
        diff = (u[..., :, None] - u[..., None, :]) * (1.0 - eye) + eye
        denom = _floor_abs(torch.prod(diff, dim=-1), 1e-30)
        step = pu / denom
        mag = torch.abs(step)
        step = torch.where(mag > 10.0, step * (10.0 / mag), step)
        u = u - step
    return u * s[..., None].to(cdtype), lead_ok


def _poly_backward_error(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """|p(z)| / sum_i |c_i| |z|^(n-i): the scale-invariant root residual
    of (..., k) roots of (..., n+1) coefficients."""
    scale = _polyval(torch.abs(coeffs), torch.abs(z))
    return torch.abs(_polyval(coeffs, z)) / torch.clamp(scale, min=1e-30)


def _newton_real(coeffs: torch.Tensor, x0: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Polish (..., k) real roots of (..., n+1) coefficients by Newton
    iterations on the real axis."""
    n = coeffs.shape[-1] - 1
    dcoeffs = coeffs[..., :-1] * torch.arange(n, 0, -1, dtype=coeffs.dtype, device=coeffs.device)
    x = x0
    for _ in range(iters):
        x = x - _polyval(coeffs, x) / _floor_abs(_polyval(dcoeffs, x), 1e-30)
    return x


# ---------------------------------------------------------------------------
# Structure-of-arrays pipeline: the main path
# ---------------------------------------------------------------------------

def _soa_nullspace(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x1/x2 (..., n, 5, 2) -> nullspace basis (..., 4, 9, n)."""
    dtype, dev = x1.dtype, x1.device
    u1 = x1[..., 0].transpose(-1, -2)          # (..., 5, n)
    v1 = x1[..., 1].transpose(-1, -2)
    u2 = x2[..., 0].transpose(-1, -2)
    v2 = x2[..., 1].transpose(-1, -2)
    M = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-3)      # (..., 9, 5, n)
    rows9 = torch.arange(9, device=dev)[:, None]

    vs = []
    for k in range(5):
        x = torch.where(rows9 >= k, M[..., :, k, :], torch.zeros((), dtype=dtype, device=dev))
        nrm = torch.sqrt((x * x).sum(-2))
        sign = torch.where(x[..., k, :] >= 0, 1.0, -1.0).to(dtype)
        v = x + (sign * nrm)[..., None, :] * (rows9 == k).to(dtype)
        vnorm2 = torch.clamp((v * v).sum(-2), min=1e-30)
        vM = (v[..., :, None, :] * M).sum(-3)          # (..., 5, n)
        M = M - (2.0 / vnorm2)[..., None, None, :] * v[..., :, None, :] \
            * vM[..., None, :, :]
        vs.append((v, vnorm2))

    B = (rows9[:, :, None] == torch.arange(5, 9, device=dev)[None, :, None]).to(dtype)
    for v, vnorm2 in reversed(vs):
        vB = (v[..., :, None, :] * B).sum(-3)          # (..., 4, n)
        B = B - (2.0 / vnorm2)[..., None, None, :] * v[..., :, None, :] \
            * vB[..., None, :, :]
    return B.transpose(-3, -2)                          # (..., 4, 9, n)


def _soa_mul(p: torch.Tensor, q: torch.Tensor, table: str) -> torch.Tensor:
    """(..., a, n) x (..., b, n) -[table]-> (..., t, n) polynomial product."""
    P = p[..., :, None, :] * q[..., None, :, :]
    a, b = p.shape[-2], q.shape[-2]
    return _select(table, P.reshape(*P.shape[:-3], a * b, P.shape[-1]))


def _soa_constraint_matrix(basis: torch.Tensor) -> torch.Tensor:
    """basis (..., 4, 9, n) -> constraint system A (..., 10, 20, n)."""
    n = basis.shape[-1]
    lead = basis.shape[:-3]
    Ep = basis.reshape(*lead, 4, 3, 3, n).movedim(-4, -2)   # (..., 3, 3, 4, n)

    P = (Ep[..., :, None, :, :, None, :] * Ep[..., None, :, :, None, :, :]).sum(-4)
    EEt = _select("t11", P.reshape(*lead, 3, 3, 16, n))
    tr = EEt[..., 0, 0, :, :] + EEt[..., 1, 1, :, :] + EEt[..., 2, 2, :, :]

    Q = (EEt[..., :, :, None, :, None, :] * Ep[..., None, :, :, None, :, :]).sum(-5)
    EEtE = _select("t21", Q.reshape(*lead, 3, 3, 40, n))
    trE = _soa_mul(tr[..., None, None, :, :].expand(*lead, 3, 3, 10, n)
                   .reshape(*lead, 9, 10, n),
                   Ep.reshape(*lead, 9, 4, n), "t21").reshape(*lead, 3, 3, 20, n)
    C = 2.0 * EEtE - trE

    def e(i, j):
        return Ep[..., i, j, :, :]

    m00 = _soa_mul(e(1, 1), e(2, 2), "t11") - _soa_mul(e(1, 2), e(2, 1), "t11")
    m01 = _soa_mul(e(1, 0), e(2, 2), "t11") - _soa_mul(e(1, 2), e(2, 0), "t11")
    m02 = _soa_mul(e(1, 0), e(2, 1), "t11") - _soa_mul(e(1, 1), e(2, 0), "t11")
    det = (_soa_mul(m00, e(0, 0), "t21") - _soa_mul(m01, e(0, 1), "t21")
           + _soa_mul(m02, e(0, 2), "t21"))
    return torch.cat([det[..., None, :, :], C.reshape(*lead, 9, 20, n)], dim=-3)


def _soa_gauss_jordan(A: torch.Tensor) -> torch.Tensor:
    """(..., 10, 20, n) -> [I | M] with partial pivoting, branch-free."""
    m = A.shape[-3]
    rows = torch.arange(m, device=A.device)[:, None]
    minus1 = torch.full((), -1.0, dtype=A.dtype, device=A.device)
    for i in range(m):
        cand = torch.where(rows >= i, torch.abs(A[..., :, i, :]), minus1)
        p = torch.argmax(cand, dim=-2)                       # (..., n)
        ei = (rows == i).to(A.dtype)                         # (m, 1)
        ep = (rows == p[..., None, :]).to(A.dtype)           # (..., m, n)
        Ai = A[..., i, :, :]
        Ap = (ep[..., :, None, :] * A).sum(-3)               # (..., 20, n)
        A = (A + ei[:, None] * (Ap - Ai)[..., None, :, :]
             + ep[..., :, None, :] * (Ai - Ap)[..., None, :, :])
        piv = Ap[..., i, :]
        safe = torch.where(torch.abs(piv) > 1e-30, piv, torch.full_like(piv, 1e-30))
        Anew_i = Ap / safe[..., None, :]
        A = A * (1.0 - ei[:, None]) + ei[:, None] * Anew_i[..., None, :, :]
        factors = torch.where(rows == i, torch.zeros((), dtype=A.dtype, device=A.device),
                              A[..., :, i, :])
        A = A - factors[..., :, None, :] * Anew_i[..., None, :, :]
    return A


def _soa_conv(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Full convolution over axis -2: (.., lp, n) x (.., lq, n) -> (.., lp+lq-1, n)."""
    lp, lq = p.shape[-2], q.shape[-2]
    P = p[..., :, None, :] * q[..., None, :, :]
    return _select(("conv", lp, lq), P.reshape(*P.shape[:-3], lp * lq, P.shape[-1]))


def _soa_action_det(M: torch.Tensor):
    """Reduced tail M (..., 10, 10, n) -> (Bx, By, B1, det poly (..., 11, n))."""
    Bx, By, B1 = [], [], []
    for ra, rb in ((4, 7), (5, 8), (6, 9)):
        a, b = M[..., ra, :, :], M[..., rb, :, :]
        Bx.append(torch.stack([-b[..., 0, :], a[..., 0, :] - b[..., 1, :],
                               a[..., 1, :] - b[..., 2, :], a[..., 2, :]], dim=-2))
        By.append(torch.stack([-b[..., 3, :], a[..., 3, :] - b[..., 4, :],
                               a[..., 4, :] - b[..., 5, :], a[..., 5, :]], dim=-2))
        B1.append(torch.stack([-b[..., 6, :], a[..., 6, :] - b[..., 7, :],
                               a[..., 7, :] - b[..., 8, :], a[..., 8, :] - b[..., 9, :],
                               a[..., 9, :]], dim=-2))
    Bx = torch.stack(Bx, dim=-3)                # (..., 3, 4, n)
    By = torch.stack(By, dim=-3)
    B1 = torch.stack(B1, dim=-3)                # (..., 3, 5, n)

    i_idx, j_idx = _minor_index(M.device)
    minors = (_soa_conv(Bx.index_select(-3, i_idx), By.index_select(-3, j_idx))
              - _soa_conv(By.index_select(-3, i_idx), Bx.index_select(-3, j_idx)))
    d = _soa_conv(B1, minors)                   # (..., 3, 11, n)
    det = d[..., 0, :, :] - d[..., 1, :, :] + d[..., 2, :, :]
    return Bx, By, B1, det


def _floor_abs(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x where |x| > eps, else eps (the JAX package's division guard)."""
    return torch.where(torch.abs(x) > eps, x, torch.full_like(x, eps))


def _soa_poly_roots(coeffs: torch.Tensor, iters: int = 24, method: str = "aberth"):
    """Simultaneous roots of (..., 11, n) descending coefficients ->
    (roots (..., 10, n) complex, lead_ok (..., n)); the polynomial is
    balanced by z = s*u so its constant term has unit magnitude.

    method="aberth": Aberth-Ehrlich, Newton steps coupled by the pairwise
    repulsion term (cubic for simple roots; 24 iterations reach the
    Durand-Kerner fixed point of 100). method="dk": Durand-Kerner
    (Weierstrass), p(u_i) / prod_{j != i} (u_i - u_j), the reference
    iteration. Both cap a step's magnitude at 10."""
    if method not in ("aberth", "dk"):
        raise ValueError(f"unknown root method {method!r}")
    deg = coeffs.shape[-2] - 1
    dev = coeffs.device
    lead = coeffs[..., 0, :]
    lead_ok = torch.abs(lead) > 1e-25
    c = coeffs / torch.where(lead_ok, lead, torch.ones_like(lead))[..., None, :]

    tail = torch.abs(c[..., -1, :])
    big = tail > 1e-30
    s = torch.where(big, tail ** (1.0 / deg), torch.ones_like(tail))
    powers = s[..., None, :] ** torch.arange(deg, -1, -1, dtype=c.dtype, device=dev)[:, None]
    cb = c * powers / torch.where(big, tail, torch.ones_like(tail))[..., None, :]

    cdtype = torch.complex128 if c.dtype == torch.float64 else torch.complex64
    radius = 1.0 + torch.abs(cb[..., 1:, :]).amax(-2) ** (1.0 / deg)
    u = radius[..., None, :].to(cdtype) * _start_ring(deg, cdtype, dev)          # (..., 10, n)
    cc = cb.to(cdtype)
    dcc = cc[..., :-1, :] * torch.arange(deg, 0, -1, device=dev)[:, None].to(cdtype)
    eye = torch.eye(deg, dtype=cdtype, device=dev)[:, :, None]
    off = 1.0 - eye

    def horner(coef, x):
        acc = coef[..., 0, None, :].expand(x.shape)
        for k in range(1, coef.shape[-2]):
            acc = acc * x + coef[..., k, None, :]
        return acc

    for _ in range(iters):
        diff = (u[..., :, None, :] - u[..., None, :, :]) * off + eye
        if method == "dk":
            step = horner(cc, u) / _floor_abs(torch.prod(diff, dim=-2), 1e-30)
        else:
            newton = horner(cc, u) / _floor_abs(horner(dcc, u), 1e-30)
            inv = torch.where(torch.abs(diff) > 1e-30, 1.0 / diff, torch.zeros_like(diff)) * off
            step = newton / _floor_abs(1.0 - newton * inv.sum(-2), 1e-30)
        mag = torch.abs(step)
        step = torch.where(mag > 10.0, step * (10.0 / mag), step)
        u = u - step
    return u * s[..., None, :].to(cdtype), lead_ok


def _soa_polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner over axis -2 of coeffs (..., d+1, n) at x (..., k, n)."""
    acc = coeffs[..., 0, None, :].expand(x.shape).to(x.dtype)
    for k in range(1, coeffs.shape[-2]):
        acc = acc * x + coeffs[..., k, None, :]
    return acc


def _soa_newton_real(p: torch.Tensor, z: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Newton polish on the real axis of (..., k, n) roots of (..., 11, n)
    coefficients."""
    dcoeffs = p[..., :-1, :] * torch.arange(10, 0, -1, dtype=p.dtype, device=p.device)[:, None]
    for _ in range(iters):
        z = z - _soa_polyval(p, z) / _floor_abs(_soa_polyval(dcoeffs, z), 1e-30)
    return z


def five_point_candidates_batched(x1: torch.Tensor, x2: torch.Tensor,
                                  dk_iters: int = 24, root_method: str = "aberth"):
    """Batched essential-matrix candidates.

    x1, x2: (..., n, 5, 2) normalized camera coordinates, n samples.
    dk_iters: the root iteration's budget; roots that have not converged
    fail the backward-error filter and come out invalid (use >= 100 with
    root_method="dk"). root_method: "aberth" or "dk" (_soa_poly_roots).
    Returns Es (..., n, 10, 3, 3) Frobenius-normalized candidates and
    valid (..., n, 10): slots holding a genuine real-root solution.
    CUDA inputs replay the signature's CUDA graph, CPU inputs run
    eagerly; the results are the same bit for bit.
    """
    return _solve_graphs(x1, x2, dk_iters, root_method)


def _solve(x1: torch.Tensor, x2: torch.Tensor, dk_iters: int = 24,
           root_method: str = "aberth"):
    """five_point_candidates_batched, eagerly: some 2,800 kernel launches
    whatever the batch."""
    dtype = x1.dtype
    basis = _soa_nullspace(x1, x2)             # (..., 4, 9, n)
    A = _soa_constraint_matrix(basis)          # (..., 10, 20, n)
    A = A / torch.clamp(torch.abs(A).amax(-2, keepdim=True), min=1e-30)
    Ared = _soa_gauss_jordan(A)
    Bx, By, B1, p = _soa_action_det(Ared[..., :, 10:, :])

    roots_c, lead_ok = _soa_poly_roots(p, iters=dk_iters, method=root_method)
    z_real = roots_c.real.to(dtype)

    z = _soa_newton_real(p, z_real)

    bscale = _soa_polyval(torch.abs(p), torch.abs(z))
    resid = torch.abs(_soa_polyval(p, z)) / torch.clamp(bscale, min=1e-30)
    near_real = torch.abs(roots_c.imag) < 0.1 * (1.0 + torch.abs(z_real))
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    valid = lead_ok[..., None, :] & near_real & (resid < tol) & torch.isfinite(z)

    zb = z[..., None, :, :].expand(*z.shape[:-2], 3, *z.shape[-2:])
    rows = torch.stack([_soa_polyval(Bx, zb), _soa_polyval(By, zb),
                        _soa_polyval(B1, zb)], dim=-4)   # (..., 3comp, 3row, 10, n)

    def cross(a, b):
        return torch.stack([
            a[..., 1, :, :] * b[..., 2, :, :] - a[..., 2, :, :] * b[..., 1, :, :],
            a[..., 2, :, :] * b[..., 0, :, :] - a[..., 0, :, :] * b[..., 2, :, :],
            a[..., 0, :, :] * b[..., 1, :, :] - a[..., 1, :, :] * b[..., 0, :, :],
        ], dim=-3)

    r0, r1, r2 = rows[..., :, 0, :, :], rows[..., :, 1, :, :], rows[..., :, 2, :, :]
    cands = torch.stack([cross(r0, r1), cross(r0, r2), cross(r1, r2)], dim=-4)
    norms = torch.sqrt((cands * cands).sum(-3))          # (..., 3cand, 10, n)
    pick = torch.argmax(norms, dim=-3)                   # (..., 10, n)
    idx = pick[..., None, None, :, :].expand(*pick.shape[:-2], 1, 3, *pick.shape[-2:])
    v = torch.gather(cands, -4, idx)[..., 0, :, :, :]     # (..., 3comp, 10, n)

    w = v[..., 2, :, :]
    vnorm = torch.sqrt((v * v).sum(-3))
    w_ok = torch.abs(w) > 1e-12 * (vnorm + 1e-30)
    w_safe = _floor_abs(w, 1e-30)
    xs = v[..., 0, :, :] / w_safe
    ys = v[..., 1, :, :] / w_safe

    b9 = basis[..., :, :, None, :]              # (..., 4, 9, 1, n)
    Es = (xs[..., None, :, :] * b9[..., 0, :, :, :]
          + ys[..., None, :, :] * b9[..., 1, :, :, :]
          + z[..., None, :, :] * b9[..., 2, :, :, :]
          + b9[..., 3, :, :, :])                # (..., 9, 10, n)
    fro = torch.sqrt((Es * Es).sum(-3, keepdim=True))
    Es = Es / torch.clamp(fro, min=1e-30)
    finite = torch.isfinite(Es).all(-3)
    valid = valid & w_ok & finite
    Es = torch.where(torch.isfinite(Es), Es, torch.zeros_like(Es))

    Es = Es.movedim(-1, -3).movedim(-1, -2)     # (..., n, 10, 9)
    return Es.reshape(*Es.shape[:-1], 3, 3), valid.movedim(-1, -2)


def five_point_candidates(x1: torch.Tensor, x2: torch.Tensor):
    """Essential-matrix candidates of one sample of 5 normalized
    correspondences x1, x2 (5, 2): Es (10, 3, 3) Frobenius-normalized and
    valid (10,), the slots holding a genuine real-root solution."""
    Es, valid = _solve(x1[None], x2[None])
    return Es[0], valid[0]


_solve_graphs = GraphCache("five_point", _solve)
