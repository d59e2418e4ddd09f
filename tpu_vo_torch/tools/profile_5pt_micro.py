"""The 5-point solver's polynomial pipeline split by step (port of
tools/profile_5pt_micro.py).

At the production batch, pc pairs x `samples` samples (the JAX tool's PC
and ITERS; 9 x 256 = 2304), float32 samples drawn as the JAX tool draws
them (s1 = 0.3 N(0, 1), s2 = s1 + 0.02 N(0, 1), here from torch.Generators
seeded 0 and 1 on the host, so no kernel runs), it times in the JAX
tool's order the AoS helpers of estimation/five_point:

  nullspace     _nullspace_basis
  constraint    _constraint_matrix
  gauss-jordan  the row scaling and _gauss_jordan
  det-poly      _action_polynomials and _det_poly
  dk+newton     _poly_roots (Durand-Kerner, `dk` iterations) and _newton_real

and beside them the same five steps in the SoA form the main path runs
(`soa nullspace` ... `soa roots+newton`: _soa_nullspace,
_soa_constraint_matrix, _soa_gauss_jordan, _soa_action_det, and
_soa_poly_roots at five_point_candidates_batched's defaults, Aberth-Ehrlich
24 iterations, with its 8 Newton steps). Rows as tools/profile_rows says,
with ms_per_pair: a row's ms over pc.

    python -m tpu_vo_torch.tools.profile_5pt_micro [--pc 9 --samples 256 --reps 16]
"""

from __future__ import annotations

import sys

import torch

from tpu_vo_torch.estimation import five_point as F5
from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(pc=9, samples=256, dk=100, reps=16, iters=5)


def draw(B: int, device):
    """(s1, s2) (B, 5, 2) float32 on `device`."""
    s1 = torch.randn((B, 5, 2), generator=torch.Generator().manual_seed(0)) * 0.3
    s2 = s1 + torch.randn((B, 5, 2), generator=torch.Generator().manual_seed(1)) * 0.02
    return s1.to(device), s2.to(device)


def _scaled(A: torch.Tensor, axis: int) -> torch.Tensor:
    return A / torch.clamp(torch.abs(A).amax(axis, keepdim=True), min=1e-30)


def soa_roots_newton(p: torch.Tensor):
    """The main path's roots of (..., 11, n) polynomials: Aberth-Ehrlich
    at five_point_candidates_batched's budget, then 8 Newton steps."""
    roots, ok = F5._soa_poly_roots(p, iters=24)
    return F5._soa_newton_real(p, roots.real.to(p.dtype)), ok


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("profile_5pt_micro", o)
    B = o.pc * o.samples
    s1, s2 = draw(B, o.device)
    t = dict(reps=o.reps, iters=o.iters, per=("pair", o.pc))
    rows.add("batch", {"samples": B, "pc": o.pc, "per_pair": o.samples, "dk_iters": o.dk})

    basis = F5._nullspace_basis(s1, s2)
    A = F5._constraint_matrix(basis)
    Ared = F5._gauss_jordan(_scaled(A, -1))
    polys = F5._det_poly(F5._action_polynomials(Ared[..., 10:]))
    rows.time("nullspace", lambda: F5._nullspace_basis(s1, s2), **t)
    rows.time("constraint", lambda: F5._constraint_matrix(basis), **t)
    rows.time("gauss-jordan", lambda: F5._gauss_jordan(_scaled(A, -1)), **t)
    rows.time("det-poly", lambda: F5._det_poly(F5._action_polynomials(Ared[..., 10:])), **t)

    def dk():
        roots, ok = F5._poly_roots(polys, iters=o.dk)
        return F5._newton_real(polys, roots.real), ok

    rows.time("dk+newton", dk, **t)

    sb = F5._soa_nullspace(s1, s2)
    sA = F5._soa_constraint_matrix(sb)
    sAred = F5._soa_gauss_jordan(_scaled(sA, -2))
    sp = F5._soa_action_det(sAred[..., :, 10:, :])[3]
    rows.time("soa nullspace", lambda: F5._soa_nullspace(s1, s2), **t)
    rows.time("soa constraint", lambda: F5._soa_constraint_matrix(sb), **t)
    rows.time("soa gauss-jordan", lambda: F5._soa_gauss_jordan(_scaled(sA, -2)), **t)
    rows.time("soa action+det", lambda: F5._soa_action_det(sAred[..., :, 10:, :]), **t)
    rows.time("soa roots+newton", lambda: soa_roots_newton(sp), **t)
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
