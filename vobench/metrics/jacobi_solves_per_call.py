"""The program's solve.jacobi spans in the traced window, per call: each
is one SVD or eigendecomposition of stage 2 that called cuSOLVER's batched
Jacobi routine itself, with no wait for the card
(tpu_vo_torch/estimation/solve.py); None where the program records no
such span."""

from vobench.metrics import _spans


def read(ctx):
    v = _spans.view(ctx)
    if v is None:
        return None
    n = len(v.named("solve.jacobi"))
    return n / len(ctx.calls) if n else None
