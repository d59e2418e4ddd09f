"""Device idle time (the window less the union of its device operations)
while the host was inside the program's vo.refine spans
(runner.refine_pairs), ms per call; None where the program records no
such span."""

from vobench.metrics import _spans


def read(ctx):
    v = _spans.view(ctx)
    if v is None or not ctx.trace.ops:
        return None
    iv = v.host(v.named("vo.refine"))
    if not iv:
        return None
    return v.idle_in(iv) / 1e6 / len(ctx.calls)
