"""Device idle time (the window less the union of its device operations)
while the host was inside the program's vo.stage2 spans (stage 2,
runner.estimate_pairs), ms per call."""

from vobench.metrics import _spans


def read(ctx):
    v = _spans.view(ctx)
    if v is None or not ctx.trace.ops:
        return None
    iv = v.host(v.named("vo.stage2"))
    if not iv:
        return None
    return v.idle_in(iv) / 1e6 / len(ctx.calls)
