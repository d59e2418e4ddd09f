"""Host time inside the program's vo.refine spans (runner.refine_pairs),
ms per call; None where the program records no such span."""

from vobench.metrics import _spans


def read(ctx):
    v = _spans.view(ctx)
    if v is None:
        return None
    iv = v.host(v.named("vo.refine"))
    if not iv:
        return None
    return sum(e - s for s, e in iv) / 1e6 / len(ctx.calls)
