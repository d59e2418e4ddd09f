"""Host time inside the program's vo.stage3 spans (the pose chain), ms
per call."""

from vobench.metrics import _spans


def read(ctx):
    v = _spans.view(ctx)
    if v is None:
        return None
    iv = v.host(v.named("vo.stage3"))
    if not iv:
        return None
    return sum(e - s for s, e in iv) / 1e6 / len(ctx.calls)
