"""Host time inside the program's orb.rank spans (the per-level stage-1
cut and Harris ranking after kernel B1, features/orb.select_keypoints),
ms per call; None where the program records no such span."""

from vobench.metrics import _spans


def read(ctx):
    v = _spans.view(ctx)
    if v is None:
        return None
    iv = v.host(v.named("orb.rank"))
    if not iv:
        return None
    return sum(e - s for s, e in iv) / 1e6 / len(ctx.calls)
