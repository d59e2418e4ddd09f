"""Device busy time inside the device intervals of the program's
ransac.hypotheses spans (the 5-point or 8-point solver on every sample),
ms per pair of the calls whose spans fit the trace (vobench/metrics/_spans.py)."""

from vobench.metrics import _spans


def read(ctx):
    ms = _spans.device_ms_per_call(ctx, "ransac.hypotheses")
    return None if ms is None else ms / ctx.pairs_per_call
