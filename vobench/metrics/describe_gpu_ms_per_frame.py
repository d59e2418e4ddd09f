"""Device busy time inside the device intervals of the program's
orb.describe spans (angles, the 7x7 window blur and steered BRIEF over
every keypoint's window), ms per frame of the calls whose spans fit the
trace (vobench/metrics/_spans.py)."""

from vobench.metrics import _spans


def read(ctx):
    ms = _spans.device_ms_per_call(ctx, "orb.describe")
    return None if ms is None else ms / ctx.frames_per_call
