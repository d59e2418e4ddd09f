"""Device time of the operations launched while the host was inside the
program's orb.describe spans (angles, the 7x7 window blur and steered
BRIEF over every keypoint's window), ms per frame of the window's calls
(vobench/metrics/_spans.py)."""

from vobench.metrics import _spans


def read(ctx):
    ms = _spans.launched_ms_per_call(ctx, "orb.describe")
    return None if ms is None else ms / ctx.frames_per_call
