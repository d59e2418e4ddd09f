"""Device time of the operations launched while the host was inside the
program's orb.rank spans (each pyramid level's stage-1 cut of the FAST
keys and its Harris ranking, features/orb.select_keypoints), ms per frame
of the window's calls (vobench/metrics/_spans.py); None where the program
records no such span."""

from vobench.metrics import _spans


def read(ctx):
    ms = _spans.launched_ms_per_call(ctx, "orb.rank")
    return None if ms is None else ms / ctx.frames_per_call
