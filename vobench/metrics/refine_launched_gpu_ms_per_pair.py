"""Device time of the operations launched while the host was inside the
program's vo.refine spans (runner.refine_pairs: the LM refinement of
every pair between stages 2 and 3), ms per pair of the window's calls
(vobench/metrics/_spans.py); None where the program records no such span."""

from vobench.metrics import _spans


def read(ctx):
    ms = _spans.launched_ms_per_call(ctx, "vo.refine")
    return None if ms is None else ms / ctx.pairs_per_call
