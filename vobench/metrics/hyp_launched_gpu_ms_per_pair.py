"""Device time of the operations launched while the host was inside the
program's ransac.hypotheses spans (the 5-point or 8-point solver on
every sample; the replayed CUDA graph's kernels where its launch was
made), ms per pair of the window's calls (vobench/metrics/_spans.py)."""

from vobench.metrics import _spans


def read(ctx):
    ms = _spans.launched_ms_per_call(ctx, "ransac.hypotheses")
    return None if ms is None else ms / ctx.pairs_per_call
