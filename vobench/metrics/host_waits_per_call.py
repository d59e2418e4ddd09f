"""CUDA runtime calls that make the host wait for the card
(vobench.trace.SYNC_CALLS), per call."""

from vobench.trace import SYNC_CALLS


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    return sum(ctx.trace.host_counts.get(c, 0) for c in SYNC_CALLS) / len(ctx.calls)
