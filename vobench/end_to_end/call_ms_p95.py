"""The 95th percentile of every call's time in the window, from its
submission to its trajectory on the host (host clock), in ms."""

from vobench.stats import percentile


def read(ctx):
    if not ctx.calls:
        return None
    return percentile([(b - a) * 1e3 for a, b in ctx.calls], 95)
