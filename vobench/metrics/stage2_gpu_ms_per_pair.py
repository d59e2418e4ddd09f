"""Device time of the operations launched from stage 2 (the entry's
estimate_pairs), ms per pair."""

from vobench.metrics._stage import ops


def read(ctx):
    got = ops(ctx, "stage2")
    if not got:
        return None
    return sum(o.end - o.start for o in got) / 1e6 / (len(ctx.calls) * ctx.pairs_per_call)
