"""Kernels launched from stage 2 (the entry's estimate_pairs) per pair;
copies and fills are not counted."""

from vobench.metrics._stage import is_kernel, ops


def read(ctx):
    got = [o for o in ops(ctx, "stage2") if is_kernel(o.name)]
    if not got:
        return None
    return len(got) / (len(ctx.calls) * ctx.pairs_per_call)
