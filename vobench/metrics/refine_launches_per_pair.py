"""Kernels whose launch the host made inside the program's vo.refine
spans (runner.refine_pairs), per pair of the window's calls; copies and
fills are not counted. None where the program records no such span or
no kernel was launched inside one."""

import bisect

from vobench.metrics import _spans
from vobench.metrics._stage import is_kernel


def read(ctx):
    v = _spans.view(ctx)
    if v is None or not ctx.trace.ops:
        return None
    iv = v.host(v.named("vo.refine"))
    starts = [s for s, _ in iv]
    n = 0
    for o in ctx.trace.ops:
        if o.launch is not None and is_kernel(o.name):
            i = bisect.bisect_right(starts, o.launch - v.w0) - 1
            n += i >= 0 and o.launch - v.w0 < iv[i][1]
    return n / (len(ctx.calls) * ctx.pairs_per_call) if n else None
