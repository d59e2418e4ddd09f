"""Device time of the operations launched from stage 1 (the entry's
detect_frames), ms per frame."""

from vobench.metrics._stage import ops


def read(ctx):
    got = ops(ctx, "stage1")
    if not got:
        return None
    return sum(o.end - o.start for o in got) / 1e6 / (len(ctx.calls) * ctx.frames_per_call)
