"""Frames of every call of the window over the time from the window's
start to the end of its last call (host clock)."""


def read(ctx):
    if not ctx.calls:
        return None
    return len(ctx.calls) * ctx.frames_per_call / ctx.calls[-1][1]
