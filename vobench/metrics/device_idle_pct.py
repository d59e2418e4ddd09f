"""One minus the union of the device's operations over the traced
window (first call's start to last call's end), in %."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
