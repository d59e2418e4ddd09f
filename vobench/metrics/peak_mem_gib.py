"""torch.cuda.max_memory_allocated() over the traced window, after a
reset at its start, in GiB."""


def read(ctx):
    if not ctx.window_peak_bytes:
        return None
    return ctx.window_peak_bytes / 2 ** 30
