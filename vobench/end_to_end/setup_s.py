"""From the process's start to the first timed call: imports, the
kernels (built on a checkout's first run, loaded after), the frames
drawn on the card and one warm-up call of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
