"""Device operations of one stage of the traced calls."""


def ops(ctx, role):
    spans = {s for s, r in ctx.span_role.items() if r == role}
    return [o for o in ctx.trace.ops if o.span in spans]


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def kernel_seconds(ctx, needle: str):
    """(seconds, launches) of the device kernels whose name holds `needle`."""
    hits = [o for o in ctx.trace.ops if needle in o.name]
    return sum(o.end - o.start for o in hits) / 1e9, len(hits)
