"""One reader per per-layer metric, named as in BENCHMARK.json:
`read(ctx)` returns the metric's value from the traced window (ctx.trace,
a vobench.trace.Summary), or None where the trace holds nothing for it.
A roofline share is never made up: without the kernel it is None."""
