"""One reader per end-to-end metric, named as in BENCHMARK.json:
`read(ctx)` returns the metric's value from the window's calls, or None."""
