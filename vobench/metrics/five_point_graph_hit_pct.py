"""The share of the traced calls' ransac.hypotheses spans that replayed
the 5-point solver's CUDA graph (that hold a five_point.replay span), in
%; None where the program records no five_point.* span at all (a program
without the graphs) or no ransac.hypotheses span in the window."""

from vobench.metrics import _spans


def read(ctx):
    v = _spans.view(ctx)
    if v is None or not any(r.name.startswith("five_point.") for r in v.every):
        return None
    hyp = v.named("ransac.hypotheses")
    if not hyp:
        return None
    replayed = {r.parent for r in v.named("five_point.replay")}
    return 100.0 * sum(r.id in replayed for r in hyp) / len(hyp)
