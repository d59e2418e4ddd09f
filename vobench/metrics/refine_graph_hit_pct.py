"""The share of the traced calls' vo.refine spans that replayed the LM
refinement's CUDA graph (that hold a refine.replay span, which opens
inside refine.lm), in %; None where the program records no refine.capture
or refine.replay span at all (a program without the graphs) or no
vo.refine span in the window."""

from vobench.metrics import _spans

GRAPH_SPANS = ("refine.capture", "refine.replay")


def read(ctx):
    v = _spans.view(ctx)
    if v is None or not any(r.name in GRAPH_SPANS for r in v.every):
        return None
    refine = v.named("vo.refine")
    if not refine:
        return None
    parent = {r.id: r.parent for r in v.every}
    replayed = set()
    for r in v.named("refine.replay"):
        a = r.parent
        while a is not None:
            replayed.add(a)
            a = parent.get(a)
    return 100.0 * sum(r.id in replayed for r in refine) / len(refine)
