"""five_point_graph_hit_pct on hand-built spans (those of
test_vobench_spans.py): the share of ransac.hypotheses spans that hold a
five_point.replay span, and None for a program without the graphs."""

from tpu_vo_torch.utils.profiling import Span
from vobench import harness
from vobench.tests.test_vobench_spans import W0, WARMUP, _ctx, _records

read = harness._reader("metrics", "five_point_graph_hit_pct")


def _use(monkeypatch, records):
    from vobench.metrics import _spans
    monkeypatch.setattr(_spans, "_program_spans", lambda: records)


def _second_call(replay: bool):
    """A second call with its own ransac.hypotheses span (id 306) and,
    if `replay`, a five_point.replay span inside it."""
    out = [Span("vo.call", 301, None, 8, W0 + 9100, W0 + 9900, 0, 0.0, 800.0),
           Span("ransac.hypotheses", 306, 301, 8, W0 + 9200, W0 + 9500, 0, 100.0, 400.0)]
    if replay:
        out.append(Span("five_point.replay", 307, 306, 8, W0 + 9210, W0 + 9490, 0, 110.0,
                        390.0))
    return out


def test_the_share_of_hypotheses_spans_that_replayed(monkeypatch):
    replay = Span("five_point.replay", 120, 106, 7, W0 + 3950, W0 + 5000, 0, 3900.0, 4900.0)
    capture = Span("five_point.capture", 1, None, 0, W0 - 2_000_000_000,
                   W0 - 1_900_000_000, None, None, None)
    _use(monkeypatch, [capture] + _records() + [replay] + _second_call(True))
    assert read(_ctx()) == 100.0
    _use(monkeypatch, [capture] + _records() + [replay] + _second_call(False))
    assert read(_ctx()) == 50.0
    # every signature fell back to the eager solver: captured in the warm-up, never replayed
    _use(monkeypatch, [capture] + _records() + _second_call(False))
    assert read(_ctx()) == 0.0


def test_none_without_graph_spans_or_hypotheses_spans(monkeypatch):
    _use(monkeypatch, _records() + _second_call(False))     # a program without the graphs
    assert read(_ctx()) is None
    _use(monkeypatch, [WARMUP])                              # nothing in the window
    assert read(_ctx()) is None
    replay_only = [r for r in _records() if r.name != "ransac.hypotheses"]
    replay_only.append(Span("five_point.replay", 120, 101, 7, W0 + 3950, W0 + 5000, 0,
                            3900.0, 4900.0))
    _use(monkeypatch, replay_only)
    assert read(_ctx()) is None
