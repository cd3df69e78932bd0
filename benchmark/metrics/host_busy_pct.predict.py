"""The engine's host thread's busy share of the span slice, in % (the
program's own spans, benchmark/spans.py): the time of its engine.call
spans less their engine.sync children, the waits for the cards, over the
slice's window."""

from benchmark import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.host_busy_pct(rec)
