"""The cards' mean share of the span slice in which no engine.dispatch
device span runs, in % (the program's own spans, benchmark/spans.py): a
dispatch's span brackets its copies in, its graph replay and its copies
out on the card's stream, so this is the time the engine leaves a card
without work, measured without the profiler."""

from benchmark import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.idle_pct(rec, "engine.dispatch")
