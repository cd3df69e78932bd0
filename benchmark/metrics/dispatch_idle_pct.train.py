"""The card's share of the span slice in which no train.step device span
runs, in % (the program's own spans, benchmark/spans.py): a step's span
brackets the copies of its rows and flip, its run and the loss's clone."""

from benchmark import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.idle_pct(rec, "train.step")
