"""The engine's host rate of endpoints, in rows/s (the program's own spans,
benchmark/spans.py): the rows of the engine.host_rows spans (a dispatch's
specs to endpoints, laid out a card each and pinned) over their summed
time."""

from benchmark import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.host_rows_per_s(rec)
