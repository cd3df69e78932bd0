"""The engine's host rate of rows, in rows/s (the program's own spans,
benchmark/spans.py): the rows of the engine.host_rows spans (a dispatch's
raw specs laid out a card each and pinned; the cards make the endpoints)
over their summed time."""

from benchmark import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.host_rows_per_s(rec)
