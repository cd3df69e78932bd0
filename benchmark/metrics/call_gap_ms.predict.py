"""The cards' mean gap between calls, in ms (the program's own spans,
benchmark/spans.py): per card, from the end of a predict_specs call's last
engine.dispatch device span to the start of the next call's first, the
mean over the slice's calls and the cards. It holds the closing copy and
sync, the caller, and the next call's padding and first rows' layout."""

from benchmark import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.call_gap_ms(rec, "engine.dispatch")
