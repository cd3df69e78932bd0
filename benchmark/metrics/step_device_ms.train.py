"""The median time of a replayed training step on the card, in ms (the
program's own spans, benchmark/spans.py): the train.step device spans
whose host span's phase is 'replay'."""

from benchmark import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.step_device_ms(rec)
