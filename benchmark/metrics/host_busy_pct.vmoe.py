"""host_busy_pct.predict in the V-MoE's cell, by its own reader, under a
name of the V-MoE's own; None unless the span slice's engine.call spans
say that the engine ran the V-MoE (network 'vmoe_b16'): a program whose
engine cannot read V-MoE weights, or says nothing of its network, gives
nothing here."""

from benchmark import spans, spec


def read(ctx):
    rec = spans.record(ctx)
    if rec is None or not any(s.attrs.get("network") == "vmoe_b16"
                              for s in rec.find("engine.call", device=False)):
        return None
    return spec.metric("host_busy_pct.predict").read(ctx)
