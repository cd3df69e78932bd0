"""k1_roofline.vit in the V-MoE's cell, by its own reader, under a name of
the V-MoE's own: K1 (ops/raster_kernel.py), the {0,1} raster the V-MoE
reads, at the engine's rows a launch: its least time by bytes over its
kernels' device time in the traced slice, in %. None unless the span
slice's engine.call spans say that the engine ran the V-MoE (network
'vmoe_b16')."""

from benchmark import spans, spec


def read(ctx):
    rec = spans.record(ctx)
    if rec is None or not any(s.attrs.get("network") == "vmoe_b16"
                              for s in rec.find("engine.call", device=False)):
        return None
    return spec.metric("k1_roofline.vit").read(ctx)
