"""norm_act_roofline.vit in the V-MoE's cell, by its own reader, under a
name of the V-MoE's own: the memory-bound launches between the matmuls
(torch's LayerNorms, the dense layers' exact GELUs and the residual
adds; the sparse layers' bias-GELU and second add run in ops/moe.py's
kernels, which moe_route_roofline.vmoe reads): their least time over
their kernels' device time in the traced slice, in %. None unless the
span slice's engine.call spans say that the engine ran the V-MoE
(network 'vmoe_b16')."""

from benchmark import spans, spec


def read(ctx):
    rec = spans.record(ctx)
    if rec is None or not any(s.attrs.get("network") == "vmoe_b16"
                              for s in rec.find("engine.call", device=False)):
        return None
    return spec.metric("norm_act_roofline.vit").read(ctx)
