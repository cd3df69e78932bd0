"""attn_roofline.vit in the V-MoE's cell, by its own reader, under a name
of the V-MoE's own: the ViT's attention (F.scaled_dot_product_attention,
cuDNN's fused kernel, one launch a layer a batch), the V-MoE's in all 12
layers: its launches' least time over their kernels' device time in the
traced slice, in %. None unless the span slice's engine.call spans say
that the engine ran the V-MoE (network 'vmoe_b16')."""

from benchmark import spans, spec


def read(ctx):
    rec = spans.record(ctx)
    if rec is None or not any(s.attrs.get("network") == "vmoe_b16"
                              for s in rec.find("engine.call", device=False)):
        return None
    return spec.metric("attn_roofline.vit").read(ctx)
