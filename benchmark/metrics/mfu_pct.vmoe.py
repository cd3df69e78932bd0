"""The V-MoE's inference step's share of the card's published peak for
the configuration's precision: the model FLOPs of the window's useful
images (work_vmoe.py: 46,338,977,280 an image at V-MoE-B/16's widths, each
token's two experts counted) over the window's time, in %: the share of
the whole step, K1, the dense and the sparse layers and the engine's
dispatch alike. None unless the span slice's engine.call spans say that
the engine ran the V-MoE (network 'vmoe_b16')."""

from benchmark import spans, work, work_vmoe


def read(ctx):
    rec = spans.record(ctx)
    w = ctx.window
    if rec is None or not w.get("images") or not any(
            s.attrs.get("network") == "vmoe_b16"
            for s in rec.find("engine.call", device=False)):
        return None
    flops = w["images"] * work_vmoe.inference_flops(ctx.config["model"])
    peak = work.peak_flops(ctx.device_name, ctx.config["precision"])
    return 100.0 * flops / w["seconds"] / (peak * ctx.chips)
