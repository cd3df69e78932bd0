"""The inference step's share of the cards' published peak for the
configuration's precision: the model's FLOPs of the window's useful
images (benchmark/work.py) over the window's time, in %."""

from benchmark import work


def read(ctx):
    w = ctx.window
    if not w.get("images") or w.get("steps"):
        return None
    flops = w["images"] * work.inference_flops(ctx.config["model"])
    peak = work.peak_flops(ctx.device_name, ctx.config["precision"])
    return 100.0 * flops / w["seconds"] / (peak * ctx.chips)
