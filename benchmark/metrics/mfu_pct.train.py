"""The training step's share of the cards' published peak for its
precision: the model's training FLOPs of the window's images
(benchmark/work.py) over the window's time, in %."""

from benchmark import work


def read(ctx):
    w = ctx.window
    if not w.get("steps"):
        return None
    flops = w["images"] * work.training_flops(ctx.config["model"])
    peak = work.peak_flops(ctx.device_name, ctx.config["train"]["precision"])
    return 100.0 * flops / w["seconds"] / (peak * ctx.chips)
