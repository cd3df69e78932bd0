"""The ViT's inference step's share of the card's published peak for the
configuration's precision: the model FLOPs of the window's useful images
(work_vit.py: 35,126,128,128 an image at ViT-B/16's widths) over the
window's time, in %: the share of the whole step, K1, the matmuls,
attention, the memory-bound launches and the engine's dispatch alike."""

from benchmark import work, work_vit


def read(ctx):
    w = ctx.window
    if not w.get("images") or w.get("steps"):
        return None
    flops = w["images"] * work_vit.inference_flops(ctx.config["model"])
    peak = work.peak_flops(ctx.device_name, ctx.config["precision"])
    return 100.0 * flops / w["seconds"] / (peak * ctx.chips)
