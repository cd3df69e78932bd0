"""Attention in the ViT (F.scaled_dot_product_attention, one launch a
layer a batch): the launches' least time over their kernels' device time
in the traced slice, in %. A launch's least time is the larger of its
bytes (q, k and v in, the heads' outputs out, in the compute dtype) over
the memory rate and its FLOPs (q k^T and the softmax times v) over the
precision's peak (work_vit.attn_stage), at the engine's rows a launch."""

from benchmark import work, work_vit

# parts of the names of the kernels torch's attention runs on the card:
# torch 2.11 picks cuDNN's fused kernel there
# (cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_...,
# its tile in the name), another torch may pick its flash or
# memory-efficient kernel
PARTS = ("_sdpa_", "flash_fwd", "fmha_")


def kernel_time(trace, parts=PARTS):
    """(launches, device seconds) of the kernels whose names hold one of
    `parts`, over every card."""
    n, t = 0, 0.0
    for ops in trace.ops.values():
        for name, a, b in ops:
            if any(p in name for p in parts):
                n += 1
                t += b - a
    return n, t


def read(ctx):
    if ctx.trace is None:
        return None
    n, t = kernel_time(ctx.trace)
    if not n:
        return None
    dtype = ctx.config["precision"]
    stage = work_vit.attn_stage(ctx.config["model"],
                                ctx.driver.rows_per_launch, dtype)
    return 100.0 * n * work.least_s(*stage, ctx.device_name, dtype) / t
