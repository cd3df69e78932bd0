"""K2 forward (ops/fused_pool_lrn.py, csrc/pool_lrn.cu) after conv1 and
conv2 in the engine: the two stages' least time over their kernels'
device time in the traced slice, in %. A batch launches both tails; each
stage's least time is the larger of its bytes (x and the bias in, the
pooled and normalized output out) over the memory rate and its
elementwise FLOPs over the f32 peak."""

from benchmark import work

KERNELS = ("pool_lrn_ring",)
TAILS = ("conv1", "conv2")


def read(ctx):
    if ctx.trace is None:
        return None
    n, t = ctx.trace.kernel_time(KERNELS)
    if not n:
        return None
    model, rows = ctx.config["model"], ctx.driver.rows_per_launch
    pair = sum(work.least_s(*work.k2_stage(model, rows, layer,
                                           ctx.config["precision"]),
                            ctx.device_name, "float32") for layer in TAILS)
    return 100.0 * (n / len(TAILS)) * pair / t
