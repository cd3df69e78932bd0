"""K2's backward (ops/fused_pool_lrn.py, csrc/pool_lrn_backward.cu) after
conv1 and conv2 in the training step: the two stages' least time over
their kernels' device time in the traced slice, in %. A step launches
both tails; each stage's least time is the larger of its bytes (x, the
bias and dy in, dx and the bias gradient out) over the memory rate and
its elementwise FLOPs over the f32 peak."""

from benchmark import work

KERNELS = ("pool_lrn_backward_ring", "pool_lrn_backward_rows")
TAILS = ("conv1", "conv2")


def read(ctx):
    if ctx.trace is None:
        return None
    n, t = ctx.trace.kernel_time(KERNELS)
    if not n:
        return None
    model, rows = ctx.config["model"], ctx.driver.rows_per_launch
    dtype = ctx.config["train"]["precision"]
    pair = sum(work.least_s(*work.k2_backward_stage(model, rows, layer, dtype),
                            ctx.device_name, "float32") for layer in TAILS)
    return 100.0 * (n / len(TAILS)) * pair / t
