"""The ViT's memory-bound launches between its matmuls: the LayerNorms,
the exact GELUs and the residual adds (the positions' add among them).
Their least time over their kernels' device time in the traced slice, in
%. A launch's least time is the larger of its bytes (inputs read once,
outputs written once, in the compute dtype) over the memory rate and its
elementwise FLOPs over the f32 peak (work_vit.norm_act_stages); each
kind's launches are counted in the trace and given the mean least time of
that kind's launches in a batch."""

from benchmark import work, work_vit

# the kernels of each kind, as the trace names them
KINDS = {"ln": ("vectorized_layer_norm_kernel",),
         "gelu": ("GeluCUDAKernelImpl",),
         "add": ("CUDAFunctor_add",)}


def read(ctx):
    if ctx.trace is None:
        return None
    stages = work_vit.norm_act_stages(ctx.config["model"],
                                      ctx.driver.rows_per_launch,
                                      ctx.config["precision"])
    least = total = 0.0
    for kind, names in KINDS.items():
        n, t = ctx.trace.kernel_time(names)
        if not n:
            return None
        mean = sum(work.least_s(b, f, ctx.device_name, "float32")
                   for b, f in stages[kind]) / len(stages[kind])
        least += n * mean
        total += t
    return 100.0 * least / total
