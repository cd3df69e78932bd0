"""K1 (ops/raster_kernel.py, csrc/raster.cu), the {0,1} raster the ViT
reads, in the configuration's precision at the engine's rows a launch:
the stage's least time, its bytes (the endpoints in, the raster out,
work.k1_stage) over the memory rate, over its kernels' device time in the
traced slice, in %. The candidates' geometry is assumed (random_specs:
see k3_roofline.py); the least time does not depend on it, the kernel's
time may."""

from benchmark import work

KERNELS = ("raster_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    n, t = ctx.trace.kernel_time(KERNELS)
    if not n:
        return None
    nbytes, flops = work.k1_stage(ctx.config["model"],
                                  ctx.driver.rows_per_launch,
                                  ctx.config["precision"])
    least = n * work.least_s(nbytes, flops, ctx.device_name, "float32")
    return 100.0 * least / t
