"""K3 (ops/fused_conv1.py, csrc/conv1_raster.cu), the raster fused into
conv1: the stage's least time over its kernels' device time in the traced
slice, in %. Per launch the least time is the larger of its bytes (the
endpoints and folded weights in, conv1's pre-activation out) over the
memory rate and its FLOPs (the lit pixels' multiply-accumulates of the
slice's images) over the bf16 peak.

The candidates' geometry is assumed: the genome mix draws its specs with
random_specs, whose images light about 300 pixels each, against about
186 for the candidates the port's CLI collects from the repository's
simulated fixture. The FLOP term lies two orders under the bytes, so the
least time does not move with it; the kernel's own time may."""

from benchmark import work

KERNELS = ("conv1_raster_wgmma",)


def share(ctx, kernels, dtype: str):
    """The roofline share of K3's launches named by `kernels`, whose
    tensors are of `dtype` and whose FLOPs run against its peak."""
    if ctx.trace is None:
        return None
    n, t = ctx.trace.kernel_time(kernels)
    if not n:
        return None
    model = ctx.config["model"]
    nbytes, _ = work.k3_stage(model, ctx.driver.rows_per_launch, dtype, 0)
    flops = 2 * ctx.driver.slice_lit_macs() / n
    least = n * work.least_s(nbytes, flops, ctx.device_name, dtype)
    return 100.0 * least / t


def read(ctx):
    return share(ctx, KERNELS, "bfloat16")
