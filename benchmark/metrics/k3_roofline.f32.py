"""K3 in f32 (ops/fused_conv1.py, csrc/conv1_raster.cu, namespace simt),
the raster fused into conv1 on CUDA cores, as the exact engine runs it on
the card: the stage's least time over its kernels' device time in the
traced slice, in %. Per launch the least time is the larger of its bytes
(the endpoints and folded f32 weights in, conv1's f32 pre-activation out)
over the memory rate and its FLOPs (the lit pixels' multiply-accumulates
of the slice's images) over the f32 peak; k3_roofline.py counts them. The
candidates' geometry is assumed, as there."""

from benchmark import spec

KERNELS = ("conv1_raster_f32",)


def read(ctx):
    return spec.metric("k3_roofline").share(ctx, KERNELS, "float32")
