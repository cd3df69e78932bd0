"""K1: the similarity-image raster as a hand-written CUDA kernel.

Counterpart of the JAX package's ops/pallas_raster.py
(render_raster_pallas, render_images_pallas). The kernel is
csrc/raster.cu; its plain version is ops/rasterize.py:render_raster, which
a CPU tensor goes to. A CUDA tensor launches the kernel or raises.

Bound on an H100 at B=128: the output write, 79.1 MB in f32 (23.6 us at
3.35 TB/s) and 39.6 MB in bf16 (11.8 us). The kernel builds, per block of
image rows, each segment's column run in every row and each column's
channel-1 flag in shared memory once (their plain twin is
rasterize.raster_tables), turns the runs into bit masks a row, and writes
the output as 16-byte vectors, two shared loads and a compare for a dark
one. Its design note is in csrc/raster.cu.
"""

from __future__ import annotations

import torch

from svision_tpu_torch.ops import _kernels, rasterize
from svision_tpu_torch.ops.rasterize import CANVAS

SEG_COUNTS = (1, 2, 3, 4)   # segment counts the kernel is instantiated for


def render_raster(endpoints: torch.Tensor, visible: torch.Tensor,
                  reverse: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """[N,S,4] int32 clipped endpoints + bool [N,S] flags -> {0,1} raster
    [N,227,227,3] (NHWC) in dtype (float32, the exact path's, or
    bfloat16). S is 1 to 4 on the card: candidates carry two segments,
    fit_device's fragmentation four. Not differentiable
    (_kernels.check_no_grad)."""
    _kernels.check_no_grad("render_raster", endpoints, visible, reverse)
    if endpoints.device.type == "cpu":
        return rasterize.render_raster(endpoints, visible, reverse,
                                       dtype=dtype)
    n = _kernels.check_segments(endpoints, visible, reverse, segs=SEG_COUNTS)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"render_raster: unsupported dtype {dtype}")
    out = torch.empty((n, CANVAS, CANVAS, 3), dtype=dtype,
                      device=endpoints.device)
    if n:
        with torch.cuda.device(endpoints.device):
            _kernels.launch("svt_render_raster", endpoints.data_ptr(),
                            visible.data_ptr(), reverse.data_ptr(),
                            out.data_ptr(), n, endpoints.shape[1],
                            int(dtype == torch.bfloat16),
                            _kernels.stream_of(endpoints))
        render_raster.launches += 1
    return out


render_raster.launches = 0


def render_images(endpoints: torch.Tensor, visible: torch.Tensor,
                  reverse: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """Mean-subtracted [N,227,227,3] images through the kernel (the
    reference-normalized tensor, create_batch.py:146-150)."""
    return rasterize.normalize_raster(
        render_raster(endpoints, visible, reverse, dtype=dtype))

