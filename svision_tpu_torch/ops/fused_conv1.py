"""K3: the space-to-depth raster fused into conv1, as a hand-written CUDA
kernel.

Counterpart of the JAX package's ops/fused_conv1.py (conv1_fused_raster).
The kernel is csrc/conv1_raster.cu; its plain version is
conv1_fused_raster_plain below (render_raster_s2d, then a 3x3 VALID conv
with the folded weights), which a CPU tensor goes to. A CUDA tensor
launches the kernel or raises. It is the first layer of the engine's bf16
path, and of its exact path on the card (infer/engine.py:fused_logits):
the predicate never reaches device memory.

bf16 runs as a wgmma (tensor-core) implicit GEMM. f32 adds, on CUDA cores,
the weights of the lit predicate terms only, each product of a {0,1} value
and a weight being that weight exactly. Bound on an H100 at B=128: bytes,
the output, 74.3 MB in bf16 (22 us at 3.35 TB/s) and 148.7 MB in f32
(44 us); the dense GEMM, 32.1 GFLOP, would take 32 us on bf16 tensor cores
and 479 us as f32 FMAs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from svision_tpu_torch.ops import _kernels, rasterize

OUT = 55                    # 57 - 3 + 1 (3x3 VALID, stride 1)
W_SHAPE = (3, 3, 48, 96)    # folded conv1 weights, HWIO


def conv1_fused_raster_plain(endpoints: torch.Tensor, visible: torch.Tensor,
                             reverse: torch.Tensor,
                             w_s2d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: render_raster_s2d in w_s2d's dtype, then the
    folded 3x3 conv. Returns NHWC [N,55,55,96] in w_s2d's dtype."""
    raster = rasterize.render_raster_s2d(endpoints, visible, reverse,
                                         dtype=w_s2d.dtype)
    out = F.conv2d(raster.permute(0, 3, 1, 2), w_s2d.permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1).contiguous()


def conv1_fused_raster(endpoints: torch.Tensor, visible: torch.Tensor,
                       reverse: torch.Tensor,
                       w_s2d: torch.Tensor) -> torch.Tensor:
    """[N,SEGS,4] int32 endpoints + bool [N,SEGS] flags + folded conv1
    weights w_s2d [3,3,48,96] (bf16 or f32) -> conv1 pre-activation
    [N,55,55,96] (NHWC) in w_s2d's dtype, accumulated in f32. Add the
    folded bias and apply ReLU outside (bias_relu_pool_lrn does). Not
    differentiable: weights that require grad are refused while grad
    mode is on (_kernels.check_no_grad)."""
    _kernels.check_no_grad("conv1_fused_raster", endpoints, visible, reverse,
                           w_s2d)
    if endpoints.device.type == "cpu":
        return conv1_fused_raster_plain(endpoints, visible, reverse, w_s2d)
    n = _kernels.check_segments(endpoints, visible, reverse)
    if (tuple(w_s2d.shape) != W_SHAPE
            or w_s2d.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"conv1_fused_raster: w_s2d must be {W_SHAPE} "
                         f"f32/bf16, got {tuple(w_s2d.shape)} {w_s2d.dtype}")
    _kernels.check_cuda(endpoints, w_s2d)
    w = w_s2d.contiguous()
    if w.data_ptr() % 16:
        raise ValueError("conv1_fused_raster: w_s2d must be 16-byte aligned")
    out = torch.empty((n, OUT, OUT, W_SHAPE[3]), dtype=w.dtype,
                      device=endpoints.device)
    if n:
        with torch.cuda.device(endpoints.device):
            _kernels.launch("svt_conv1_fused_raster", endpoints.data_ptr(),
                            visible.data_ptr(), reverse.data_ptr(),
                            w.data_ptr(), out.data_ptr(), n,
                            int(w.dtype == torch.bfloat16),
                            _kernels.stream_of(endpoints))
        conv1_fused_raster.launches += 1
    return out


conv1_fused_raster.launches = 0
