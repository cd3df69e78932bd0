"""K2: bias + ReLU + 3x3/2 maxpool + LRN as one hand-written CUDA kernel.

Counterpart of the JAX package's ops/fused_pool_lrn.py
(bias_relu_pool_lrn). The kernel is csrc/pool_lrn.cu; its plain version is
bias_relu_pool_lrn_plain below, which a CPU tensor goes to. A CUDA tensor
launches the kernel or raises. It runs twice per batch on both engine
paths: after conv1 ([N,55,55,96] -> [N,27,27,96]) and after conv2
([N,27,27,256] -> [N,13,13,256]).

LRN has TF semantics (bias + alpha * sum of squares over c-2..c+2), not
F.local_response_norm's, which divides alpha by the window size. Math is
f32 inside with one rounding at the output.

Bound on an H100 at B=128 in bf16: 92.3 MB moved at conv1 (27.5 us at
3.35 TB/s), 58.9 MB at conv2 (17.6 us); twice that in f32. The kernel is a
persistent grid that streams input rows into a shared-memory ring with
bulk copies; its header note has the design.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from svision_tpu_torch.ops import _kernels

RADIUS = 2
ALPHA = 2e-5
BETA = 0.75
BIAS_K = 1.0


def lrn(x: torch.Tensor, radius: int = RADIUS, alpha: float = ALPHA,
        beta: float = BETA, bias: float = BIAS_K) -> torch.Tensor:
    """Local response normalization across the last (channel) axis, TF
    semantics: x / (bias + alpha * sum_{c-r..c+r} x^2)^beta, in x's dtype.
    The window is summed left to right, as the JAX package's alexnet.lrn
    does."""
    c = x.shape[-1]
    padded = F.pad(x * x, (radius, radius))
    win = padded[..., 0:c]
    for k in range(1, 2 * radius + 1):
        win = win + padded[..., k:k + c]
    v = bias + alpha * win
    if beta == 0.75:
        r = torch.rsqrt(v)
        return x * (r * torch.sqrt(r))      # v^-0.75
    return x * torch.pow(v, -beta)


def bias_relu_pool_lrn_plain(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [N,H,W,C] (bf16 or f32), bias [C]."""
    y = torch.relu(x.float() + bias.float())
    p = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    return lrn(p).to(x.dtype)


def bias_relu_pool_lrn(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(x + bias) -> 3x3 stride-2 VALID maxpool -> LRN(2, 2e-5, 0.75, 1).

    x [N,H,W,C] channels-last (bf16 or f32), bias [C] (bf16 or f32, read
    as stored) -> [N,Ho,Wo,C] in x's dtype. On the card x must be
    contiguous, which the NHWC permute of a channels_last NCHW tensor is,
    and 16-byte aligned: the kernel fills its ring with bulk copies. Not
    differentiable (_kernels.check_no_grad)."""
    _kernels.check_no_grad("bias_relu_pool_lrn", x, bias)
    if x.device.type == "cpu":
        return bias_relu_pool_lrn_plain(x, bias)
    floats = (torch.float32, torch.bfloat16)
    if x.dim() != 4 or x.dtype not in floats:
        raise ValueError("bias_relu_pool_lrn: x must be [N,H,W,C] f32/bf16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    n, h, w, c = x.shape
    if bias.shape != (c,) or bias.dtype not in floats or h < 3 or w < 3:
        raise ValueError(f"bias_relu_pool_lrn: bias {tuple(bias.shape)} "
                         f"{bias.dtype} for x {tuple(x.shape)}")
    _kernels.check_cuda(x, bias)
    if not (x.is_contiguous() and bias.is_contiguous()):
        raise ValueError("bias_relu_pool_lrn: x and bias must be contiguous, "
                         f"got x strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("bias_relu_pool_lrn: x must be 16-byte aligned, got "
                         f"address {x.data_ptr():#x}")
    ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            _kernels.launch("svt_bias_relu_pool_lrn", x.data_ptr(),
                            bias.data_ptr(), out.data_ptr(), n, h, w, c,
                            int(x.dtype == torch.bfloat16),
                            int(bias.dtype == torch.bfloat16),
                            _kernels.stream_of(x))
        bias_relu_pool_lrn.launches += 1
    return out


bias_relu_pool_lrn.launches = 0
