"""K2: bias + ReLU + 3x3/2 maxpool + LRN as one hand-written CUDA kernel,
and its backward as another.

Counterpart of the JAX package's ops/fused_pool_lrn.py
(bias_relu_pool_lrn). The kernel is csrc/pool_lrn.cu; its plain version is
bias_relu_pool_lrn_plain below, which a CPU tensor goes to. A CUDA tensor
launches the kernel or raises. It runs twice per batch on both engine
paths: after conv1 ([N,55,55,96] -> [N,27,27,96]) and after conv2
([N,27,27,256] -> [N,13,13,256]). The bf16 network keeps conv2's two
groups apart (models/alexnet.py), and K2 meets them where they lie: it
writes conv1's tail as conv2's two input halves and reads conv2's two
output halves, so nothing joins or copies them.

The trainers run the same function through BiasReluPoolLRN, an autograd
Function: K2 forward, and backward csrc/pool_lrn_backward.cu
(bias_relu_pool_lrn_backward; plain version
bias_relu_pool_lrn_backward_plain). The JAX package has no backward kernel:
its trainer differentiates XLA's ops. The inference wrapper stays not
differentiable; the Function is the only way a gradient passes K2.

LRN has TF semantics (bias + alpha * sum of squares over c-2..c+2), not
F.local_response_norm's, which divides alpha by the window size. Math is
f32 inside with one rounding at the output.

Bound on an H100 at B=128 in bf16: 92.3 MB moved at conv1 (27.5 us at
3.35 TB/s), 58.9 MB at conv2 (17.6 us); twice that in f32. The kernel is a
persistent grid that streams input rows into a shared-memory ring with
bulk copies; its header note has the design.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from svision_tpu_torch.ops import _kernels

RADIUS = 2
ALPHA = 2e-5
BETA = 0.75
BIAS_K = 1.0
# what the CUDA kernels take; on the card any other dtype raises
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the backward kernel: 8 channels a thread, a pixel's threads in one
# 384-thread block
BACKWARD_LANE = 8
MAX_BACKWARD_C = BACKWARD_LANE * 384


def _window_sum(t: torch.Tensor, radius: int = RADIUS) -> torch.Tensor:
    """Sum over channels c-radius..c+radius of the last axis, zero padded,
    left to right."""
    c = t.shape[-1]
    padded = F.pad(t, (radius, radius))
    s = padded[..., 0:c]
    for k in range(1, 2 * radius + 1):
        s = s + padded[..., k:k + c]
    return s


def lrn(x: torch.Tensor, radius: int = RADIUS, alpha: float = ALPHA,
        beta: float = BETA, bias: float = BIAS_K) -> torch.Tensor:
    """Local response normalization across the last (channel) axis, TF
    semantics: x / (bias + alpha * sum_{c-r..c+r} x^2)^beta, in x's dtype.
    The window is summed left to right, as the JAX package's alexnet.lrn
    does."""
    v = bias + alpha * _window_sum(x * x, radius)
    if beta == 0.75:
        r = torch.rsqrt(v)
        return x * (r * torch.sqrt(r))      # v^-0.75
    return x * torch.pow(v, -beta)


def _wide(dtype) -> torch.dtype:
    """The plain versions' arithmetic: f32 for bf16 and f32, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def _pieces(x, out_halves: bool) -> tuple:
    """K2's input as its pieces: (x,) for a tensor, (x0, x1) for a pair of
    channel halves, which must agree in shape, dtype and device; halves go
    in or come out, not both."""
    if isinstance(x, torch.Tensor):
        return (x,)
    xs = tuple(x)
    if out_halves:
        raise ValueError("bias_relu_pool_lrn: channel halves go in or come "
                         "out, not both")
    if len(xs) != 2 or any(
            (t.shape, t.dtype, t.device) != (xs[0].shape, xs[0].dtype,
                                             xs[0].device) for t in xs):
        got = [(tuple(t.shape), t.dtype, str(t.device)) for t in xs]
        raise ValueError("bias_relu_pool_lrn: x must be a tensor or two "
                         "channel halves of one shape, dtype and device, got "
                         f"{got}")
    return xs


def bias_relu_pool_lrn_plain(x, bias: torch.Tensor, out_halves: bool = False):
    """Plain PyTorch version, in bias_relu_pool_lrn's forms: x [N,H,W,C]
    (bf16 or f32; f64 computes in f64) or its two channel halves, joined
    first; bias [C]; out_halves splits the output into its two channel
    halves, each contiguous."""
    xs = _pieces(x, out_halves)
    x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
    wide = _wide(x.dtype)
    y = torch.relu(x.to(wide) + bias.to(wide))
    p = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    out = lrn(p).to(x.dtype)
    if out_halves:
        return tuple(t.contiguous() for t in out.chunk(2, dim=-1))
    return out


def bias_relu_pool_lrn(x, bias: torch.Tensor, *, out_halves: bool = False):
    """relu(x + bias) -> 3x3 stride-2 VALID maxpool -> LRN(2, 2e-5, 0.75, 1).

    x [N,H,W,C] channels-last (bf16 or f32), bias [C] (bf16 or f32, read
    as stored) -> [N,Ho,Wo,C] in x's dtype. On the card x must be
    contiguous, which the NHWC permute of a channels_last NCHW tensor is,
    and 16-byte aligned: the kernel fills its ring with bulk copies. Not
    differentiable (_kernels.check_no_grad).

    The split forms, for a network that keeps two channel groups apart:
    x may be a pair (x0, x1) of its channel halves [N,H,W,C/2], which the
    kernel reads where they lie, and out_halves=True returns the output
    as its two channel halves [N,Ho,Wo,C/2], one form or the other. On
    the card they take C % 16 == 0 and every half contiguous and 16-byte
    aligned. A call in a split form also ticks bias_relu_pool_lrn_halves,
    on the CPU too."""
    xs = _pieces(x, out_halves)
    _kernels.check_no_grad("bias_relu_pool_lrn", *xs, bias)
    split = len(xs) == 2 or out_halves
    if xs[0].device.type == "cpu":
        bias_relu_pool_lrn_halves.launches += split
        return bias_relu_pool_lrn_plain(x, bias, out_halves)
    x = xs[0]
    if x.dim() != 4 or x.dtype not in KERNEL_DTYPES:
        raise ValueError("bias_relu_pool_lrn: x must be [N,H,W,C] f32/bf16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    n, h, w, c = x.shape
    c *= len(xs)
    if (bias.shape != (c,) or bias.dtype not in KERNEL_DTYPES or h < 3
            or w < 3):
        raise ValueError(f"bias_relu_pool_lrn: bias {tuple(bias.shape)} "
                         f"{bias.dtype} for x {tuple(x.shape)} x {len(xs)}")
    _kernels.check_cuda(*xs, bias)
    if not (all(t.is_contiguous() for t in xs) and bias.is_contiguous()):
        raise ValueError("bias_relu_pool_lrn: x and bias must be contiguous, "
                         f"got x strides {[t.stride() for t in xs]}")
    if any(t.data_ptr() % 16 for t in xs):
        raise ValueError("bias_relu_pool_lrn: x must be 16-byte aligned, got "
                         f"addresses {[hex(t.data_ptr()) for t in xs]}")
    if split and c % 16:
        raise ValueError("bias_relu_pool_lrn: the split forms take C % 16 == "
                         f"0, got C {c}")
    ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    outs = tuple(torch.empty((n, ho, wo, c // (1 + out_halves)),
                             dtype=x.dtype, device=x.device)
                 for _ in range(1 + out_halves))
    if n:
        args = (n, h, w, c, int(x.dtype == torch.bfloat16),
                int(bias.dtype == torch.bfloat16), _kernels.stream_of(x))
        with torch.cuda.device(x.device):
            if split:
                _kernels.launch(
                    "svt_bias_relu_pool_lrn_split", x.data_ptr(),
                    xs[1].data_ptr() if len(xs) == 2 else None,
                    bias.data_ptr(), outs[0].data_ptr(),
                    outs[1].data_ptr() if out_halves else None, *args)
            else:
                _kernels.launch("svt_bias_relu_pool_lrn", x.data_ptr(),
                                bias.data_ptr(), outs[0].data_ptr(), *args)
        bias_relu_pool_lrn.launches += 1
        bias_relu_pool_lrn_halves.launches += split
    return outs if out_halves else outs[0]


bias_relu_pool_lrn.launches = 0
# bias_relu_pool_lrn's calls in a split form: on the card each is one of
# its launches, on the CPU a call of the plain version, so that the CPU
# tests see the split route's wiring. graphs.kernel_wrappers() lists it
# beside the wrappers, so captures and replays count it as they count
# theirs.
bias_relu_pool_lrn_halves = types.SimpleNamespace(
    __name__="bias_relu_pool_lrn_halves", launches=0)


# ---------------------------------------------------------------------------
# the backward, and the autograd Function the trainers call
# ---------------------------------------------------------------------------



def bias_relu_pool_lrn_backward_plain(x: torch.Tensor, bias: torch.Tensor,
                                      dy: torch.Tensor):
    """(dx, dbias) of bias_relu_pool_lrn at (x, bias) for the output
    gradient dy [N,Ho,Wo,C], by its explicit formula (no autograd), in
    f32 (f64 for f64 input) with dx rounded once to x's dtype. With y =
    relu(x + bias), p its 3x3/2 max-pool and v = 1 + ALPHA * (window sum of
    p^2):
        dp = dy v^-BETA - 2 ALPHA BETA p (window sum of dy p v^(-BETA-1)),
    routed to the first maximum of each window in row-major order (as
    F.max_pool2d and XLA's select-and-scatter route ties), the taps added
    in that order, then masked where x + bias <= 0; dbias sums dx."""
    wide = _wide(x.dtype)
    y = torch.relu(x.to(wide) + bias.to(wide))
    _, h, w, _ = x.shape
    ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    taps = [(dr, dc) for dr in range(3) for dc in range(3)]

    def tap(t, dr, dc):
        return t[:, dr:dr + 2 * ho - 1:2, dc:dc + 2 * wo - 1:2]
    win = torch.stack([tap(y, dr, dc) for dr, dc in taps], -1)
    arg = win.argmax(-1)                    # the first maximum
    p = win.amax(-1)
    v = BIAS_K + ALPHA * _window_sum(p * p)
    r = torch.rsqrt(v)
    u = dy.to(wide) * (r * torch.sqrt(r))   # dy v^-BETA, BETA = 0.75
    dp = u - 2 * ALPHA * BETA * p * _window_sum(u * p * (r * r))
    dx = torch.zeros_like(y)
    for k, (dr, dc) in enumerate(taps):
        tap(dx, dr, dc).add_(torch.where(arg == k, dp, 0.0))
    dx = torch.where(y > 0, dx, 0.0)
    return dx.to(x.dtype), dx.sum((0, 1, 2)).to(bias.dtype)


def bias_relu_pool_lrn_backward(x: torch.Tensor, bias: torch.Tensor,
                                dy: torch.Tensor):
    """(dx, dbias) of bias_relu_pool_lrn at (x, bias) for the output
    gradient dy: x [N,H,W,C] and dy [N,Ho,Wo,C] of one dtype, bias [C]; dx
    in x's dtype, dbias in bias's. A CPU tensor takes the plain version;
    on the card x and dy must be contiguous, 16-byte aligned f32 or bf16,
    C a multiple of BACKWARD_LANE and at most MAX_BACKWARD_C (the kernel
    moves 8 channels in 16-byte accesses), and the kernel launches or the
    call raises. The kernel recomputes the forward from x and bias, so
    nothing else is saved, and writes dbias itself: no torch op follows
    its launch. Not differentiable (_kernels.check_no_grad)."""
    _kernels.check_no_grad("bias_relu_pool_lrn_backward", x, bias, dy)
    if x.dim() != 4:
        raise ValueError("bias_relu_pool_lrn_backward: x must be [N,H,W,C], "
                         f"got {tuple(x.shape)}")
    n, h, w, c = x.shape
    ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    if (h < 3 or w < 3 or bias.shape != (c,) or dy.shape != (n, ho, wo, c)
            or dy.dtype != x.dtype):
        raise ValueError(f"bias_relu_pool_lrn_backward: x {tuple(x.shape)} "
                         f"{x.dtype}, bias {tuple(bias.shape)}, dy "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if x.device.type == "cpu":
        return bias_relu_pool_lrn_backward_plain(x, bias, dy)
    if x.dtype not in KERNEL_DTYPES or bias.dtype not in KERNEL_DTYPES:
        raise ValueError("bias_relu_pool_lrn_backward: the kernel takes f32 "
                         f"or bf16, got x {x.dtype}, bias {bias.dtype}")
    if c % BACKWARD_LANE or c > MAX_BACKWARD_C:
        raise ValueError(f"bias_relu_pool_lrn_backward: C {c} is not a "
                         f"multiple of {BACKWARD_LANE} up to {MAX_BACKWARD_C}")
    _kernels.check_cuda(x, bias, dy)
    if not (x.is_contiguous() and bias.is_contiguous()
            and dy.is_contiguous()):
        raise ValueError("bias_relu_pool_lrn_backward: x, bias and dy must "
                         f"be contiguous, got strides {x.stride()}, "
                         f"{dy.stride()}")
    if (x.data_ptr() | dy.data_ptr()) % 16:
        raise ValueError("bias_relu_pool_lrn_backward: x and dy must be "
                         f"16-byte aligned, got addresses {x.data_ptr():#x}, "
                         f"{dy.data_ptr():#x}")
    dx = torch.empty_like(x)
    if not n:
        return dx, torch.zeros_like(bias)
    db = torch.empty_like(bias)
    # the blocks' f32 bias-gradient sums, then the call's ticket
    scratch = torch.empty(n * ho * c + 4, dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        _kernels.launch("svt_bias_relu_pool_lrn_backward", x.data_ptr(),
                        bias.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                        db.data_ptr(), scratch.data_ptr(), n, h, w, c,
                        int(x.dtype == torch.bfloat16),
                        int(bias.dtype == torch.bfloat16),
                        _kernels.stream_of(x))
    bias_relu_pool_lrn_backward.launches += 1
    return dx, db


bias_relu_pool_lrn_backward.launches = 0


class BiasReluPoolLRN(torch.autograd.Function):
    """bias_relu_pool_lrn, differentiable: apply(x, bias) with x
    [N,H,W,C] (an NHWC view is copied if it is not contiguous) and bias
    [C] -> [N,Ho,Wo,C] in x's dtype. Forward K2 (bias_relu_pool_lrn),
    backward the backward kernel (bias_relu_pool_lrn_backward); a CPU
    tensor takes their plain versions, in f64 too, and on the card an
    input the kernels do not take raises. Saves x and bias only. `copies`
    counts the .contiguous() copies made of x and of the incoming
    gradient."""

    copies = 0

    @staticmethod
    def _contiguous(t: torch.Tensor) -> torch.Tensor:
        if t.is_contiguous():
            return t
        BiasReluPoolLRN.copies += 1
        return t.contiguous()

    @staticmethod
    def forward(ctx, x, bias):
        x = BiasReluPoolLRN._contiguous(x)
        ctx.save_for_backward(x, bias)
        return bias_relu_pool_lrn(x, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors
        return bias_relu_pool_lrn_backward(x, bias,
                                           BiasReluPoolLRN._contiguous(dy))
