"""The int8 network: per-channel int8 weights, per-tensor int8 activations.

Counterpart of the JAX package's int8 path (svision_tpu/models/alexnet.py,
quantize_params_int8, _quantize_act and forward_raster_int8). Weights are
quantized symmetrically per output channel once, on the host; activations
per tensor with a max taken on the device over the whole batch (sentinel
pad rows included, as there). conv1 reads the {0,1} raster as exact int8
with scale 1. Each product is int8 x int8 -> int32, dequantized in f32;
bias, ReLU, pools and LRN run as in the bf16 network, with bf16 between
layers; fc8 stays bf16 with f32 logits.

The JAX package computes the int8 convolutions with XLA. Stock PyTorch has
no int8 convolution on the card, so each one here is an im2col from strided
views followed by torch._int_mm (cuBLASLt's int8 GEMM on the card), with
conv2, conv4 and conv5's two groups split by hand as the JAX package splits
them. torch._int_mm on the card wants more than 16 rows: int_mm pads fewer
rows with zeros, which change no result.

Everything that depends on the data stays on the device: the activation
scale is a 0-d tensor, so the forward can be captured into a CUDA graph.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from svision_tpu_torch.device import resolve_device
from svision_tpu_torch.models.alexnet import (_CONV_SPECS, _FC_SPECS,
                                              space_to_depth)
from svision_tpu_torch.ops.fused_pool_lrn import bias_relu_pool_lrn

__all__ = ["AlexNetInt8", "MIN_ROWS", "im2col", "int_mm", "quantize_act",
           "quantize_params_int8"]

_Q_LAYERS = ("conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7")
# torch._int_mm on the card refuses a first operand of 16 rows or fewer
MIN_ROWS = 17


def quantize_params_int8(folded_params: Mapping[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """Host numpy: fold_conv1_params output -> int8 weights + f32
    per-channel scales ({layer}/wscale); biases and fc8 pass through as f32.
    The same arithmetic as the JAX package's, so the same bits."""
    out: Dict[str, np.ndarray] = {}
    for name in _Q_LAYERS:
        w = np.asarray(folded_params[f"{name}/weights"], np.float32)
        axes = tuple(range(w.ndim - 1))          # all but the out-channel
        scale = np.maximum(np.abs(w).max(axis=axes), 1e-12) / 127.0
        w8 = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        out[f"{name}/weights"] = w8
        out[f"{name}/wscale"] = scale.astype(np.float32)
        out[f"{name}/biases"] = np.asarray(folded_params[f"{name}/biases"],
                                           np.float32)
    out["fc8/weights"] = np.asarray(folded_params["fc8/weights"], np.float32)
    out["fc8/biases"] = np.asarray(folded_params["fc8/biases"], np.float32)
    return out


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-tensor int8: (x8, scale), the scale a 0-d f32
    tensor on x's device. Rounds half to even and divides by the scale, as
    the JAX package does (a product with its reciprocal rounds otherwise)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(), min=1e-6) / 127.0
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M,K] x int8 [K,N] -> int32 [M,N] through torch._int_mm, with M
    padded by zero rows up to MIN_ROWS. On the card K and N must be
    multiples of 8 (every AlexNet layer's are); a shape the library refuses
    raises."""
    m = a.shape[0]
    if m < MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_ROWS - m))
    return torch._int_mm(a, b)[:m]


def im2col(x: torch.Tensor, k: int, pad: int, groups: int = 1):
    """Stride-1 k x k patches of int8 NHWC x [N,H,W,C], zero-padded by
    `pad` on each side: one [N*Ho*Wo, k*k*C/groups] int8 matrix per group
    of channels, patch order (kh, kw, c) as in HWIO weights. The gather
    is a copy of a strided view of x read as int64, so that each element
    copied moves 8 channels rather than one (C/groups is a multiple of 8
    at every AlexNet layer)."""
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    x = x.contiguous().view(torch.int64)
    n, h, w, c = x.shape
    sn, sh, sw, sc = x.stride()
    cols = x.as_strided((n, h - k + 1, w - k + 1, k, k, c),
                        (sn, sh, sw, sh, sw, sc))
    cg = c // groups
    return [cols[..., g * cg:(g + 1) * cg]
            .reshape(n * (h - k + 1) * (w - k + 1), -1).view(torch.int8)
            for g in range(groups)]


class AlexNetInt8(nn.Module):
    """forward_raster_int8 as a module: the int8 weights (per group,
    [out, K] row-major, so that their transpose is the column-major second
    operand cuBLASLt's int8 GEMM takes), the f32 scales and biases, and
    fc8's bf16 weights, on one device. Built by from_params from
    quantize_params_int8's output."""

    # grouped layers run as one GEMM a group (AlexNet.split_groups)
    split_groups = sum(spec[6] > 1 for spec in _CONV_SPECS)

    def __init__(self, q: Mapping[str, np.ndarray]):
        super().__init__()
        self.convs = []       # (name, kernel, pad, groups)
        for name, k, _, cout, _, padding, groups in _CONV_SPECS:
            pad = 0 if name == "conv1" else (k - 1) // 2
            if name == "conv1":       # the folded 3x3 stride-1 VALID conv
                k = 3
            w8 = torch.from_numpy(q[f"{name}/weights"])         # HWIO
            g_out = cout // groups
            for g in range(groups):
                wg = w8[..., g * g_out:(g + 1) * g_out]
                self.register_buffer(f"{name}_w{g}",
                                     wg.reshape(-1, g_out).t().contiguous())
            self.convs.append((name, k, pad, groups))
        for name, _, _ in _FC_SPECS[:2]:
            self.register_buffer(f"{name}_w0", torch.from_numpy(
                q[f"{name}/weights"]).t().contiguous())
        for name in _Q_LAYERS:
            self.register_buffer(f"{name}_scale",
                                 torch.from_numpy(q[f"{name}/wscale"]))
            self.register_buffer(f"{name}_bias",
                                 torch.from_numpy(q[f"{name}/biases"]))
        self.register_buffer("fc8_w", torch.from_numpy(
            q["fc8/weights"]).t().contiguous().to(torch.bfloat16))
        self.register_buffer("fc8_bias", torch.from_numpy(q["fc8/biases"]))
        # K2 adds no bias here: scale and bias are applied before the bf16
        # rounding, as the JAX package orders them
        for name in ("conv1", "conv2"):
            self.register_buffer(f"{name}_zero", torch.zeros(
                q[f"{name}/biases"].shape, dtype=torch.bfloat16))

    @classmethod
    def from_params(cls, q: Mapping[str, np.ndarray],
                    device=None) -> "AlexNetInt8":
        """quantize_params_int8's output -> the module on the card unless
        device asks for the CPU (resolve_device)."""
        return cls(q).to(resolve_device(device)).eval()

    def _dequant(self, name: str, y: torch.Tensor, a_scale) -> torch.Tensor:
        """relu(y * wscale * a_scale + b) rounded to bf16; a_scale None is
        conv1's exact scale of 1."""
        scale = getattr(self, f"{name}_scale")
        if a_scale is not None:
            scale = scale * a_scale
        return torch.relu(y.float() * scale
                          + getattr(self, f"{name}_bias")).to(torch.bfloat16)

    def _conv8(self, name: str, x8: torch.Tensor, k: int, pad: int,
               groups: int) -> torch.Tensor:
        """int8 NHWC x8 -> int32 NHWC, one GEMM per group."""
        n, h, w, _ = x8.shape
        ys = [int_mm(cols, getattr(self, f"{name}_w{g}").t())
              for g, cols in enumerate(im2col(x8, k, pad, groups))]
        y = ys[0] if groups == 1 else torch.cat(ys, dim=1)
        return y.reshape(n, h + 2 * pad - k + 1, w + 2 * pad - k + 1, -1)

    def forward(self, raster: torch.Tensor) -> torch.Tensor:
        """Logits f32 [N,5] from a {0,1} raster NHWC [N,227,227,3]."""
        h8 = space_to_depth(raster.to(torch.int8))     # exact: values {0,1}
        a_scale = None
        h = None
        for name, k, pad, groups in self.convs:
            if name != "conv1":
                h8, a_scale = quantize_act(h)
            h = self._dequant(name, self._conv8(name, h8, k, pad, groups),
                              a_scale)
            if name in ("conv1", "conv2"):
                h = bias_relu_pool_lrn(h, getattr(self, f"{name}_zero"))
            elif name == "conv5":
                h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
        h = h.reshape(h.shape[0], -1)                  # NHWC flatten
        for name, _, _ in _FC_SPECS[:2]:
            h8, a_scale = quantize_act(h)
            h = self._dequant(name, int_mm(h8, getattr(self, f"{name}_w0").t()),
                              a_scale)
        # fc8 in f32 from bf16 operands: the bf16 GEMM with f32 accumulation
        return F.linear(h.float(), self.fc8_w.float(), self.fc8_bias)

    forward_raster = forward
