"""Operations and bytes: the network's FLOPs, each kernel stage's least
time, and the table of peaks. Counted from the configuration's layer
shapes, whatever implements them.

A model FLOP is 2 x a multiply-accumulate of the reference network:
conv1 as 11x11x3 at stride 4 (not the space-to-depth fold the fast path
runs), conv2-5 with their groups, fc6-8. Pools, LRN, ReLU and softmax are
not counted. Training counts the forward, the input gradient and the
weight gradient of each layer (3x), less conv1's input gradient, which no
trainer forms.

A stage's least time is the larger of its bytes over the memory rate
(each input read once, each output written once, at the launch's shapes)
and its FLOPs over the peak for their kind.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def peaks(device_name: str) -> Dict[str, float]:
    """The published peaks of the card that torch.cuda.get_device_name()
    names (peaks.json), or KeyError."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    return table[device_name]


def peak_flops(device_name: str, precision: str) -> float:
    """Dense FLOP/s of one card for the configuration's precision
    (float32: CUDA cores, TF32 off)."""
    return peaks(device_name)[f"{precision}_flops"]


def layer_macs(model: dict) -> Dict[str, int]:
    """{layer: multiply-accumulates an image}: VALID or SAME convolutions,
    a pool after each layer in model["pool_after"], then the fc layers."""
    size, cin = model["input_size"], model["input_channels"]
    k, s = model["pool"]
    macs = {}
    for name, kh, kw, cout, stride, padding, groups in model["conv"]:
        if padding == "VALID":
            size = (size - kh) // stride + 1
        else:
            size = -(-size // stride)
        macs[name] = size * size * cout * kh * kw * (cin // groups)
        if name in model["pool_after"]:
            size = (size - k) // s + 1
        cin = cout
    if size * size * cin != model["fc"][0][1]:
        raise ValueError(f"the conv stack ends at {size}x{size}x{cin}, fc6 "
                         f"takes {model['fc'][0][1]}")
    for name, n_in, n_out in model["fc"]:
        macs[name] = n_in * n_out
    return macs


def inference_flops(model: dict) -> int:
    """Model FLOPs of one image's forward pass."""
    return 2 * sum(layer_macs(model).values())


def training_flops(model: dict) -> int:
    """Model FLOPs of one image's training step: forward, input and weight
    gradients, without the first layer's input gradient."""
    macs = layer_macs(model)
    first = model["conv"][0][0]
    return 3 * inference_flops(model) - 2 * macs[first]


def shapes(model: dict) -> Dict[str, tuple]:
    """NHWC shapes an image of the conv stack's activations: conv outputs
    by layer name, and `<layer>_pool` after its pool."""
    size, cin = model["input_size"], model["input_channels"]
    k, s = model["pool"]
    out = {}
    for name, kh, _, cout, stride, padding, _ in model["conv"]:
        size = ((size - kh) // stride + 1 if padding == "VALID"
                else -(-size // stride))
        out[name] = (size, size, cout)
        if name in model["pool_after"]:
            size = (size - k) // s + 1
            out[f"{name}_pool"] = (size, size, cout)
        cin = cout
    return out


def least_s(nbytes: float, flops: float, device_name: str,
            flops_kind: str) -> float:
    """The larger of bytes over the memory rate and FLOPs over the peak of
    flops_kind ('bfloat16' tensor cores, 'float32' CUDA cores)."""
    p = peaks(device_name)
    return max(nbytes / p["hbm_bytes_per_s"], flops / p[f"{flops_kind}_flops"])


# ----------------------------------------------------------------------
# the kernels' stages, per launch
# ----------------------------------------------------------------------

def endpoint_bytes(rows: int) -> int:
    """The raster kernels' inputs: int32 endpoints [rows,2,4] and two bool
    flags [rows,2]."""
    return rows * (2 * 4 * 4 + 2 + 2)


def k1_stage(model: dict, rows: int, dtype: str):
    """(bytes, FLOPs) of K1 (ops/raster_kernel.py) on rows images: the
    endpoints in, the {0,1} raster [rows,227,227,3] out. It is integer
    work: no FLOPs."""
    n = model["input_size"]
    return (endpoint_bytes(rows)
            + rows * n * n * model["input_channels"] * DTYPE_BYTES[dtype], 0)


def k3_stage(model: dict, rows: int, dtype: str, lit_macs: int):
    """(bytes, FLOPs) of K3 (ops/fused_conv1.py) on rows images: the
    endpoints and conv1's folded weights in, conv1's pre-activation out;
    its FLOPs are the multiply-accumulates these images need, those of
    their lit pixels (lit_macs, conv1_lit_macs)."""
    name, kh, kw, cout, stride, _, _ = model["conv"][0]
    ho = shapes(model)[name][0]
    fold = -(-kh // stride)                  # the 11x11/4 conv as 3x3 on s2d
    cin = model["input_channels"] * stride * stride
    ds = DTYPE_BYTES[dtype]
    return (endpoint_bytes(rows) + fold * fold * cin * cout * ds
            + rows * ho * ho * cout * ds, 2 * lit_macs)


def conv1_lit_macs(raster: torch.Tensor, model: dict) -> int:
    """Multiply-accumulates of conv1 over the lit pixels of a {0,1} raster
    [N,H,W,C]: each lit pixel times the output positions whose window
    holds it, times the output channels. A dark pixel adds nothing."""
    name, kh, _, cout, stride, _, _ = model["conv"][0]
    ho = shapes(model)[name][0]
    h = raster.shape[1]
    pos = torch.arange(h, device=raster.device)
    # output rows i with stride*i <= r <= stride*i + kh - 1
    hi = torch.clamp(torch.div(pos, stride, rounding_mode="floor"), max=ho - 1)
    lo = torch.clamp(torch.div(pos - kh + stride, stride,
                               rounding_mode="floor"), min=0)
    cover = torch.clamp(hi - lo + 1, min=0).to(torch.float64)
    lit = raster.to(torch.float64).sum(dim=(0, 3))              # [H,W]
    return int(round(float(cover @ lit @ cover))) * cout


def k2_stage(model: dict, rows: int, layer: str, dtype: str):
    """(bytes, FLOPs) of K2 forward (ops/fused_pool_lrn.py) after `layer`:
    x [rows,H,W,C] and the bias in, [rows,Ho,Wo,C] out. FLOPs: bias add
    and ReLU an input element; 8 comparisons, the window's 5 squares and 4
    adds, the scale, the power (3) and the product an output element."""
    sh = shapes(model)
    h, w, c = sh[layer]
    ho, wo, _ = sh[f"{layer}_pool"]
    ds = DTYPE_BYTES[dtype]
    n_in, n_out = rows * h * w * c, rows * ho * wo * c
    return ((n_in + c + n_out) * ds, 2 * n_in + 23 * n_out)


def k2_backward_stage(model: dict, rows: int, layer: str, dtype: str):
    """(bytes, FLOPs) of K2's backward after `layer`: x, the bias and dy
    in, dx and the bias gradient out. FLOPs: the forward's, recomputed;
    the LRN's gradient (20 an output element); the routing, ReLU mask and
    bias sum (3 an input element)."""
    sh = shapes(model)
    h, w, c = sh[layer]
    ho, wo, _ = sh[f"{layer}_pool"]
    ds = DTYPE_BYTES[dtype]
    n_in, n_out = rows * h * w * c, rows * ho * wo * c
    return ((2 * n_in + n_out + 2 * c) * ds,
            2 * n_in + 23 * n_out + 20 * n_out + 3 * n_in)
