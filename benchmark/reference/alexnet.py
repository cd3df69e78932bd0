"""SVision's AlexNet, plainly (src/network/alexnet.py:26-58): NCHW torch
ops in float32 from TF-named weights in TF layouts.

  conv1 11x11x96 stride 4 VALID, ReLU, 3x3/2 max-pool, LRN
  conv2 5x5x256 SAME in 2 groups, ReLU, max-pool, LRN
  conv3 3x3x384 SAME, ReLU
  conv4 3x3x384 SAME in 2 groups, ReLU
  conv5 3x3x256 SAME in 2 groups, ReLU, max-pool
  flatten in NHWC order (TF's reshape), fc6 4096 ReLU, fc7 4096 ReLU
  (each followed by dropout when training), fc8 -> logits

LRN is TF's: x / (bias + alpha * sum over channels c-r..c+r of x^2)^beta.
`quant` makes each convolution and matmul read its input and weights
rounded through a narrower type (the control's lower precision); None
computes in float32. Call under f32_exact() for float32 without TF32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def f32_exact(tf32: bool = False):
    """float32 convolutions and matmuls, TF32 off unless asked for; on the
    CPU without oneDNN, whose convolutions round identical patches
    differently by position and so move max-pool ties."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.mkldnn.enabled)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.mkldnn.enabled) = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded through float8 e4m3 with a per-tensor scale that maps its
    largest magnitude to the type's largest (448), back in t's dtype; the
    gradient passes straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    q = ((t.detach() * (448.0 / amax)).to(torch.float8_e4m3fn)
         .to(t.dtype) * (amax / 448.0))
    return t + (q - t).detach()


def lrn(x: torch.Tensor, lrn_cfg: dict) -> torch.Tensor:
    """TF LRN over the channels (dim 1) of NCHW x."""
    r = lrn_cfg["depth_radius"]
    sq = F.pad(x * x, (0, 0, 0, 0, r, r))
    c = x.shape[1]
    window = sum(sq[:, k:k + c] for k in range(2 * r + 1))
    return x / (lrn_cfg["bias"] + lrn_cfg["alpha"] * window) ** lrn_cfg["beta"]


def features(p: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
             quant: Optional[Callable] = None,
             fit: Optional[Callable] = None) -> torch.Tensor:
    """Images NHWC [N,H,W,C] -> the flattened conv stack [N, fc6 inputs].
    fit(name, pre), if given, sees each layer's pre-activation and returns
    the one to go on with (benchmark/inputs.py fits the weights with it)."""
    q = quant or (lambda t: t)
    k, s = model["pool"]
    h = x.permute(0, 3, 1, 2)
    for name, kh, _, _, stride, padding, groups in model["conv"]:
        w = p[f"{name}/weights"].permute(3, 2, 0, 1)          # HWIO -> OIHW
        pad = 0 if padding == "VALID" else kh // 2
        h = F.conv2d(q(h), q(w), p[f"{name}/biases"], stride, pad, 1, groups)
        if fit is not None:
            h = fit(name, h)
        h = torch.relu(h)
        if name in model["pool_after"]:
            h = F.max_pool2d(h, k, s)
        if name in model["lrn_after"]:
            h = lrn(h, model["lrn"])
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def hidden(p: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
           quant: Optional[Callable] = None,
           dropout: Optional[Callable] = None,
           fit: Optional[Callable] = None) -> torch.Tensor:
    """The last hidden layer [N, last layer's inputs] of images NHWC
    [N,H,W,C]. dropout(h), if given, follows the ReLU of each fc layer."""
    q = quant or (lambda t: t)
    h = features(p, x, model, quant, fit)
    for name, _, _ in model["fc"][:-1]:
        h = F.linear(q(h), q(p[f"{name}/weights"].t()), p[f"{name}/biases"])
        if fit is not None:
            h = fit(name, h)
        h = torch.relu(h)
        if dropout is not None:
            h = dropout(h)
    return h


def logits(p: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
           quant: Optional[Callable] = None,
           dropout: Optional[Callable] = None,
           fit: Optional[Callable] = None) -> torch.Tensor:
    """Logits [N, classes] of images NHWC [N,H,W,C]."""
    q = quant or (lambda t: t)
    name = model["fc"][-1][0]
    out = F.linear(q(hidden(p, x, model, quant, dropout, fit)),
                   q(p[f"{name}/weights"].t()), p[f"{name}/biases"])
    return fit(name, out) if fit is not None else out
