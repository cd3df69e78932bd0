"""ViT-B/16 (Dosovitskiy et al., ICLR 2021, arXiv 2010.11929, Table 1
"ViT-Base"), plainly: torch ops in float32, TF32 off, from the named
leaves that svision_tpu_torch/models/vit.py reads, on the {0,1} raster
that benchmark/reference/raster.py draws. It imports nothing of the port
or of JAX; every equation is written out (no nn.LayerNorm, no
scaled_dot_product_attention, no F.gelu).

Departures from the paper, as the port has them:
  - the input is SVision's 227 x 227 image, cut to a VALID grid of
    16 x 16 patches (14 x 14 = 196): its last 3 rows and columns are not
    read, where the paper's input is 224 x 224;
  - the image is SVision's normalisation of the raster, r * 255 minus the
    channel means (104, 117, 124), not ImageNet's;
  - the head has SVision's 5 classes.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import torch

IMAGE_MEAN = (104.0, 117.0, 124.0)
LN_EPS = 1e-6


@contextlib.contextmanager
def f32_exact():
    """float32 matmuls without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def layer_norm(u, scale, bias):
    mean = u.mean(dim=-1, keepdim=True)
    var = ((u - mean) ** 2).mean(dim=-1, keepdim=True)      # biased
    return (u - mean) / torch.sqrt(var + LN_EPS) * scale + bias


def gelu(x):
    """x Phi(x), the exact (erf) form."""
    return x * 0.5 * (1.0 + torch.erf(x / 2.0 ** 0.5))


def attention(u, p, at, heads):
    """concat_h softmax(q_h k_h^T / sqrt(d_h)) v_h W_o + b_o."""
    n, t, d = u.shape
    dh = d // heads
    qkv = u @ p[f"{at}/qkv/weights"] + p[f"{at}/qkv/biases"]
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(n, t, heads, dh)
               .transpose(1, 2) for i in range(3))
    a = torch.softmax(q @ k.transpose(-1, -2) / dh ** 0.5, dim=-1) @ v
    a = a.transpose(1, 2).reshape(n, t, d)
    return a @ p[f"{at}/out/weights"] + p[f"{at}/out/biases"]


def logits(params: Mapping[str, object], raster: torch.Tensor) -> torch.Tensor:
    """Logits f32 [N, classes] of the {0,1} raster f32 [N,227,227,3]."""
    dev = raster.device
    p = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    p = {k: v if k == "vit/heads" else v.float() for k, v in p.items()}
    heads = int(p["vit/heads"])
    ph, pw, c, d = p["vit/patch/weights"].shape
    x = raster.float() * 255.0 - torch.tensor(IMAGE_MEAN, device=dev)
    n = x.shape[0]
    g = x.shape[1] // ph
    # patch j = g * row + col, flattened in (kh, kw, ch) order
    patches = (x[:, :g * ph, :g * pw].reshape(n, g, ph, g, pw, c)
               .permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, ph * pw * c))
    emb = (patches @ p["vit/patch/weights"].reshape(-1, d)
           + p["vit/patch/biases"])
    z = torch.cat([p["vit/cls"].expand(n, 1, d), emb], dim=1) + p["vit/pos"]
    i = 0
    while f"vit/layer{i}/qkv/weights" in p:
        at = f"vit/layer{i}"
        y = z + attention(layer_norm(z, p[f"{at}/ln1/scale"],
                                     p[f"{at}/ln1/bias"]), p, at, heads)
        u = layer_norm(y, p[f"{at}/ln2/scale"], p[f"{at}/ln2/bias"])
        h = gelu(u @ p[f"{at}/mlp1/weights"] + p[f"{at}/mlp1/biases"])
        z = y + h @ p[f"{at}/mlp2/weights"] + p[f"{at}/mlp2/biases"]
        i += 1
    cls = layer_norm(z[:, 0], p["vit/ln/scale"], p["vit/ln/bias"])
    return cls @ p["vit/head/weights"] + p["vit/head/biases"]
