"""ViT-B/16 (Dosovitskiy et al., ICLR 2021, arXiv 2010.11929, Table 1
"ViT-Base"), plainly: torch ops in float32 from the named leaves the
program reads (svision_tpu_torch/models/vit.py), on mean-subtracted
images NHWC [N,227,227,3] (raster.images). Its widths come from the
configuration's model section.

  patches  a VALID grid of patch x patch over the image, row by row, each
           flattened in (kh, kw, ch) order
  z0       [cls ; patches W_p + b_p] + pos
  a layer  y = z + MHA(LN1(z)); z = y + W2 GELU(W1 LN2(y) + b1) + b2
  MHA(u)   concat_h softmax(q_h k_h^T / sqrt(d_h)) v_h W_o + b_o, q, k, v
           the three thirds of u W_qkv + b_qkv, each as heads of d_h
  LN(u)    (u - mean) / sqrt(var + ln_eps) scale + bias, biased variance
  GELU(x)  x Phi(x), the erf form
  logits   LN_f(z_L[cls]) W_head + b_head

Departures from the paper, as the configuration states them: SVision's
227 input, whose last 227 mod patch rows and columns the grid leaves out;
SVision's normalisation; a 5-class head.

`quant` makes each matmul (the patch embedding, q k v, q k^T, the
softmax times v, the output projection, both MLP layers, the head) read
its inputs rounded through a narrower type (the control's lower
precision); None computes in float32. Call under alexnet.f32_exact().
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def layer_norm(u: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    mean = u.mean(dim=-1, keepdim=True)
    var = ((u - mean) ** 2).mean(dim=-1, keepdim=True)
    return (u - mean) / torch.sqrt(var + eps) * scale + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.erf(x * 2.0 ** -0.5))


def logits(p: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
           quant: Optional[Callable] = None,
           fit: Optional[Callable] = None) -> torch.Tensor:
    """Logits [N, classes] of mean-subtracted images NHWC [N,H,W,C].
    fit(name, pre), if given, sees the patch embedding's output
    ('vit/patch', [N, patches, hidden]) and the logits ('vit/head') and
    returns the one to go on with (drivers/engine_vit.py fits the weights
    with it)."""
    q = quant or (lambda t: t)
    n, c = x.shape[0], x.shape[3]
    d, heads, k = model["hidden"], model["heads"], model["patch"]
    eps = model["ln_eps"]
    dh = d // heads
    g = model["input_size"] // k
    patches = (x[:, :g * k, :g * k].reshape(n, g, k, g, k, c)
               .permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, k * k * c))
    emb = (q(patches) @ q(p["vit/patch/weights"].reshape(-1, d))
           + p["vit/patch/biases"])
    if fit is not None:
        emb = fit("vit/patch", emb)
    z = torch.cat([p["vit/cls"].expand(n, 1, d), emb], dim=1) + p["vit/pos"]
    t = z.shape[1]
    for i in range(model["layers"]):
        at = f"vit/layer{i}"
        u = layer_norm(z, p[f"{at}/ln1/scale"], p[f"{at}/ln1/bias"], eps)
        qkv = q(u) @ q(p[f"{at}/qkv/weights"]) + p[f"{at}/qkv/biases"]
        qh, kh, vh = (qkv[..., j * d:(j + 1) * d].reshape(n, t, heads, dh)
                      .transpose(1, 2) for j in range(3))
        att = torch.softmax(q(qh) @ q(kh).transpose(-1, -2) * dh ** -0.5,
                            dim=-1)
        a = (q(att) @ q(vh)).transpose(1, 2).reshape(n, t, d)
        y = z + q(a) @ q(p[f"{at}/out/weights"]) + p[f"{at}/out/biases"]
        u = layer_norm(y, p[f"{at}/ln2/scale"], p[f"{at}/ln2/bias"], eps)
        h = gelu(q(u) @ q(p[f"{at}/mlp1/weights"]) + p[f"{at}/mlp1/biases"])
        z = y + q(h) @ q(p[f"{at}/mlp2/weights"]) + p[f"{at}/mlp2/biases"]
    cls = layer_norm(z[:, 0], p["vit/ln/scale"], p["vit/ln/bias"], eps)
    out = q(cls) @ q(p["vit/head/weights"]) + p["vit/head/biases"]
    return fit("vit/head", out) if fit is not None else out
