"""V-MoE-B/16 (Riquelme et al., "Scaling Vision with Sparse Mixture of
Experts", NeurIPS 2021, arXiv 2106.05974), plainly: tests/reference_vit.py's
ViT with the MLP of each sparse layer replaced by a mixture of experts, in
float32, TF32 off, from the named leaves that svision_tpu_torch/models/
vit.py reads. It imports nothing of the port or of JAX; the layer is
written out:

  logits = u W_r                  u = LN2(y), W_r [hidden, E]
  g = TOP_k(softmax(logits))      torch.topk: all but the k largest zeroed,
                                  not renormalised
  z = y + sum_e g_e (W2_e GELU(W1_e u + b1_e) + b2_e)

as a loop over the experts, each over the rows routed to it.

Departures from the paper, as the port has them: the ViT's (reference_vit:
SVision's 227 input on a VALID grid, its normalisation, 5 classes); no
capacity, so every token reaches its k experts (the paper trains at a
capacity ratio of 1.05 and varies it at inference); no router noise (the
paper adds it in training only); the exact (erf) GELU.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from tests.reference_vit import (IMAGE_MEAN, attention, f32_exact, gelu,
                                 layer_norm)

__all__ = ["f32_exact", "logits", "moe"]


def moe(y: torch.Tensor, u: torch.Tensor, p, at: str, k: int,
        routed: Optional[list] = None,
        experts: Optional[torch.Tensor] = None, tie: float = math.inf,
        shortfall: Optional[list] = None) -> torch.Tensor:
    """y + MoE(u) over tokens [T, hidden]; routed, if given, gains the
    experts [T, k] the tokens take; experts, if given, are the experts
    [T, k] each token takes in place of its top k where their gate mass
    falls short of the top k's by at most `tie` (a near-tie), the gates
    still the softmax's; shortfall, if given, gains that shortfall [T]."""
    probs = torch.softmax(u @ p[f"{at}/router/weights"], dim=-1)
    gates, top = torch.topk(probs, k, dim=-1)
    short = torch.zeros_like(gates[:, 0])
    if experts is not None:
        short = gates.sum(-1) - probs.gather(1, experts).sum(-1)
        experts = torch.where((short <= tie)[:, None], experts, top)
        gates = probs.gather(1, experts)
    else:
        experts = top
    if shortfall is not None:
        shortfall.append(short)
    if routed is not None:
        routed.append(experts)
    w1, b1 = p[f"{at}/experts/mlp1/weights"], p[f"{at}/experts/mlp1/biases"]
    w2, b2 = p[f"{at}/experts/mlp2/weights"], p[f"{at}/experts/mlp2/biases"]
    out = y.clone()
    for e in range(w1.shape[0]):
        tok, j = torch.nonzero(experts == e, as_tuple=True)
        h = gelu(u[tok] @ w1[e] + b1[e]) @ w2[e] + b2[e]
        out.index_add_(0, tok, gates[tok, j, None] * h)
    return out


def logits(params: Mapping[str, object], raster: torch.Tensor,
           routed: Optional[list] = None,
           routing: Optional[list] = None, tie: float = math.inf,
           shortfall: Optional[list] = None) -> torch.Tensor:
    """Logits f32 [N, classes] of the {0,1} raster f32 [N,227,227,3];
    routed, if given, gains each sparse layer's experts [N x tokens, k]
    the tokens take, in layer order; routing, if given, holds for each
    sparse layer in order the experts [N x tokens, k] each token takes in
    place of the top k within `tie` of its gate mass (the engine's
    expert_choices, to hold the rest of the network to the reference
    given the engine's routing on near-ties); shortfall, if given, gains
    each sparse layer's shortfall of the given experts' gate mass [N x
    tokens] (moe())."""
    dev = raster.device
    p = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    counts = ("vit/heads", "vit/top_k")
    p = {k: v if k in counts else v.float() for k, v in p.items()}
    heads, top_k = int(p["vit/heads"]), int(p["vit/top_k"])
    ph, pw, c, d = p["vit/patch/weights"].shape
    x = raster.float() * 255.0 - torch.tensor(IMAGE_MEAN, device=dev)
    n = x.shape[0]
    g = x.shape[1] // ph
    patches = (x[:, :g * ph, :g * pw].reshape(n, g, ph, g, pw, c)
               .permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, ph * pw * c))
    emb = (patches @ p["vit/patch/weights"].reshape(-1, d)
           + p["vit/patch/biases"])
    z = torch.cat([p["vit/cls"].expand(n, 1, d), emb], dim=1) + p["vit/pos"]
    i = j = 0
    while f"vit/layer{i}/qkv/weights" in p:
        at = f"vit/layer{i}"
        y = z + attention(layer_norm(z, p[f"{at}/ln1/scale"],
                                     p[f"{at}/ln1/bias"]), p, at, heads)
        u = layer_norm(y, p[f"{at}/ln2/scale"], p[f"{at}/ln2/bias"])
        if f"{at}/router/weights" in p:
            t = y.shape[1]
            z = moe(y.reshape(n * t, d), u.reshape(n * t, d), p, at, top_k,
                    routed, None if routing is None else routing[j],
                    tie, shortfall).reshape(n, t, d)
            j += 1
        else:
            h = gelu(u @ p[f"{at}/mlp1/weights"] + p[f"{at}/mlp1/biases"])
            z = y + h @ p[f"{at}/mlp2/weights"] + p[f"{at}/mlp2/biases"]
        i += 1
    cls = layer_norm(z[:, 0], p["vit/ln/scale"], p["vit/ln/bias"])
    return cls @ p["vit/head/weights"] + p["vit/head/biases"]
