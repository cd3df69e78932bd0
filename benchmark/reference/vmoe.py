"""V-MoE-B/16 (Riquelme et al., "Scaling Vision with Sparse Mixture of
Experts", NeurIPS 2021, arXiv 2106.05974), plainly: vit.py's ViT-B/16 with
the MLP of each sparse layer (the configuration's moe_layers) replaced by
a mixture of `experts` MLPs of the ViT's widths, in torch ops in float32
from the named leaves the program reads (svision_tpu_torch/models/
vit.py), on mean-subtracted images NHWC [N,227,227,3] (raster.images):

  a sparse layer  y = z + MHA(LN1(z)); u = LN2(y)
                  g = TOP_k(softmax(u W_r))   torch.topk: all but the k
                                              largest zeroed, the rest not
                                              renormalised
                  z = y + sum_e g_e (W2_e GELU(W1_e u + b1_e) + b2_e)

written as a loop over the experts, each over the rows routed to it; the
other equations are vit.py's.

Departures from the paper, as the configuration states them: vit.py's
(SVision's 227 input, its normalisation, a 5-class head); no capacity,
every token reaches its k experts; no router noise (training only); the
exact (erf) GELU.

`quant` makes each matmul (vit.py's, each router's and each expert's two)
read its inputs rounded through a narrower type (the control's lower
precision); `top1` leaves each token's second and later experts out (a
control). `routing`, if given, holds for each sparse layer in order the
experts [tokens, k'] (k' <= k) that the program gave each token; a token
takes them where their gate mass falls short of the reference's own
top-k mass by at most `tie` (a near-tie, which rounding may decide either
way), and the reference's own top k elsewhere; the gates are the
reference's. `routed`, if given, gains for each sparse layer the experts
given (the reference's own top k without `routing`) and their shortfall
(0 where they are its top k). fit(name, pre),
if given, sees vit.py's two points and each router's logits
('vit/layer{i}/router', [tokens, E]) and returns the one to go on with
(drivers/engine_vmoe.py fits the weights with it). Call under
alexnet.f32_exact().
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from benchmark.reference.vit import gelu, layer_norm


def moe(y: torch.Tensor, u: torch.Tensor, p: Dict[str, torch.Tensor],
        at: str, k: int, q: Callable, fit: Optional[Callable] = None,
        top1: bool = False, given: Optional[torch.Tensor] = None,
        routed: Optional[list] = None, tie: float = 0.0) -> torch.Tensor:
    """y + MoE(u) over tokens [T, hidden]; given, if given, the experts
    [T, k'] the program gave each token, taken on near-ties (logits())."""
    logits = q(u) @ q(p[f"{at}/router/weights"])
    if fit is not None:
        logits = fit(f"{at}/router", logits)
    probs = torch.softmax(logits, dim=-1)
    best = torch.topk(probs, k, dim=-1)
    experts = best.indices[:, :1] if top1 else best.indices
    if given is not None:
        short = best.values.sum(-1) - probs.gather(1, given).sum(-1)
        if routed is not None:
            routed.append((given, short))
        # k' < k columns: the missing experts are none (-1, gate 0)
        padded = torch.nn.functional.pad(given, (0, k - given.shape[1]),
                                         value=-1)
        experts = torch.where((short <= tie)[:, None], padded, experts)
    elif routed is not None:
        routed.append((experts, best.values.sum(-1)
                       - probs.gather(1, experts).sum(-1)))
    gates = torch.where(experts >= 0, probs.gather(1, experts.clamp(min=0)),
                        0.0)
    out = y.clone()
    for e in range(p[f"{at}/experts/mlp1/weights"].shape[0]):
        tok, j = torch.nonzero(experts == e, as_tuple=True)
        if not len(tok):
            continue
        h = gelu(q(u[tok]) @ q(p[f"{at}/experts/mlp1/weights"][e])
                 + p[f"{at}/experts/mlp1/biases"][e])
        o = q(h) @ q(p[f"{at}/experts/mlp2/weights"][e]) \
            + p[f"{at}/experts/mlp2/biases"][e]
        out.index_add_(0, tok, gates[tok, j, None] * o)
    return out


def logits(p: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
           quant: Optional[Callable] = None, fit: Optional[Callable] = None,
           top1: bool = False, routing: Optional[list] = None,
           routed: Optional[list] = None, tie: float = 0.0) -> torch.Tensor:
    """Logits [N, classes] of mean-subtracted images NHWC [N,H,W,C]."""
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
        if i in model["moe_layers"]:
            j = model["moe_layers"].index(i)
            z = moe(y.reshape(n * t, d), u.reshape(n * t, d), p, at,
                    model["top_k"], q, fit, top1,
                    None if routing is None else routing[j],
                    routed, tie).reshape(n, t, d)
            continue
        h = gelu(q(u) @ q(p[f"{at}/mlp1/weights"]) + p[f"{at}/mlp1/biases"])
        z = y + q(h) @ q(p[f"{at}/mlp2/weights"]) + p[f"{at}/mlp2/biases"]
    cls = layer_norm(z[:, 0], p["vit/ln/scale"], p["vit/ln/bias"], eps)
    out = q(cls) @ q(p["vit/head/weights"]) + p["vit/head/biases"]
    return fit("vit/head", out) if fit is not None else out
