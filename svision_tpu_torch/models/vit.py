"""ViT-B/16 and V-MoE-B/16 classifiers for similarity images, as a
PyTorch nn.Module.

The Vision Transformer of Dosovitskiy et al., "An Image is Worth 16x16
Words", ICLR 2021 (arXiv 2010.11929), Table 1 "ViT-Base": 12 pre-norm
encoder layers of hidden size 768, 12 heads of 64, MLP 3072, patch 16,
with a class token and learned position embeddings, in the form of
torchvision.models.vit_b_16 (LayerNorm eps 1e-6, exact erf GELU).
A backbone that users train in place of SVision's AlexNet
(models/alexnet.py) reads the same images and gives the same five
classes. The engine (infer/engine.py) picks it from the weights' leaf
names, renders K1's {0,1} raster (ops/raster_kernel.py) and runs it.

Equations, for the {0,1} raster r [227,227,3]:
  x = r * 255 - IMAGE_MEAN              SVision's normalisation, as
                                        AlexNet reads the image
  patches: a VALID 16/16 grid, 14 x 14 = 196 patches, j = 14 * row + col,
           each flattened in (kh, kw, ch) order
  z0 = [cls ; P W_p + b_p] + pos        197 tokens
  each layer: y = z + MHA(LN1(z)); z = y + W2 GELU(W1 LN2(y) + b1) + b2
  a sparse layer (V-MoE): y as above; u = LN2(y);
           g = TOP_k(softmax(u W_r))    all but the k largest zeroed, not
                                        renormalised; W_r [hidden, E], f32
           z = y + sum_e g_e (W2_e GELU(W1_e u + b1_e) + b2_e)
  MHA(u) = concat_h softmax(q_h k_h^T / sqrt(64)) v_h W_o + b_o
  LN(u) = (u - mean) / sqrt(var + 1e-6) * scale + bias  (biased variance)
  GELU(x) = x Phi(x)
  logits = LN_f(z_L[cls]) W_head + b_head, in f32

V-MoE-B/16 (Riquelme et al., "Scaling Vision with Sparse Mixture of
Experts", NeurIPS 2021, arXiv 2106.05974) is ViT-B/16 with the MLP of
every other layer (1, 3, ..., 11) replaced by E = 32 experts of the MLP's
widths, k = 2 a token: Widths' experts, top_k and moe_layers. Every token
reaches its k experts (no capacity, as at inference without one), so an
image's answer does not depend on its batchmates. The layer runs through
ops/moe.py: kernels on the card inside the replica's CUDA graph, their
plain versions on the CPU; the router's logits are f32 in both.

Departures from the published models: the input is SVision's 227 x 227
image, not 224, and its last 3 rows and columns are not read, exactly as
a 16/16 convolution over 227 leaves them; the input normalisation is
SVision's, not ImageNet's; the head has SVision's 5 classes.

The normalisation is affine, so fold_params folds it into the patch
embedding on the host, as fold_conv1_params does for AlexNet's conv1:
the network then reads the {0,1} raster.

Leaves are named as the AlexNet's are, in its layouts (weights [in, out],
the patch embedding HWIO): vit/patch/{weights,biases} [16,16,3,768] and
[768], vit/cls [768], vit/pos [197,768], vit/heads (the head count, an
integer array of shape []), per layer i vit/layer{i}/ln1/{scale,bias},
vit/layer{i}/qkv/{weights,biases} [768,2304] (q, k and v in that order,
each as heads of 64), vit/layer{i}/out, ln2, mlp1 [768,3072] and mlp2
[3072,768], then vit/ln/{scale,bias} and vit/head/{weights,biases}
[768,5]. A sparse layer i holds vit/layer{i}/router/weights [768,E] and
vit/layer{i}/experts/mlp1/{weights,biases} [E,768,3072] and [E,3072],
experts/mlp2 [E,3072,768] and [E,768] in place of mlp1 and mlp2, and
vit/top_k holds k (an integer array of shape []). Precision follows the
weights' dtype, as AlexNet's does; the routers stay f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from svision_tpu_torch.device import resolve_device
from svision_tpu_torch.models.alexnet import (IMAGE_MEAN, INPUT_SIZE,
                                              NUM_CLASSES)
from svision_tpu_torch.ops import moe

__all__ = ["LN_EPS", "VIT_B16", "VMOE_B16", "VisionTransformer", "Widths",
           "cast_params", "fold_params", "init_params", "is_vit", "is_vmoe",
           "leaf_shapes", "widths_of"]

LN_EPS = 1e-6
CHANNELS = 3
_PATCH = "vit/patch/weights"
_ROUTER = "/router/weights"
# leaves that hold integers, not weights
_COUNTS = ("vit/heads", "vit/top_k")


@dataclasses.dataclass(frozen=True)
class Widths:
    """The network's sizes; the defaults are ViT-B/16's."""
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp: int = 3072
    patch: int = 16
    classes: int = NUM_CLASSES
    # a V-MoE's experts a sparse layer, experts a token and sparse layers
    experts: int = 0
    top_k: int = 0
    moe_layers: Tuple[int, ...] = ()

    @property
    def grid(self) -> int:
        """Patches a side: the VALID grid over the 227 image."""
        return INPUT_SIZE // self.patch

    @property
    def tokens(self) -> int:
        """The class token and one token a patch."""
        return self.grid * self.grid + 1


VIT_B16 = Widths()
VMOE_B16 = Widths(experts=32, top_k=2, moe_layers=(1, 3, 5, 7, 9, 11))


def is_vit(params: Mapping[str, object]) -> bool:
    """Whether a weights dict holds this network, dense or sparse (and not
    AlexNet)."""
    return _PATCH in params


def is_vmoe(params: Mapping[str, object]) -> bool:
    """Whether a weights dict holds a V-MoE: a ViT with routers."""
    return is_vit(params) and any(k.endswith(_ROUTER) for k in params)


def leaf_shapes(w: Widths) -> Dict[str, tuple]:
    """{leaf name: shape} of every weight, in the network's order."""
    d, p = w.hidden, w.patch
    out = {_PATCH: (p, p, CHANNELS, d), "vit/patch/biases": (d,),
           "vit/cls": (d,), "vit/pos": (w.tokens, d)}
    for i in range(w.layers):
        at = f"vit/layer{i}"
        for name, n_in, n_out in (("ln1", 0, d), ("qkv", d, 3 * d),
                                  ("out", d, d), ("ln2", 0, d),
                                  ("mlp1", d, w.mlp), ("mlp2", w.mlp, d)):
            if name.startswith("mlp") and i in w.moe_layers:
                e = w.experts
                if name == "mlp1":
                    out[f"{at}/router/weights"] = (d, e)
                out[f"{at}/experts/{name}/weights"] = (e, n_in, n_out)
                out[f"{at}/experts/{name}/biases"] = (e, n_out)
            elif n_in:
                out[f"{at}/{name}/weights"] = (n_in, n_out)
                out[f"{at}/{name}/biases"] = (n_out,)
            else:
                out[f"{at}/{name}/scale"] = (n_out,)
                out[f"{at}/{name}/bias"] = (n_out,)
    out.update({"vit/ln/scale": (d,), "vit/ln/bias": (d,),
                "vit/head/weights": (d, w.classes),
                "vit/head/biases": (w.classes,)})
    return out


def widths_of(params: Mapping[str, object]) -> Widths:
    """The sizes a weights dict holds: from its leaves' shapes, the head
    count from vit/heads, and a V-MoE's sparse layers from its routers, its
    experts from their width and k from vit/top_k. Raises ValueError when
    a leaf is missing or of another shape than those sizes give."""
    try:
        p, _, _, d = np.shape(params[_PATCH])
        sparse = tuple(sorted(int(k.split("/")[1][len("layer"):])
                              for k in params if k.endswith(_ROUTER)))
        if sparse:
            at = f"vit/layer{sparse[0]}"
            experts = np.shape(params[at + _ROUTER])[1]
            mlp = np.shape(params[f"{at}/experts/mlp1/weights"])[2]
            top_k = int(np.asarray(params["vit/top_k"]))
        else:
            experts = top_k = 0
            mlp = np.shape(params["vit/layer0/mlp1/weights"])[1]
        w = Widths(hidden=d, heads=int(np.asarray(params["vit/heads"])),
                   layers=sum(1 for k in params if k.endswith("/qkv/weights")),
                   mlp=mlp, patch=p,
                   classes=np.shape(params["vit/head/weights"])[1],
                   experts=experts, top_k=top_k, moe_layers=sparse)
    except (KeyError, ValueError, TypeError, IndexError) as e:
        raise ValueError(f"ViT weights lack or misshape a leaf: {e!r}") from e
    want = leaf_shapes(w)
    counts = _COUNTS if sparse else _COUNTS[:1]
    got = {k: tuple(np.shape(v)) for k, v in params.items()
           if k not in counts}
    if (got != want or d % w.heads
            or (sparse and not 1 <= top_k <= experts)):
        raise ValueError(f"ViT weights of widths {w} hold other leaves: "
                         f"{sorted(set(got.items()) ^ set(want.items()))[:4]}")
    return w


def init_params(seed: int = 0,
                widths: Widths = VIT_B16) -> Dict[str, np.ndarray]:
    """Seeded f32 weights as torchvision's vit_b_16 initialises them, from a
    numpy seed: the patch embedding truncated-normal of std
    sqrt(1 / fan_in), q, k, v and the MLP Xavier-uniform, the output
    projection uniform in +-1 / sqrt(fan_in) (nn.Linear's), positions
    normal of std 0.02, the MLP's biases normal of std 1e-6, LayerNorms 1
    and 0; the head, which torchvision zeroes, Xavier-uniform too, so
    that the classes differ. A V-MoE's experts are drawn as the MLP is,
    each expert's matrix Xavier-uniform over its own fans, and its routers
    Xavier-uniform; vit/top_k holds k."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def xavier(shape):
        bound = np.sqrt(6.0 / (shape[-2] + shape[-1]))
        return rng.uniform(-bound, bound, shape).astype(f32)

    out: Dict[str, np.ndarray] = {}
    for name, shape in leaf_shapes(widths).items():
        kind = name.rsplit("/", 1)[-1]
        if name == _PATCH:
            fan_in = int(np.prod(shape[:3]))
            x = rng.standard_normal(shape)
            while np.any(np.abs(x) > 2.0 * np.sqrt(fan_in)):
                bad = np.abs(x) > 2.0 * np.sqrt(fan_in)
                x[bad] = rng.standard_normal(int(bad.sum()))
            out[name] = (x / np.sqrt(fan_in)).astype(f32)
        elif name == "vit/pos":
            out[name] = (0.02 * rng.standard_normal(shape)).astype(f32)
        elif kind == "scale":
            out[name] = np.ones(shape, f32)
        elif "/out/" in name and kind == "weights":
            bound = 1.0 / np.sqrt(shape[0])
            out[name] = rng.uniform(-bound, bound, shape).astype(f32)
        elif kind == "weights":
            out[name] = xavier(shape)
        elif "/mlp" in name and kind == "biases":
            out[name] = (1e-6 * rng.standard_normal(shape)).astype(f32)
        else:
            out[name] = np.zeros(shape, f32)
    out["vit/heads"] = np.asarray(widths.heads, np.int64)
    if widths.moe_layers:
        out["vit/top_k"] = np.asarray(widths.top_k, np.int64)
    return out


def fold_params(params: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The weights with SVision's input normalisation folded into the patch
    embedding, in f32 on the host: x = r * 255 - IMAGE_MEAN gives
    W_p' = 255 W_p and b_p' = b_p - sum over (kh, kw, ch) of
    IMAGE_MEAN[ch] W_p, so that the network reads the {0,1} raster r. Every
    patch is read whole, so every tap sees a normalised pixel. The other
    leaves are unchanged."""
    w = np.asarray(params[_PATCH], np.float32)
    b = np.asarray(params["vit/patch/biases"], np.float32)
    out = dict(params)
    out[_PATCH] = w * np.float32(255.0)
    out["vit/patch/biases"] = b - np.einsum(
        "hwco,c->o", w, np.asarray(IMAGE_MEAN, np.float32))
    return out


def cast_params(params: Mapping[str, np.ndarray], dtype: torch.dtype
                ) -> Dict[str, torch.Tensor]:
    """CPU tensors of every leaf in the dtype the network reads it in:
    dtype everywhere but the head's bias, which stays f32 for the logits
    (as AlexNet's fc8 bias does), the routers, which stay f32 for the
    routing, and vit/heads and vit/top_k, integers."""
    out = {}
    for k, v in params.items():
        if k in _COUNTS:
            out[k] = torch.as_tensor(np.asarray(v, np.int64))
            continue
        t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
        keep = k == "vit/head/biases" or k.endswith(_ROUTER)
        out[k] = t if keep else t.to(dtype)
    return out


class _Experts(nn.Module):
    """A sparse layer's router [hidden, E] (f32) and its E experts' MLPs,
    run by ops/moe.moe_mlp. rows, int64 [E] on the device (a row of the
    model's expert_rows), gains each expert's rows; routing, while a list,
    gains each pass's experts of each token."""

    def __init__(self, w: Widths):
        super().__init__()
        self.top_k = w.top_k
        e, d, m = w.experts, w.hidden, w.mlp
        self.router = nn.Parameter(torch.empty(d, e))
        self.w1 = nn.Parameter(torch.empty(e, d, m))
        self.b1 = nn.Parameter(torch.empty(e, m))
        self.w2 = nn.Parameter(torch.empty(e, m, d))
        self.b2 = nn.Parameter(torch.empty(e, d))
        self.rows: Optional[torch.Tensor] = None
        self.routing: Optional[list] = None

    def forward(self, y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return moe.moe_mlp(y, u, self.router, self.w1, self.b1, self.w2,
                           self.b2, self.top_k, self.rows, self.routing)


class _Layer(nn.Module):
    """One pre-norm encoder layer; a V-MoE's sparse layer has experts in
    place of its MLP."""

    def __init__(self, w: Widths, sparse: bool = False):
        super().__init__()
        self.heads = w.heads
        self.ln1 = nn.LayerNorm(w.hidden, eps=LN_EPS)
        self.qkv = nn.Linear(w.hidden, 3 * w.hidden)
        self.out = nn.Linear(w.hidden, w.hidden)
        self.ln2 = nn.LayerNorm(w.hidden, eps=LN_EPS)
        self.moe = _Experts(w) if sparse else None
        if not sparse:
            self.mlp1 = nn.Linear(w.hidden, w.mlp)
            self.mlp2 = nn.Linear(w.mlp, w.hidden)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        n, t, d = z.shape
        qkv = self.qkv(self.ln1(z)).view(n, t, 3, self.heads, d // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)       # [n,h,t,64]
        a = F.scaled_dot_product_attention(q, k, v)
        y = z + self.out(a.transpose(1, 2).reshape(n, t, d))
        if self.moe is None:
            return y + self.mlp2(F.gelu(self.mlp1(self.ln2(y))))
        return self.moe(y.reshape(n * t, d),
                        self.ln2(y).reshape(n * t, d)).view(n, t, d)


class VisionTransformer(nn.Module):
    """ViT over the {0,1} raster NHWC [N,227,227,3], with the normalisation
    folded into its patch embedding (fold_params). A V-MoE's model keeps
    expert_rows, int64 [sparse layers, E] on its device: the rows each
    expert took in each sparse layer (every token's k), summed over every
    batch since it was last zeroed (None in a dense ViT)."""

    def __init__(self, widths: Widths = VIT_B16):
        super().__init__()
        w = self.widths = widths
        self.patch = nn.Linear(w.patch * w.patch * CHANNELS, w.hidden)
        self.cls = nn.Parameter(torch.zeros(w.hidden))
        self.pos = nn.Parameter(torch.zeros(w.tokens, w.hidden))
        self.layers = nn.ModuleList(_Layer(w, i in w.moe_layers)
                                    for i in range(w.layers))
        self.ln = nn.LayerNorm(w.hidden, eps=LN_EPS)
        self.head = nn.Linear(w.hidden, w.classes)
        self.expert_rows: Optional[torch.Tensor] = None

    @classmethod
    def from_params(cls, params: Mapping[str, object],
                    device=None) -> "VisionTransformer":
        """Build from the named leaves (their dtypes kept) without a random
        init, on the card unless device asks for the CPU
        (resolve_device)."""
        w = widths_of(params)
        t = {k: torch.as_tensor(v) for k, v in params.items()}
        state = {"patch.weight": t[_PATCH].reshape(-1, w.hidden).t(),
                 "patch.bias": t["vit/patch/biases"],
                 "cls": t["vit/cls"], "pos": t["vit/pos"],
                 "ln.weight": t["vit/ln/scale"], "ln.bias": t["vit/ln/bias"],
                 "head.weight": t["vit/head/weights"].t(),
                 "head.bias": t["vit/head/biases"]}
        for i in range(w.layers):
            at = f"vit/layer{i}"
            for name in ("ln1", "ln2"):
                state[f"layers.{i}.{name}.weight"] = t[f"{at}/{name}/scale"]
                state[f"layers.{i}.{name}.bias"] = t[f"{at}/{name}/bias"]
            dense = ("qkv", "out") + (("mlp1", "mlp2")
                                      if i not in w.moe_layers else ())
            for name in dense:
                state[f"layers.{i}.{name}.weight"] = \
                    t[f"{at}/{name}/weights"].t()
                state[f"layers.{i}.{name}.bias"] = t[f"{at}/{name}/biases"]
            if i in w.moe_layers:
                moe_at = f"layers.{i}.moe"
                state[f"{moe_at}.router"] = t[at + _ROUTER]
                for j in (1, 2):
                    leaf = f"{at}/experts/mlp{j}"
                    state[f"{moe_at}.w{j}"] = t[f"{leaf}/weights"]
                    state[f"{moe_at}.b{j}"] = t[f"{leaf}/biases"]
        with torch.device("meta"):
            model = cls(w)
        model.load_state_dict({k: v.contiguous() for k, v in state.items()},
                              assign=True)
        dev = resolve_device(device)
        model.to(dev)
        if w.moe_layers:
            model.expert_rows = torch.zeros(
                (len(w.moe_layers), w.experts), dtype=torch.int64, device=dev)
            for experts, rows in zip(model._experts(), model.expert_rows):
                experts.rows = rows
        return model.eval().requires_grad_(False)

    def _experts(self) -> list:
        """The sparse layers' _Experts, in layer order."""
        return [layer.moe for layer in self.layers if layer.moe is not None]

    def keep_routing(self, routing: Optional[list]) -> None:
        """While routing is a list, each sparse layer of each forward pass
        appends to it the experts it routed each token to (int32 [tokens,
        k], in layer order); None stops."""
        for experts in self._experts():
            experts.routing = routing

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.patch.weight.dtype

    @property
    def tokens(self) -> int:
        return self.widths.tokens

    @property
    def split_groups(self) -> int:
        """AlexNet's grouped layers run split (AlexNet.split_groups); this
        network has none."""
        return 0

    def forward(self, raster: torch.Tensor) -> torch.Tensor:
        """Logits f32 [N,classes] from the {0,1} raster NHWC [N,227,227,3]."""
        w = self.widths
        n, g, p = raster.shape[0], w.grid, w.patch
        # the VALID grid: rows and columns past g * p are not read
        x = raster.to(self.compute_dtype)[:, :g * p, :g * p]
        x = (x.reshape(n, g, p, g, p, CHANNELS).permute(0, 1, 3, 2, 4, 5)
             .reshape(n, g * g, p * p * CHANNELS))
        z = torch.cat([self.cls.expand(n, 1, w.hidden), self.patch(x)], 1)
        z = z + self.pos
        for layer in self.layers:
            z = layer(z)
        h = self.ln(z[:, 0])
        # the head in f32: f32 logits from the compute dtype's features
        return F.linear(h.float(), self.head.weight.float(),
                        self.head.bias.float())
