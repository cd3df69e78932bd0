"""Operations and bytes of the V-MoE configurations (configs/*vmoe*.json),
counted from the configuration's widths, whatever implements them;
work_vit.py counts the ViT's, work.py holds the peaks and least_s.

A model FLOP is 2 x a multiply-accumulate of the reference network: the
ViT's (work_vit.layer_macs, every layer's MLP once), plus each token's
second and later experts in each sparse layer (k - 1 more MLPs of the
same widths a token), plus each sparse layer's router (u W_r). At
V-MoE-B/16's widths: 35,126,128,128 + 11,154,751,488 + 58,097,664 =
46,338,977,280 an image.

A launch's bytes read each input once and write each output once, at the
engine's rows a launch (`rows` images, T = rows x tokens tokens, R = T x k
routed rows): activations in the compute dtype, indices int32 (4 bytes),
gates f32; a grouped product reads every expert's matrix once.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.work import DTYPE_BYTES
from benchmark.work_vit import layer_macs as vit_layer_macs
from benchmark.work_vit import tokens

# a route block's tokens (svision_tpu_torch/ops/moe.py ROUTE_TOKENS):
# the route writes a count of each expert a block
ROUTE_TOKENS = 128
INDEX_BYTES = 4


def layer_macs(model: dict) -> Dict[str, int]:
    """{matmul: multiply-accumulates an image}, the layers' summed: the
    ViT's, with 'mlp1' and 'mlp2' holding each sparse layer's k experts a
    token, and 'router'."""
    macs = vit_layer_macs(model)
    s, k = len(model["moe_layers"]), model["top_k"]
    t, d, m = tokens(model), model["hidden"], model["mlp"]
    macs["mlp1"] += (k - 1) * s * t * d * m
    macs["mlp2"] += (k - 1) * s * t * m * d
    macs["router"] = s * t * d * model["experts"]
    return macs


def inference_flops(model: dict) -> int:
    """Model FLOPs of one image's forward pass."""
    return 2 * sum(layer_macs(model).values())


def gemm_stages(model: dict, rows: int, dtype: str
                ) -> Dict[str, Tuple[int, int]]:
    """{'mlp1', 'mlp2': (bytes, FLOPs)} of a sparse layer's two grouped
    products on rows images: the routed rows in, every expert's matrix,
    the products out (and the offsets)."""
    d, m, e = model["hidden"], model["mlp"], model["experts"]
    r = rows * tokens(model) * model["top_k"]
    ds = DTYPE_BYTES[dtype]
    flops = 2 * r * d * m
    return {"mlp1": ((r * d + e * d * m + r * m) * ds + e * INDEX_BYTES,
                     flops),
            "mlp2": ((r * m + e * m * d + r * d) * ds + e * INDEX_BYTES,
                     flops)}


def route_stages(model: dict, rows: int, dtype: str
                 ) -> Dict[str, Tuple[int, int]]:
    """{kernel: (bytes, FLOPs)} of a sparse layer's launches of the MoE
    kernels that move the rows (ops/moe.py) on rows images. FLOPs: the
    bias-GELU 1 + 14 an element (work_vit's exact GELU), the combine 3 an
    element a pair; the dispatch's are no arithmetic to count."""
    d, m, e, k = (model["hidden"], model["mlp"], model["experts"],
                  model["top_k"])
    t = rows * tokens(model)
    r = t * k
    ds, ix = DTYPE_BYTES[dtype], INDEX_BYTES
    blocks = -(-t // ROUTE_TOKENS)
    return {
        # u, top, ranks, bases in; xs, slots out
        "dispatch": (t * d * ds + 2 * r * ix + blocks * e * ix
                     + r * d * ds + r * ix, 0),
        # h, biases, offsets in; h out
        "bias_gelu": (2 * r * m * ds + e * m * ds + e * ix, 15 * r * m),
        # y, h, biases, top, gates, slots in; out
        "combine": (t * d * ds + r * d * ds + e * d * ds + 3 * r * ix
                    + t * d * ds, 3 * r * d),
    }
