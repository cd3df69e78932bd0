"""Operations and bytes of the ViT configurations (configs/*vit*.json),
counted from the configuration's widths, whatever implements them;
work.py counts AlexNet's and holds the peaks and least_s.

A model FLOP is 2 x a multiply-accumulate of the reference network: the
patch embedding (the VALID grid of patch x patch x channels), per layer
q k v, q k^T and the softmax times v over every head, the output
projection and both MLP layers, then the head on the class token.
LayerNorm, GELU, softmax and the residual adds are not counted, as the
pools and LRN are not for AlexNet.

A launch's bytes read each input once and write each output once, in the
compute dtype, at the engine's rows a launch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.work import DTYPE_BYTES


def tokens(model: dict) -> int:
    """The class token and a token a patch of the VALID grid."""
    g = model["input_size"] // model["patch"]
    return g * g + 1


def layer_macs(model: dict) -> Dict[str, int]:
    """{matmul: multiply-accumulates an image}, the layers' summed."""
    d, m, L = model["hidden"], model["mlp"], model["layers"]
    t, k = tokens(model), model["patch"]
    return {"patch": (t - 1) * k * k * model["input_channels"] * d,
            "qkv": L * t * d * 3 * d,
            "qk": L * t * t * d,
            "pv": L * t * t * d,
            "out": L * t * d * d,
            "mlp1": L * t * d * m,
            "mlp2": L * t * m * d,
            "head": d * model["classes"]}


def inference_flops(model: dict) -> int:
    """Model FLOPs of one image's forward pass."""
    return 2 * sum(layer_macs(model).values())


def attn_stage(model: dict, rows: int, dtype: str) -> Tuple[int, int]:
    """(bytes, FLOPs) of one layer's attention launch on rows images: q, k
    and v in, the heads' outputs out; q k^T and the softmax times v."""
    t, d = tokens(model), model["hidden"]
    return 4 * rows * t * d * DTYPE_BYTES[dtype], 4 * rows * t * t * d


def norm_act_stages(model: dict, rows: int, dtype: str
                    ) -> Dict[str, List[Tuple[int, int]]]:
    """{kind: [(bytes, FLOPs) of each launch a batch]} of the memory-bound
    launches between the matmuls: 'ln' the two LayerNorms a layer and
    the last one (on the class token only), 'gelu' one a layer, 'add' the
    two residual adds a layer and the positions' add. FLOPs: 8 an element
    of a LayerNorm, 14 of an exact GELU, 1 of an add."""
    t, d, m, L = tokens(model), model["hidden"], model["mlp"], model["layers"]
    ds = DTYPE_BYTES[dtype]
    act = rows * t * d

    def ln(n):
        return ((2 * n + 2 * d) * ds, 8 * n)
    return {"ln": [ln(act)] * (2 * L) + [ln(rows * d)],
            "gelu": [(2 * rows * t * m * ds, 14 * rows * t * m)] * L,
            "add": [(3 * act * ds, act)] * (2 * L)
            + [((2 * act + t * d) * ds, act)]}
