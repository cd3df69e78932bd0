"""AlexNet classifier for similarity images, as a PyTorch nn.Module.

Counterpart of the JAX package's models/alexnet.py, with the same
architecture (reference src/network/alexnet.py:26-58):
  conv1 11x11x96 s4 VALID + ReLU -> maxpool 3x3 s2 VALID -> LRN(r=2, a=2e-5, b=0.75)
  conv2 5x5x256 s1 SAME groups=2 + ReLU -> maxpool -> LRN
  conv3 3x3x384 SAME + ReLU
  conv4 3x3x384 SAME groups=2 + ReLU
  conv5 3x3x256 SAME groups=2 + ReLU -> maxpool
  flatten(6*6*256, NHWC order) -> fc6 4096 + ReLU -> fc7 4096 + ReLU -> fc8 (logits)

Parameters arrive as the JAX package's flat dict keyed like the TF1
variable scopes ({layer}/weights HWIO or [in,out], {layer}/biases);
params_from_numpy carries them across (HWIO -> OIHW, [in,out] -> [out,in]).
Inside, activations run channels_last, so each conv output is already NHWC
for the bias/ReLU/pool/LRN kernel (ops/fused_pool_lrn.py), which takes the
place of those four ops after conv1 and conv2.

Precision follows the weights' dtype: f32 weights give the exact path,
bf16 weights (fold_params_bf16) the fast path with bf16 activations
between layers. Logits are f32 either way.

Class ids: 0=DEL 1=INS 2=INV 3=DUP 4=tDUP (predict.py:133-142).
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from svision_tpu_torch.device import resolve_device
from svision_tpu_torch.ops.fused_pool_lrn import bias_relu_pool_lrn, lrn

NUM_CLASSES = 5
INPUT_SIZE = 227
# Per-channel mean subtracted from images before the CNN (create_batch.py:13,150).
IMAGE_MEAN = (104.0, 117.0, 124.0)

# (name, kh, kw, out_ch, stride, padding, groups)
_CONV_SPECS = (
    ("conv1", 11, 11, 96, 4, "VALID", 1),
    ("conv2", 5, 5, 256, 1, "SAME", 2),
    ("conv3", 3, 3, 384, 1, "SAME", 1),
    ("conv4", 3, 3, 384, 1, "SAME", 2),
    ("conv5", 3, 3, 256, 1, "SAME", 2),
)
_FC_SPECS = (
    ("fc6", 6 * 6 * 256, 4096),
    ("fc7", 4096, 4096),
    ("fc8", 4096, NUM_CLASSES),
)

__all__ = ["AlexNet", "IMAGE_MEAN", "NUM_CLASSES", "cast_params_bf16",
           "fold_conv1_math", "image_mean",
           "fold_conv1_params", "fold_params_bf16", "init_params", "lrn",
           "params_from_numpy", "params_to_numpy", "space_to_depth"]


@functools.lru_cache(maxsize=None)
def image_mean(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """IMAGE_MEAN as a [3] tensor, made once per dtype and device: a copy
    from pageable host memory cannot be captured into a CUDA graph, and
    the eager calls that precede every capture make it. Made outside
    inference mode, so that autograd may save it too."""
    with torch.inference_mode(False):
        return torch.tensor(IMAGE_MEAN, dtype=dtype, device=device)


def init_params(seed: int = 0, num_classes: int = NUM_CLASSES) -> Dict[str, np.ndarray]:
    """He-init parameters with TF1-compatible names/shapes, from a numpy
    seed (the JAX package's init_params draws from jax.random, so the two
    give different weights for one seed)."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    in_ch = 3
    for name, kh, kw, out_ch, _, _, groups in _CONV_SPECS:
        fan_in = kh * kw * (in_ch // groups)
        w = rng.standard_normal((kh, kw, in_ch // groups, out_ch), np.float32)
        params[f"{name}/weights"] = w * np.float32(np.sqrt(2.0 / fan_in))
        params[f"{name}/biases"] = np.zeros((out_ch,), np.float32)
        in_ch = out_ch
    for name, n_in, n_out in _FC_SPECS:
        if name == "fc8":
            n_out = num_classes
        w = rng.standard_normal((n_in, n_out), np.float32)
        params[f"{name}/weights"] = w * np.float32(np.sqrt(2.0 / n_in))
        params[f"{name}/biases"] = np.zeros((n_out,), np.float32)
    return params


# ---------------------------------------------------------------------------
# conv1 fold: space-to-depth + input normalization (host numpy)
# ---------------------------------------------------------------------------
#
# A 4x4 space-to-depth transform re-expresses conv1 (11x11 stride 4 on 3
# channels) exactly as a 3x3 stride-1 conv over 48 channels, and the image
# normalization (raster {0,1} -> *255 -> minus IMAGE_MEAN) is affine, so it
# folds into conv1's weights and bias: the CNN then reads the {0,1} raster.

_S2D = 4          # space-to-depth factor == conv1 stride
_K1_PAD = 12      # conv1 kernel 11 padded to a multiple of the factor


def fold_conv1_math(w, b):
    """[11,11,3,96] -> [3,3,48,96] with the x255 scale folded in; the bias
    absorbs the IMAGE_MEAN shift (VALID conv: every tap sees a
    mean-subtracted pixel). Channel interleave is (c,p,q), the order of
    render_raster_s2d's channels.

    One implementation for numpy arrays (the host fold of inference) and
    torch tensors (the differentiable fold of models/train.py: it is linear
    in (w, b), so gradients reach the reference-space weights), so the two
    cannot drift. The weights come out bit-equal either way; the bias term
    is a 363-term contraction, which np.einsum sums in sequence and
    torch.einsum in another order, so the two biases differ by f32
    rounding."""
    if isinstance(w, torch.Tensor):
        mean = image_mean(w.dtype, w.device)
        b_fold = b - torch.einsum("hwco,c->o", w, mean)
        pad = _K1_PAD - w.shape[0]
        w_pad = F.pad(w * 255.0, (0, 0, 0, 0, 0, pad, 0, pad))
        permute = torch.permute
    else:
        mean = np.asarray(IMAGE_MEAN).astype(w.dtype)
        b_fold = b - np.einsum("hwco,c->o", w, mean)
        pad = _K1_PAD - w.shape[0]
        w_pad = np.pad(w * np.float32(255.0),
                       ((0, pad), (0, pad), (0, 0), (0, 0)))
        permute = np.transpose
    kh = _K1_PAD // _S2D
    # [12,12,3,96] -> [a,p,b,q,c,o] -> [a,b,(c,p,q),o] = [3,3,48,96]
    w_s2d = permute(w_pad.reshape(kh, _S2D, kh, _S2D, 3, w.shape[3]),
                    (0, 2, 4, 1, 3, 5)).reshape(kh, kh, _S2D * _S2D * 3,
                                                w.shape[3])
    return w_s2d, b_fold


def fold_conv1_params(params: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A params dict whose conv1 is the folded space-to-depth form; all
    other entries unchanged. Exact in f32 arithmetic."""
    w = np.asarray(params["conv1/weights"], np.float32)        # [11,11,3,96]
    b = np.asarray(params["conv1/biases"], np.float32)
    w_s2d, b_fold = fold_conv1_math(w, b)
    out = dict(params)
    out["conv1/weights"] = w_s2d
    out["conv1/biases"] = b_fold
    return out


def cast_params_bf16(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Pre-cast every leaf to the dtype the bf16 network reads it in --
    bf16 everywhere except fc8's bias, which stays f32 for the logits, as
    the JAX package's bf16 network casts them. torch's bf16 cast is
    round-to-nearest-even, so the result is bit-equal to the JAX package's
    ml_dtypes cast. Returns CPU tensors in the TF layouts."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if k == "fc8/biases"
                else torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16))
            for k, v in params.items()}


def fold_params_bf16(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Host-side preparation of the fast path: fold conv1, then
    cast_params_bf16."""
    return cast_params_bf16(
        fold_conv1_params({k: np.asarray(v) for k, v in params.items()}))


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC [N,227,227,C] -> [N,57,57,16C]: pad to 228 and fold 4x4 blocks
    into channels, ordered (c,p,q) as fold_conv1_params and
    render_raster_s2d order them. Contiguous."""
    n, h, w, c = x.shape
    hp = -h % _S2D
    x = F.pad(x, (0, 0, 0, hp, 0, hp))
    hh = (h + hp) // _S2D
    return (x.reshape(n, hh, _S2D, hh, _S2D, c).permute(0, 1, 3, 5, 2, 4)
            .reshape(n, hh, hh, _S2D * _S2D * c))


# ---------------------------------------------------------------------------
# Parameter layouts: TF names/HWIO -> torch state dict/OIHW
# ---------------------------------------------------------------------------

def params_from_numpy(params: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """The JAX package's params (numpy arrays or CPU tensors, TF names) ->
    an AlexNet state dict: conv HWIO -> OIHW, fc [in,out] -> [out,in]. fc6
    keeps its row order, because AlexNet flattens conv5's output in NHWC
    order as the JAX package does. dtypes are kept."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in params.items():
        layer, kind = key.split("/")
        t = torch.as_tensor(value)
        if kind == "weights":
            t = t.permute(3, 2, 0, 1) if layer.startswith("conv") else t.t()
            out[f"{layer}.weight"] = t.contiguous()
        else:
            out[f"{layer}.bias"] = t.contiguous()
    return out


def params_to_numpy(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of params_from_numpy: an AlexNet state dict (or its
    named parameters) -> TF-named contiguous numpy arrays, conv OIHW ->
    HWIO and fc [out,in] -> [in,out], which models/checkpoint.save_params
    writes as a checkpoint both packages read."""
    out: Dict[str, np.ndarray] = {}
    for key, t in state.items():
        layer, kind = key.split(".")
        t = t.detach().cpu()
        if kind == "weight":
            t = t.permute(2, 3, 1, 0) if layer.startswith("conv") else t.t()
            out[f"{layer}/weights"] = np.ascontiguousarray(t.numpy())
        else:
            out[f"{layer}/biases"] = np.ascontiguousarray(t.numpy())
    return out


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------

class AlexNet(nn.Module):
    """AlexNet over NHWC inputs. s2d=True makes conv1 the folded 3x3
    stride-1 conv over the [N,57,57,48] space-to-depth raster
    (fold_conv1_params); its weights are then read by the fused raster+conv1
    kernel too (conv1_weight_hwio)."""

    def __init__(self, num_classes: int = NUM_CLASSES, s2d: bool = False):
        super().__init__()
        self.s2d = s2d
        if s2d:
            self.conv1 = nn.Conv2d(3 * _S2D * _S2D, 96, 3)
        else:
            self.conv1 = nn.Conv2d(3, 96, 11, stride=4)
        self.conv2 = nn.Conv2d(96, 256, 5, padding=2, groups=2)
        self.conv3 = nn.Conv2d(256, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 384, 3, padding=1, groups=2)
        self.conv5 = nn.Conv2d(384, 256, 3, padding=1, groups=2)
        self.fc6 = nn.Linear(6 * 6 * 256, 4096)
        self.fc7 = nn.Linear(4096, 4096)
        self.fc8 = nn.Linear(4096, num_classes)

    @classmethod
    def from_params(cls, params: Mapping[str, object], *, s2d: bool = False,
                    device=None) -> "AlexNet":
        """Build from TF-named params (params_from_numpy's input) without
        a random init; tensors keep their dtypes (f32, or fold_params_bf16's
        bf16 with an f32 fc8 bias). Conv weights go channels_last. The
        model lies on the card unless device asks for the CPU
        (resolve_device)."""
        state = params_from_numpy(params)
        with torch.device("meta"):
            model = cls(num_classes=state["fc8.bias"].shape[0], s2d=s2d)
        model.load_state_dict(state, assign=True)
        model.to(resolve_device(device))
        for name, _, _, _, _, _, _ in _CONV_SPECS:
            conv = getattr(model, name)
            conv.weight.data = conv.weight.data.contiguous(
                memory_format=torch.channels_last)
        return model.eval().requires_grad_(False)

    @classmethod
    def trainable(cls, params: Mapping[str, object],
                  device=None) -> "AlexNet":
        """The network as training holds it: f32 nn.Parameters that
        require grad, in reference space (conv1 stays [96,3,11,11]; the s2d
        trainer folds it inside its forward), copied from params, so the
        caller's arrays are never updated in place. Train mode, on the card
        unless device asks for the CPU."""
        copied = {k: torch.from_numpy(np.array(v, dtype=np.float32))
                  for k, v in params.items()}
        model = cls.from_params(copied, device=device)
        return model.train().requires_grad_(True)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.conv2.weight.dtype

    def conv1_weight_hwio(self) -> torch.Tensor:
        """conv1's weights in the JAX layout [kh,kw,in,out], contiguous."""
        return self.conv1.weight.permute(2, 3, 1, 0).contiguous()

    @staticmethod
    def _conv(layer: nn.Conv2d, h: torch.Tensor, bias: bool = True):
        return F.conv2d(h, layer.weight, layer.bias if bias else None,
                        layer.stride, layer.padding, 1, layer.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits f32 [N,5] from NHWC [N,227,227,3] mean-subtracted images
        (s2d=False), or from the NHWC [N,57,57,48] s2d raster (s2d=True)."""
        h = x.to(self.compute_dtype).permute(0, 3, 1, 2)    # channels_last
        pre = self._conv(self.conv1, h, bias=False)
        return self.forward_conv1(pre.permute(0, 2, 3, 1))

    forward_s2d = forward

    def forward_raster(self, raster: torch.Tensor) -> torch.Tensor:
        """Logits f32 [N,5] from a {0,1} raster NHWC [N,227,227,3] (s2d=True):
        space_to_depth, then the folded network. The same as
        forward(raster*255 - IMAGE_MEAN) on the unfolded weights, up to the
        fold's f32 rounding."""
        return self.forward(space_to_depth(raster.to(self.compute_dtype)))

    # forward_conv1's stages in order, each by the layers whose weights it
    # holds (scripts/torch_roofline.py times their prefixes)
    STAGE_LAYERS = (("conv1",), ("conv2",), ("conv3",), ("conv4",),
                    ("conv5",), ("fc6", "fc7", "fc8"))

    def stages(self):
        """forward_conv1's stages, one per STAGE_LAYERS entry, in order:
        each takes the previous stage's output."""
        return (self._conv1_block, self._conv2_block, self._conv3,
                self._conv4, self._conv5_pool, self._head)

    def forward_conv1(self, pre: torch.Tensor,
                      n_stages: Optional[int] = None) -> torch.Tensor:
        """Logits from conv1's pre-activation, NHWC [N,55,55,96] (what the
        fused raster+conv1 kernel emits): the rest of the network; or,
        given n_stages, the output of its first n_stages stages."""
        h = pre
        for stage in self.stages()[:n_stages]:
            h = stage(h)
        return h

    def _conv1_block(self, pre):
        return bias_relu_pool_lrn(pre, self.conv1.bias)         # [N,27,27,96]

    def _conv2_block(self, h):
        h = self._conv(self.conv2, h.permute(0, 3, 1, 2), bias=False)
        h = bias_relu_pool_lrn(h.permute(0, 2, 3, 1), self.conv2.bias)
        return h.permute(0, 3, 1, 2)                            # [N,256,13,13]

    def _conv3(self, h):
        return torch.relu(self._conv(self.conv3, h))

    def _conv4(self, h):
        return torch.relu(self._conv(self.conv4, h))

    def _conv5_pool(self, h):
        return F.max_pool2d(torch.relu(self._conv(self.conv5, h)), 3, 2)

    def _head(self, h):
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)       # NHWC flatten
        h = torch.relu(self.fc6(h))
        h = torch.relu(self.fc7(h))
        # fc8 in f32: bf16 products are exact in f32, so this is the bf16
        # GEMM with f32 accumulation and f32 logits
        return F.linear(h.float(), self.fc8.weight.float(),
                        self.fc8.bias.float())
