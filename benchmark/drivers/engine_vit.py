"""Driver: the inference engine on ViT weights, over a 'calls' mix. The
engine driver (engine.py) as it is, but for the weights and the
reference: the engine reads the network from the weights' leaf names
(svision_tpu_torch/models/vit.py) and runs K1's raster into the ViT.

weights  made on the card from the seed, in torchvision's vit_b_16
         scales (params()), then fitted to the traffic (fit()).
check    a sample of the window's answers against the plain ViT
         (reference/vit.py) in f32, TF32 off, in blocks of 1,024 rows;
         the class split of the sampled rows goes to standard error.
control  'fp8': the reference with every matmul's inputs rounded through
         float8 e4m3 in the program's place.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import inputs, traffic
from benchmark.drivers import engine
from benchmark.reference import alexnet as ref_alexnet
from benchmark.reference import raster as ref_raster
from benchmark.reference import vit as ref_vit

REF_BLOCK = 1024


def leaves(model: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """[(leaf name, shape, init)] of the configuration's ViT, in the
    program's names and layouts. init: 'patch' truncated normal of std
    sqrt(1 / fan_in) cut at +-2, 'xavier' Xavier-uniform, 'linear'
    uniform in +-1 / sqrt(fan_in), 'pos' normal of std 0.02, 'tiny' normal
    of std 1e-6, 'one', 'zero'."""
    d, m, k = model["hidden"], model["mlp"], model["patch"]
    g = model["input_size"] // k
    out = [("vit/patch/weights", (k, k, model["input_channels"], d), "patch"),
           ("vit/patch/biases", (d,), "zero"), ("vit/cls", (d,), "zero"),
           ("vit/pos", (g * g + 1, d), "pos")]
    for i in range(model["layers"]):
        at = f"vit/layer{i}"
        out += [(f"{at}/ln1/scale", (d,), "one"),
                (f"{at}/ln1/bias", (d,), "zero"),
                (f"{at}/qkv/weights", (d, 3 * d), "xavier"),
                (f"{at}/qkv/biases", (3 * d,), "zero"),
                (f"{at}/out/weights", (d, d), "linear"),
                (f"{at}/out/biases", (d,), "zero"),
                (f"{at}/ln2/scale", (d,), "one"),
                (f"{at}/ln2/bias", (d,), "zero"),
                (f"{at}/mlp1/weights", (d, m), "xavier"),
                (f"{at}/mlp1/biases", (m,), "tiny"),
                (f"{at}/mlp2/weights", (m, d), "xavier"),
                (f"{at}/mlp2/biases", (d,), "tiny")]
    out += [("vit/ln/scale", (d,), "one"), ("vit/ln/bias", (d,), "zero"),
            ("vit/head/weights", (d, model["classes"]), "xavier"),
            ("vit/head/biases", (model["classes"],), "zero")]
    return out


def params(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{leaf name: f32 tensor on device} from the seed, fitted; vit/heads
    holds the head count. The same seed gives the same weights."""
    gen = torch.Generator(device=device).manual_seed(
        traffic.torch_seed(seed, "weights"))
    out = {}
    for name, shape, init in leaves(model):
        t = torch.empty(shape, device=device, dtype=torch.float32)
        if init == "patch":
            std = 1.0 / math.sqrt(shape[0] * shape[1] * shape[2])
            torch.nn.init.trunc_normal_(t, std=std, a=-2.0, b=2.0,
                                        generator=gen)
        elif init == "xavier":
            torch.nn.init.xavier_uniform_(t, generator=gen)
        elif init == "linear":
            bound = 1.0 / math.sqrt(shape[0])
            t.uniform_(-bound, bound, generator=gen)
        elif init in ("pos", "tiny"):
            t.normal_(0.0, 0.02 if init == "pos" else 1e-6, generator=gen)
        else:
            t.fill_(1.0 if init == "one" else 0.0)
        out[name] = t
    fit(out, model, seed)
    out["vit/heads"] = torch.tensor(model["heads"], dtype=torch.int64,
                                    device=device)
    return out


def fit(p: Dict[str, torch.Tensor], model: dict, seed: int) -> None:
    """Fit the weights in place to the traffic, as inputs.py fits
    AlexNet's: on the seed's head images, in f32 with TF32 off, the patch
    embedding's channels centred to mean 0 and scaled to std 1 over every
    patch (torchvision's init assumes inputs of unit variance; SVision's
    normalised images, mostly dark, give a large channel offset common to
    every image), then the logits centred and scaled to std
    model["logit_std"], so that the classes split the images."""
    dev = p["vit/cls"].device
    specs = traffic.GEOMETRIES[model["head_geometry"]](
        model["head_images"], traffic.rng(seed, "head"))

    def step(name, pre):
        flat = pre.reshape(-1, pre.shape[-1])
        mean, std = flat.mean(dim=0), flat.std(dim=0)
        scale = (model["logit_std"] if name == "vit/head" else 1.0) / std
        p[f"{name}/weights"].mul_(scale)
        p[f"{name}/biases"].sub_(mean).mul_(scale)
        return (pre - mean) * scale

    with torch.no_grad(), ref_alexnet.f32_exact():
        out = []
        for i in range(0, len(specs), REF_BLOCK):
            out.append(ref_raster.images(specs[i:i + REF_BLOCK], dev))
        ref_vit.logits(p, torch.cat(out), model, fit=step)


class Driver(engine.Driver):
    def setup(self) -> None:
        from svision_tpu_torch.infer.engine import InferenceEngine
        t = time.perf_counter()
        self.calls = traffic.calls(self.mix, self.seed)
        self.phases["traffic"] = time.perf_counter() - t
        self.params = inputs.host(params(self.model, self.seed,
                                         self.devices[0]))
        self.phases["weights"] = time.perf_counter() - t
        e = self.engine_cfg
        self.engine = InferenceEngine(
            self.params, batch_size=e["batch_size"],
            bf16=e["precision"] == "bfloat16", chunk=e["chunk"],
            tail=e["tail"], raster=e["raster"], device=self.devices[0],
            devices=self.devices if len(self.devices) > 1 else None)
        self.phases["engine"] = time.perf_counter() - t
        self.engine.warmup()
        self.phases["warmup"] = time.perf_counter() - t
        largest = max(self.calls, key=lambda c: len(c[1]))[1]
        self.engine.predict_specs(largest)
        self.phases["largest_call"] = time.perf_counter() - t

    def reference_logits(self, specs: np.ndarray,
                         quant: Optional[Callable] = None) -> torch.Tensor:
        """The reference's f32 logits of specs, TF32 off; quant rounds each
        matmul's inputs (a control)."""
        dev = self.devices[0]
        p = {k: v.float() for k, v in inputs.device(self.params, dev).items()
             if k != "vit/heads"}
        out = []
        with torch.no_grad(), ref_alexnet.f32_exact():
            for i in range(0, len(specs), REF_BLOCK):
                x = ref_raster.images(specs[i:i + REF_BLOCK], dev)
                out.append(ref_vit.logits(p, x, self.model, quant))
        return torch.cat(out)

    def check(self) -> Dict[str, float]:
        specs, preds, softs = self.sample()
        split = (np.bincount(preds, minlength=self.model["classes"])
                 / len(preds))
        print("class split of the checked rows: "
              + " ".join(f"{s:.4f}" for s in split), file=sys.stderr)
        return engine.readings(self.reference_logits(specs), preds, softs)

    def control_check(self, control: str) -> Dict[str, float]:
        """The readings of the reference with every matmul's inputs rounded
        through float8 e4m3 ('fp8') in the program's place, on the rows the
        window's sample draws."""
        if control != "fp8":
            raise ValueError(f"no reference control {control!r}")
        specs, _, _ = self.sample()
        p = torch.softmax(self.reference_logits(specs, ref_alexnet.fp8), dim=1)
        return engine.readings(self.reference_logits(specs),
                               p.argmax(1).cpu().numpy(),
                               p.max(1).values.float().cpu().numpy())
