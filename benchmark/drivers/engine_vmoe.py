"""Driver: the inference engine on V-MoE weights, over a 'calls' mix. The
ViT's driver (engine_vit.py) as it is, but for the weights, the fit, the
reference and one counter: the engine reads the network from the weights'
leaf names (svision_tpu_torch/models/vit.py: routers make a V-MoE) and
runs K1's raster into it, its sparse layers through ops/moe.py.

weights  made on the card from the seed: the ViT's leaves in
         torchvision's vit_b_16 scales, each sparse layer's MLP replaced
         by a router [hidden, E] and E experts (params()), then fitted to
         the traffic (fit()).
check    a sample of the window's answers against the plain V-MoE
         (reference/vmoe.py) in f32, TF32 off, in blocks of 1,024 rows.
         A token whose second and third experts' gates lie near each
         other takes either in bf16, and a random expert's MLP then moves
         the image's answer by up to a whole class: with the reference's
         own routing everywhere, 1-1.5% of sound rows lie more than 0.2
         below the reference's best in its softmax (8,192-row samples of
         3 seeds on the card), more than a fault that alters one answer a
         batch (0.8% of rows) adds. So the reference reads the program's
         routing (the experts each sampled image's tokens take in each
         sparse layer, from the engine's expert_choices(), an eager pass
         read before the engine is released) and takes the program's
         experts for a token only on a near-tie: where their gate mass
         falls short of its own top-k mass by at most TIE; elsewhere it
         takes its own top k; the gates are always its own. The readings:
           argmax_gap, softmax_err, softmax_err_mean  engine.readings of
               the window's answers against that reference's logits;
           route_miss_mean, route_miss_max  over every token and sparse
               layer, the reference's own top-k gate mass less its gate
               mass at the program's experts (0 where the program took
               the reference's top k; a near-tie gives almost 0, a wrong
               expert the gap to it). route_miss_max's limit is TIE: a
               token routed past it fails the run, and the reference has
               computed it with its own experts.
         A program whose routing cannot be read for every sampled row
         reads inf. The class split of the sampled rows goes to standard
         error.
control  'fp8': the reference with every matmul's inputs rounded through
         float8 e4m3, its own routing with it, in the program's place;
         'top1': the reference with each token's second expert left out,
         in the program's place (its routing is each token's first
         expert).
counter  the engine's expert_rows() (moe.expert_rows/<layer>/<expert>
         while the program's recorder is on) is read at the end of the
         window and of each slice, outside every call and the timed
         window, so that a slice's read holds that slice's rows alone.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import inputs, traffic
from benchmark.drivers import engine, engine_vit
from benchmark.reference import alexnet as ref_alexnet
from benchmark.reference import raster as ref_raster
from benchmark.reference import vmoe as ref_vmoe

REF_BLOCK = engine_vit.REF_BLOCK
# the gate mass a token's given experts may fall short of the reference's
# own top k and still be taken (a near-tie), and route_miss_max's limit
# (limits/vmoe-b16.genome.json): 15 sound seeds read at most 0.070 (bf16's
# drift through the layers before a router), the top1 control 0.48 or more
TIE = 0.2
READINGS = ("argmax_gap", "softmax_err", "softmax_err_mean",
            "route_miss_mean", "route_miss_max")


def leaves(model: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """[(leaf name, shape, init)] of the configuration's V-MoE, in the
    program's names and layouts: engine_vit.leaves with each sparse layer's
    mlp1 and mlp2 replaced by its router ('xavier') and its experts'
    weights ('experts': Xavier-uniform over each expert's own fans) and
    biases ('tiny')."""
    d, m, e = model["hidden"], model["mlp"], model["experts"]
    sparse = {f"vit/layer{i}" for i in model["moe_layers"]}
    out = []
    for name, shape, init in engine_vit.leaves(model):
        at = name.rsplit("/", 2)[0]
        if at not in sparse or "/mlp" not in name:
            out.append((name, shape, init))
        elif name.endswith("/mlp1/weights"):
            out += [(f"{at}/router/weights", (d, e), "xavier"),
                    (f"{at}/experts/mlp1/weights", (e, d, m), "experts"),
                    (f"{at}/experts/mlp1/biases", (e, m), "tiny"),
                    (f"{at}/experts/mlp2/weights", (e, m, d), "experts"),
                    (f"{at}/experts/mlp2/biases", (e, d), "tiny")]
    return out


def params(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{leaf name: f32 tensor on device} from the seed, fitted; vit/heads
    and vit/top_k hold the head count and k. The same seed gives the same
    weights."""
    gen = torch.Generator(device=device).manual_seed(
        traffic.torch_seed(seed, "weights"))
    out = {}
    for name, shape, init in leaves(model):
        t = torch.empty(shape, device=device, dtype=torch.float32)
        if init == "patch":
            std = 1.0 / math.sqrt(shape[0] * shape[1] * shape[2])
            torch.nn.init.trunc_normal_(t, std=std, a=-2.0, b=2.0,
                                        generator=gen)
        elif init in ("xavier", "experts"):
            bound = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            t.uniform_(-bound, bound, generator=gen)
        elif init == "linear":
            bound = 1.0 / math.sqrt(shape[0])
            t.uniform_(-bound, bound, generator=gen)
        elif init in ("pos", "tiny"):
            t.normal_(0.0, 0.02 if init == "pos" else 1e-6, generator=gen)
        else:
            t.fill_(1.0 if init == "one" else 0.0)
        out[name] = t
    fit(out, model, seed)
    for name in ("heads", "top_k"):
        out[f"vit/{name}"] = torch.tensor(model[name], dtype=torch.int64,
                                          device=device)
    return out


def gate_scale(logits: torch.Tensor, k: int, mass: float) -> float:
    """The scale s at which the mean over tokens of the top-k mass of
    softmax(s logits) is `mass`: bisection on log s (the mass grows from
    k / E at s = 0 towards 1)."""
    lo, hi = -12.0, 12.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        got = torch.softmax(logits * math.exp(mid), dim=-1).topk(
            k, dim=-1).values.sum(-1).mean()
        lo, hi = (mid, hi) if float(got) < mass else (lo, mid)
    return math.exp(0.5 * (lo + hi))


def fit(p: Dict[str, torch.Tensor], model: dict, seed: int) -> None:
    """Fit the weights in place to the traffic, as engine_vit.fit fits the
    ViT's (the patch embedding's channels centred and of std 1, the logits
    centred and of std logit_std), and between the two, in layer order,
    each router scaled so that the mean top-k gate mass over the seed's
    head images' tokens is model["gate_mass"]; f32, TF32 off."""
    dev = p["vit/cls"].device
    specs = traffic.GEOMETRIES[model["head_geometry"]](
        model["head_images"], traffic.rng(seed, "head"))

    def step(name, pre):
        if name.endswith("/router"):
            s = gate_scale(pre, model["top_k"], model["gate_mass"])
            p[f"{name}/weights"].mul_(s)
            return pre * s
        flat = pre.reshape(-1, pre.shape[-1])
        mean, std = flat.mean(dim=0), flat.std(dim=0)
        scale = (model["logit_std"] if name == "vit/head" else 1.0) / std
        p[f"{name}/weights"].mul_(scale)
        p[f"{name}/biases"].sub_(mean).mul_(scale)
        return (pre - mean) * scale

    with torch.no_grad(), ref_alexnet.f32_exact():
        images = torch.cat([ref_raster.images(specs[i:i + REF_BLOCK], dev)
                            for i in range(0, len(specs), REF_BLOCK)])
        ref_vmoe.logits(p, images, model, fit=step)


class Driver(engine_vit.Driver):
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
        self.engine.expert_rows()
        self.phases["largest_call"] = time.perf_counter() - t

    def window(self, seconds: float) -> dict:
        out = super().window(seconds)
        self.engine.expert_rows()
        return out

    def slice(self) -> None:
        super().slice()
        self.engine.expert_rows()

    def release(self) -> None:
        """Read the program's routing of the rows the check samples, then
        free the program."""
        specs, _, _ = self.sample()
        self.routing = self.engine.expert_choices(specs)
        super().release()

    def reference_logits(self, specs: np.ndarray,
                         quant: Optional[Callable] = None,
                         top1: bool = False,
                         routing: Optional[List[np.ndarray]] = None,
                         routed: Optional[list] = None) -> torch.Tensor:
        """The reference's f32 logits of specs, TF32 off; quant rounds each
        matmul's inputs, top1 keeps each token's first expert alone (the
        controls); routing, if given, the experts [N, tokens, k'] the
        program gave each token in each sparse layer, taken within TIE;
        routed, if given, gains for each sparse layer those experts (the
        reference's own without routing) and their gate mass's shortfall
        below the reference's own top k [N, tokens] (reference/vmoe.py)."""
        dev = self.devices[0]
        p = {k: torch.from_numpy(v).to(dev).float()
             for k, v in self.params.items()
             if k not in ("vit/heads", "vit/top_k")}
        out, seen = [], []
        with torch.no_grad(), ref_alexnet.f32_exact():
            for i in range(0, len(specs), REF_BLOCK):
                x = ref_raster.images(specs[i:i + REF_BLOCK], dev)
                block = None if routing is None else [
                    torch.from_numpy(r[i:i + REF_BLOCK]).to(dev).long()
                    .reshape(-1, r.shape[2]) for r in routing]
                out.append(ref_vmoe.logits(p, x, self.model, quant,
                                           top1=top1, routing=block,
                                           routed=seen, tie=TIE))
        if routed is not None:
            layers, n = len(self.model["moe_layers"]), len(specs)
            for j in range(layers):
                experts = torch.cat([e for e, _ in seen[j::layers]])
                short = torch.cat([s for _, s in seen[j::layers]])
                routed.append((experts.view(n, -1, experts.shape[1]),
                               short.view(n, -1)))
        return torch.cat(out)

    def readings(self, specs: np.ndarray, preds: np.ndarray,
                 softs: np.ndarray, routing: Optional[List[np.ndarray]]
                 ) -> Dict[str, float]:
        """READINGS of answers (preds, softs) to specs that came with this
        routing (module docstring)."""
        if routing is None or any(r.shape[0] != len(specs) for r in routing):
            return dict.fromkeys(READINGS, math.inf)
        seen = []
        out = engine.readings(self.reference_logits(specs, routing=routing,
                                                    routed=seen),
                              preds, softs)
        short = torch.cat([s.reshape(-1) for _, s in seen])
        out["route_miss_mean"] = float(short.mean())
        out["route_miss_max"] = float(short.max())
        return out

    def check(self) -> Dict[str, float]:
        specs, preds, softs = self.sample()
        split = (np.bincount(preds, minlength=self.model["classes"])
                 / len(preds))
        print("class split of the checked rows: "
              + " ".join(f"{s:.4f}" for s in split), file=sys.stderr)
        return self.readings(specs, preds, softs, self.routing)

    def control_check(self, control: str) -> Dict[str, float]:
        """The readings of a control in the program's place, on the rows
        the window's sample draws, with the control's own routing: 'fp8',
        the reference with every matmul's inputs rounded through float8
        e4m3; 'top1', the reference with each token's second expert left
        out."""
        if control not in ("fp8", "top1"):
            raise ValueError(f"no reference control {control!r}")
        specs, _, _ = self.sample()
        own = []
        lg = self.reference_logits(
            specs, ref_alexnet.fp8 if control == "fp8" else None,
            top1=control == "top1", routed=own)
        pr = torch.softmax(lg, dim=1)
        return self.readings(specs, pr.argmax(1).cpu().numpy(),
                             pr.max(1).values.float().cpu().numpy(),
                             [e.cpu().numpy() for e, _ in own])
