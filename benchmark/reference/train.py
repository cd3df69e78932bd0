"""The training step, plainly: the reference's answer to the program's
first steps of fit_device's loop (models/train.py make_device_step).

Each step gathers its rows of the labelled table's endpoints, jitters
them (a shift of up to +-10 pixels an image and +-2 an endpoint, clamped
to the canvas), mirrors the columns when the step's flip is set, draws
the raster, and takes cross-entropy through the network with dropout
after fc6 and fc7; then the gradients are clipped to a global norm of
`clip` (summed in float64) and SGD with momentum 0.9 updates the
weights. The random draws come from a generator in the state the
program's had before its first step, in the program's order: the shift,
the endpoint jitter, then the fc6 and fc7 dropout masks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import alexnet, raster


def _jitter(ep: torch.Tensor, gen: torch.Generator, max_shift: int = 10,
            max_jitter: int = 2) -> torch.Tensor:
    n, s, _ = ep.shape
    shift = torch.randint(-max_shift, max_shift + 1, (n, 1, 2), generator=gen,
                          device=ep.device, dtype=ep.dtype)
    jit = torch.randint(-max_jitter, max_jitter + 1, (n, s, 4), generator=gen,
                        device=ep.device, dtype=ep.dtype)
    out = ep + shift.repeat(1, 1, 2) + jit
    return torch.clamp(out, 0, raster.CANVAS - 1).to(ep.dtype)


def steps(params0: Dict[str, torch.Tensor], specs: np.ndarray,
          labels: np.ndarray, idx: List[torch.Tensor],
          flip: List[torch.Tensor], gen_state: torch.Tensor, *, model: dict,
          learning_rate: float, keep_prob: float, clip: float,
          augment: bool = True, quant: Optional[Callable] = None,
          momentum0: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """Run len(idx) steps from params0 (TF-named, TF layouts, f32 on the
    card; not changed) and the momentum momentum0 (likewise; None before
    a first step). Returns {"losses": [float], "grad1": {leaf: norm of the
    first step's clipped gradient}, "delta": {leaf: norm of the weights'
    change after the last step}, "params", "momentum": {leaf: tensor}
    and "gen_state" after it}."""
    dev = next(iter(params0.values())).device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    ep_all, vis_all, rev_all = (torch.from_numpy(np.ascontiguousarray(a))
                                .to(dev) for a in raster.endpoints(specs))
    lab_all = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    momentum = {k: None if momentum0 is None else momentum0[k].clone()
                for k in p}
    out = {"losses": [], "grad1": {}, "delta": {}}

    def dropout(h):
        keep = torch.rand(h.shape, generator=gen, device=h.device) < keep_prob
        return torch.where(keep, h / keep_prob, 0.0)

    for i, (rows, fl) in enumerate(zip(idx, flip)):
        ep, vis, rev = ep_all[rows], vis_all[rows], rev_all[rows]
        if augment:
            ep = _jitter(ep, gen)
        mirrored = ep.clone()
        mirrored[..., 0::2] = raster.CANVAS - 1 - ep[..., 0::2]
        ep = torch.where(fl.to(dev), mirrored, ep)
        images = raster.normalize(raster.draw(ep, vis, rev))
        with alexnet.f32_exact():
            lg = alexnet.logits(p, images, model, quant=quant,
                                dropout=dropout)
            loss = F.cross_entropy(lg, lab_all[rows])
            grads = torch.autograd.grad(loss, list(p.values()))
        norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float64)
                             for g in grads])
        scale = torch.clamp(clip / torch.linalg.vector_norm(norms), max=1.0)
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                g = g * scale.to(g.dtype)
                if i == 0:
                    out["grad1"][k] = float(torch.linalg.vector_norm(
                        g, dtype=torch.float64))
                momentum[k] = (g.clone() if momentum[k] is None
                               else momentum[k] * 0.9 + g)
                w -= learning_rate * momentum[k]
        out["losses"].append(float(loss.detach()))
    with torch.no_grad():
        for k, w in p.items():
            out["delta"][k] = float(torch.linalg.vector_norm(
                w - params0[k], dtype=torch.float64))
    out["params"] = {k: w.detach() for k, w in p.items()}
    out["momentum"] = momentum
    out["gen_state"] = gen.get_state()
    return out
