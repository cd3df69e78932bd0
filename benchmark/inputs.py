"""The network's weights, made from the seed on the card.

One torch.Generator on the device and one randn call over every leaf:
He-normal weights (std sqrt(2 / fan_in)), zero biases. Then each layer is
fitted to the traffic in order, as a trained network's layers are
normalized: on `head_images` images of the traffic's geometry, drawn from
the seed, the reference's pre-activation of each output channel is
centred by its bias, and the last layer's logits are scaled to the
standard deviation `logit_std`. The weights keep their He scale, so the
gradients of training fall on the layers as they would.

Without the fit, a deep ReLU network with random weights maps every
image to nearly the same hidden vector: its class is the same for every
image at a softmax of 1.0, and what tells images apart is a small
difference of large numbers, so the rounding of any precision swamps it.
With it, the background of an image (most of its pixels) maps to about
zero, the classes split the images, and the softmax spreads.

Leaves are TF-named in TF layouts (conv HWIO, fc [in, out]): the layout
both the program and the reference take. The same seed gives the same
weights.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark import traffic


def leaves(model: dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """[(TF name, shape, fan_in)] of the configuration's network."""
    out = []
    cin = model["input_channels"]
    for name, kh, kw, cout, _, _, groups in model["conv"]:
        fan_in = kh * kw * (cin // groups)
        out.append((f"{name}/weights", (kh, kw, cin // groups, cout), fan_in))
        out.append((f"{name}/biases", (cout,), 0))
        cin = cout
    for name, n_in, n_out in model["fc"]:
        out.append((f"{name}/weights", (n_in, n_out), n_in))
        out.append((f"{name}/biases", (n_out,), 0))
    return out


def params(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{TF name: f32 tensor on device} from the seed."""
    shapes = leaves(model)
    sizes = [torch.Size(s).numel() for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(
        traffic.torch_seed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out = {}
    for (name, shape, fan_in), part in zip(shapes, flat.split(sizes)):
        out[name] = (part.view(shape).mul_((2.0 / fan_in) ** 0.5) if fan_in
                     else part.view(shape).zero_())
    _fit(out, model, seed)
    return out


def _fit(p: Dict[str, torch.Tensor], model: dict, seed: int) -> None:
    """Set each layer's biases in place, in order, so that on the seed's
    head images every channel's pre-activation has mean 0, and scale the
    last layer's output channels to standard deviation
    model["logit_std"]; float32, TF32 off."""
    from benchmark.reference import alexnet, raster
    dev = next(iter(p.values())).device
    specs = traffic.GEOMETRIES[model["head_geometry"]](
        model["head_images"], traffic.rng(seed, "head"))
    last = model["fc"][-1][0]

    def fit(name, pre):
        dims = (0, 2, 3) if pre.dim() == 4 else (0,)
        mean, std = pre.mean(dim=dims), pre.std(dim=dims)
        scale = (model["logit_std"] / std if name == last
                 else torch.ones_like(std))
        w, b = p[f"{name}/weights"], p[f"{name}/biases"]
        w.mul_(scale)
        b.sub_(mean).mul_(scale)
        view = (1, -1) + (1,) * (pre.dim() - 2)
        return (pre - mean.view(view)) * scale.view(view)

    with torch.no_grad(), alexnet.f32_exact():
        alexnet.logits(p, raster.images(specs, dev), model, fit=fit)


def host(p: Dict[str, torch.Tensor]):
    """The same leaves as numpy arrays, the form the program's
    constructors take."""
    return {k: v.cpu().numpy() for k, v in p.items()}


def device(p, dev) -> Dict[str, torch.Tensor]:
    """numpy leaves (host()) back on a device."""
    return {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
