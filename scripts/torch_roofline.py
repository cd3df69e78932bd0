"""Roofline breakdown of the PyTorch port's default engine step on the card.

The port of scripts/roofline.py. It times cumulative prefixes of the
default engine's step (bf16, raster 's2d': InferenceEngine._step) with its
inputs on the device, each prefix captured once as its own CUDA graph and
its replays timed with CUDA events while the queue is held
(svision_tpu_torch.timing.graph_ms), so a section's cost is the
difference between two prefixes (AlexNet.stages(), the stages the step
itself runs):
  raster            the plain space-to-depth raster (render_raster_s2d)
  +conv1blk         K3 (raster fused into conv1), then K2
  +conv2blk         conv2 (cuDNN), then K2
  +conv3, +conv4    cuDNN convolution + ReLU
  +conv5+pool       cuDNN convolution + ReLU + max-pool
  +fc/head (full)   fc6-8, argmax and max softmax: the whole step
(K3 renders its own raster, so "+conv1blk" does not contain "raster".)

FLOPs are counted in closed form, 2 x the multiply-accumulates of every
conv and fc layer of the reference network (conv1 as 11x11x3 at 55x55),
and read against the card's bf16 dense tensor-core peak; bytes are the
least a prefix must move (its inputs and weights read once, its output
written once) against the HBM rate. The whole step's FLOPs per image are
printed too.

    python scripts/torch_roofline.py [--batch 1024] [--reps 20]
        [--device cuda|cpu] [--peak-flops F --hbm-bw B]

The card's peaks are named below for the "NVIDIA H100 80GB HBM3" (SXM5);
for any other name nvidia-smi prints, --peak-flops and --hbm-bw are
required. Without a GPU it raises unless given --device cpu, where times
are host-clock means and no share is given. Prints one JSON line per
prefix, then one summary line.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# NVIDIA H100 datasheet, SXM5: 1,979 TFLOP/s bf16 with sparsity, half that
# dense; 3.35 TB/s HBM3
PEAKS = {"NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12)}

# (label, how many of AlexNet.stages() follow K3; 0: the plain raster)
STAGES = (("raster", 0), ("+conv1blk", 1), ("+conv2blk", 2), ("+conv3", 3),
          ("+conv4", 4), ("+conv5+pool", 5), ("+fc/head (full)", 6))


def layer_macs():
    """{layer: multiply-accumulates per image} of the reference network,
    from alexnet's layer specs: conv1 11x11 stride 4 VALID on 227x227x3,
    3x3/2 max-pools after conv1, conv2 and conv5, the others SAME."""
    from svision_tpu_torch.models.alexnet import (INPUT_SIZE, _CONV_SPECS,
                                                  _FC_SPECS)
    macs = {}
    size, cin = INPUT_SIZE, 3
    for name, kh, kw, cout, stride, padding, groups in _CONV_SPECS:
        if padding == "VALID":
            size = (size - kh) // stride + 1
        macs[name] = size * size * cout * kh * kw * (cin // groups)
        if name in ("conv1", "conv2", "conv5"):
            size = (size - 3) // 2 + 1
        cin = cout
    for name, n_in, n_out in _FC_SPECS:
        macs[name] = n_in * n_out
    return macs


def stage_layers(n_stages):
    """The layers a prefix of n_stages stages runs (AlexNet.STAGE_LAYERS)."""
    from svision_tpu_torch.models.alexnet import AlexNet
    return [k for layers in AlexNet.STAGE_LAYERS[:n_stages] for k in layers]


def stage_flops(n_stages):
    """FLOPs per image of a prefix: 2 x its layers' MACs."""
    macs = layer_macs()
    return sum(2 * macs[k] for k in stage_layers(n_stages))


def build_prefix(model, w_s2d, n_stages):
    """fn(ep, vis, rev) -> the prefix's output: the plain raster for 0;
    else the default engine's step, K3 then the first n_stages of
    AlexNet.forward_conv1's stages, and with all of them the step's
    (argmax, max softmax)."""
    import torch
    from svision_tpu_torch.ops import rasterize
    from svision_tpu_torch.ops.fused_conv1 import conv1_fused_raster
    full = n_stages == len(model.stages())

    def run(ep, vis, rev):
        if n_stages == 0:
            return rasterize.render_raster_s2d(ep, vis, rev)
        h = model.forward_conv1(conv1_fused_raster(ep, vis, rev, w_s2d),
                                n_stages)
        if full:
            return h.argmax(dim=1), torch.softmax(h, dim=1).amax(dim=1)
        return h
    return run


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def peaks(label, peak_flops=None, hbm_bw=None):
    """(FLOP/s, B/s) of the card named by nvidia-smi's line: given, or
    from PEAKS; raises for an unnamed card; None on the CPU."""
    if label == "cpu":
        return None
    if peak_flops and hbm_bw:
        return peak_flops, hbm_bw
    name = label.split(",")[0].strip()
    if name not in PEAKS:
        raise SystemExit(f"no peaks known for {name!r}: pass --peak-flops "
                         "and --hbm-bw")
    return PEAKS[name]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="the card's dense bf16 FLOP/s (required for a "
                    "card not in PEAKS)")
    ap.add_argument("--hbm-bw", type=float, default=None,
                    help="the card's memory rate in B/s (with --peak-flops)")
    args = ap.parse_args(argv)

    import torch
    from svision_tpu_torch.timing import device_label, random_specs
    from svision_tpu_torch.timing import graph_ms
    from svision_tpu_torch.device import resolve_device
    from svision_tpu_torch.models.alexnet import (AlexNet, fold_params_bf16,
                                                  init_params)
    from svision_tpu_torch.ops import rasterize

    dev = resolve_device(args.device)
    label = device_label(dev)
    peak = peaks(label, args.peak_flops, args.hbm_bw)
    model = AlexNet.from_params(fold_params_bf16(init_params(0)), s2d=True,
                                device=dev)
    w_s2d = model.conv1_weight_hwio()
    ep, vis, rev = (torch.from_numpy(a).to(dev) for a in
                    rasterize.specs_to_endpoints(random_specs(args.batch, 0)))
    weights = {name: nbytes(getattr(model, name).parameters())
               for name in layer_macs()}
    weights["conv1"] = nbytes((w_s2d, model.conv1.bias))

    lines, prev_ms = [], 0.0
    with torch.inference_mode():
        for label_s, n_stages in STAGES:
            fn = build_prefix(model, w_s2d, n_stages)
            ms = graph_ms(lambda: fn(ep, vis, rev), dev, reps=args.reps)
            out = fn(ep, vis, rev)
            flops = stage_flops(n_stages) * args.batch
            moved = nbytes((ep, vis, rev)) + nbytes(
                out if isinstance(out, tuple) else (out,)) + sum(
                weights[k] for k in stage_layers(n_stages))
            line = {"section": label_s, "cum_ms": ms,
                    "section_ms": ms - prev_ms,
                    "images_per_s": args.batch / ms * 1e3,
                    "flops": flops, "bytes": moved}
            if peak:
                bound = max(flops / peak[0], moved / peak[1]) * 1e3
                line.update(tensor_core_share=flops / (ms / 1e3) / peak[0],
                            bound_ms=bound, bound_share=bound / ms)
            print(json.dumps(line), flush=True)
            lines.append(line)
            prev_ms = ms
    summary = {"batch": args.batch, "reps": args.reps, "device": label,
               "peak_flops": peak[0] if peak else None,
               "hbm_bw": peak[1] if peak else None,
               "flops_per_image": stage_flops(len(STAGES) - 1),
               "layer_macs_per_image": layer_macs()}
    print(json.dumps(summary), flush=True)
    return {"sections": lines, **summary}


if __name__ == "__main__":
    main()
