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

With --exact it times the exact f32 step instead (TF32 off, exact_f32),
by two routes, each line naming its route:
  k1_cudnn (the CPU exact engine's form, the unfolded network, here on
            the card):
    raster          K1's f32 images (render_images)
    +conv1          conv1 11x11/4 through cuDNN, NCHW weights on
                    channels_last input, as AlexNet.forward runs it
    +conv1blk ...   then the stages above, to the whole step
  k3 (the fused route, engine.fused_logits on the folded f32 weights:
      the exact engine's step on the card):
    conv1 (K3)      K3 in f32, from the endpoints
    +conv1blk ...   then the same stages.

FLOPs are the benchmark's (benchmark/work.py's layer_macs on the `model`
of its bf16 configuration): 2 x the multiply-accumulates of every conv and
fc layer of the reference network (conv1 as 11x11x3 at 55x55), read
against the card's dense peak for the step's dtype (bf16 tensor cores;
f32 CUDA cores with --exact); bytes are the least a prefix must move (its
inputs and weights read once, its output written once) against the
memory rate. The k3 route's conv1 counts the work this batch needs,
work.conv1_lit_macs of its raster, as chip_smoke's phase 2 does: a lit
pixel's multiply-accumulates, none for a dark one. The whole step's FLOPs
per image are printed too.

    python scripts/torch_roofline.py [--batch 1024] [--reps 20] [--exact]
        [--device cuda|cpu] [--peak-flops F --hbm-bw B]

The card's peaks are benchmark/peaks.json's; for a card it does not name,
--peak-flops and --hbm-bw are required. Without a GPU it raises unless
given --device cpu, where times are host-clock means and no share is
given. Prints one JSON line per prefix, then one summary line.
"""
import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the benchmark's configuration whose `model` the FLOPs are counted on
CONFIG = "svision-alexnet-bf16"

# (label, how many of AlexNet.stages() follow K3; 0: the plain raster)
STAGES = (("raster", 0), ("+conv1blk", 1), ("+conv2blk", 2), ("+conv3", 3),
          ("+conv4", 4), ("+conv5+pool", 5), ("+fc/head (full)", 6))
# --exact: route -> (label, how many of AlexNet.stages() follow conv1;
# None: K1's images alone)
EXACT_STAGES = {
    "k1_cudnn": (("raster", None), ("+conv1", 0)) + STAGES[1:],
    "k3": (("conv1 (K3)", 0),) + STAGES[1:],
}


def bench_model():
    """The network's widths as the benchmark counts them: the `model` of
    its configuration CONFIG (benchmark/configs)."""
    from benchmark import spec
    return spec.config(spec.load(), CONFIG)["model"]


def stage_layers(n_stages):
    """The layers a prefix of n_stages stages runs (AlexNet.STAGE_LAYERS)."""
    from svision_tpu_torch.models.alexnet import AlexNet
    return [k for layers in AlexNet.STAGE_LAYERS[:n_stages] for k in layers]


def stage_flops(n_stages):
    """FLOPs per image of a prefix: 2 x its layers' MACs."""
    from benchmark import work
    macs = work.layer_macs(bench_model())
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


def exact_layers(n_stages):
    """The layers an exact prefix runs: none for K1's images alone, conv1
    with it, then the stages' (conv1 among them)."""
    if n_stages is None:
        return []
    return stage_layers(n_stages) if n_stages else ["conv1"]


def build_exact_prefix(model, n_stages, w_s2d=None):
    """fn(ep, vis, rev) -> an exact prefix's output. Given w_s2d, the
    fused route on the folded network (s2d=True): K3 in f32, then the first
    n_stages of forward_conv1's stages. Without it, the engine's exact step
    on the unfolded network: K1's images (alone for n_stages None), conv1
    as AlexNet.forward runs it, then n_stages stages. With all of them, the
    step's (argmax, max softmax). Run it under exact_f32()."""
    import torch
    from svision_tpu_torch.ops.fused_conv1 import conv1_fused_raster
    from svision_tpu_torch.ops.raster_kernel import render_images
    full = n_stages == len(model.stages())

    def run(ep, vis, rev):
        if w_s2d is not None:
            pre = conv1_fused_raster(ep, vis, rev, w_s2d)
        else:
            x = render_images(ep, vis, rev, dtype=torch.float32)
            if n_stages is None:
                return x
            pre = model._conv(model.conv1, x.permute(0, 3, 1, 2),
                              bias=False).permute(0, 2, 3, 1)
        h = model.forward_conv1(pre, n_stages)
        if full:
            return h.argmax(dim=1), torch.softmax(h, dim=1).amax(dim=1)
        return h
    return run


def peaks(label, peak_flops=None, hbm_bw=None, f32=False):
    """(FLOP/s, B/s) of the card named by nvidia-smi's line, the FLOP/s
    those of bf16 tensor cores, or of f32 CUDA cores given f32: given, or
    benchmark/peaks.json's; raises for a card it does not name; None on
    the CPU."""
    from benchmark import work
    if label == "cpu":
        return None
    if peak_flops and hbm_bw:
        return peak_flops, hbm_bw
    name = label.split(",")[0].strip()
    try:
        p = work.peaks(name)
    except KeyError:
        raise SystemExit(f"no peaks known for {name!r}: pass --peak-flops "
                         "and --hbm-bw") from None
    return (p["float32_flops" if f32 else "bfloat16_flops"],
            p["hbm_bytes_per_s"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--exact", action="store_true",
                    help="time the exact f32 step by its two routes")
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="the card's dense FLOP/s in the step's dtype, "
                    "bf16 or f32 with --exact (required for a card not in "
                    "benchmark/peaks.json)")
    ap.add_argument("--hbm-bw", type=float, default=None,
                    help="the card's memory rate in B/s (with --peak-flops)")
    args = ap.parse_args(argv)

    import torch
    from benchmark import work
    from svision_tpu_torch.timing import device_label, random_specs
    from svision_tpu_torch.timing import graph_ms
    from svision_tpu_torch.device import resolve_device
    from svision_tpu_torch.infer.engine import exact_f32
    from svision_tpu_torch.models.alexnet import (AlexNet, fold_conv1_params,
                                                  fold_params_bf16,
                                                  init_params)
    from svision_tpu_torch.ops import rasterize

    dev = resolve_device(args.device)
    label = device_label(dev)
    peak = peaks(label, args.peak_flops, args.hbm_bw, f32=args.exact)
    ep, vis, rev = (torch.from_numpy(a).to(dev) for a in
                    rasterize.specs_to_endpoints(random_specs(args.batch, 0)))
    # route -> [(label, prefix fn, its layers)], the weights' bytes, and
    # the MACs of a layer where the route's kernel does less than the
    # reference layer (K3 f32: the lit terms only)
    routes, weights = {}, {}
    model_widths = bench_model()
    macs = {route: {k: v * args.batch
                    for k, v in work.layer_macs(model_widths).items()}
            for route in ("s2d_bf16",) + tuple(EXACT_STAGES)}
    if args.exact:
        params = init_params(0)
        for route, stages in EXACT_STAGES.items():
            fused = route == "k3"
            model = AlexNet.from_params(
                fold_conv1_params(params) if fused else params, s2d=fused,
                device=dev)
            w_s2d = model.conv1_weight_hwio() if fused else None
            routes[route] = [(lab, build_exact_prefix(model, n, w_s2d),
                              exact_layers(n)) for lab, n in stages]
            weights[route] = layer_bytes(model, w_s2d)
        macs["k3"]["conv1"] = work.conv1_lit_macs(
            rasterize.render_raster(ep, vis, rev), model_widths)
    else:
        model = AlexNet.from_params(fold_params_bf16(init_params(0)),
                                    s2d=True, device=dev)
        w_s2d = model.conv1_weight_hwio()
        routes["s2d_bf16"] = [(lab, build_prefix(model, w_s2d, n),
                               stage_layers(n)) for lab, n in STAGES]
        weights["s2d_bf16"] = layer_bytes(model, w_s2d)

    lines = []
    with torch.inference_mode(), (exact_f32() if args.exact
                                  else contextlib.nullcontext()):
        for route, prefixes in routes.items():
            prev_ms = 0.0
            for label_s, fn, layers in prefixes:
                ms = graph_ms(lambda: fn(ep, vis, rev), dev, reps=args.reps)
                out = fn(ep, vis, rev)
                flops = sum(2 * macs[route][k] for k in layers)
                outs = out if isinstance(out, tuple) else (out,)
                moved = sum(t.nbytes for t in (ep, vis, rev, *outs)) + sum(
                    weights[route][k] for k in layers)
                line = {"section": label_s, "cum_ms": ms,
                        "section_ms": ms - prev_ms,
                        "images_per_s": args.batch / ms * 1e3,
                        "flops": flops, "bytes": moved}
                if args.exact:
                    line = {"route": route, **line}
                if peak:
                    bound = max(flops / peak[0], moved / peak[1]) * 1e3
                    line.update(peak_share=flops / (ms / 1e3) / peak[0],
                                bound_ms=bound, bound_share=bound / ms)
                print(json.dumps(line), flush=True)
                lines.append(line)
                prev_ms = ms
    summary = {"batch": args.batch, "reps": args.reps, "device": label,
               "exact": args.exact,
               "peak_flops": peak[0] if peak else None,
               "hbm_bw": peak[1] if peak else None,
               "flops_per_image": stage_flops(len(STAGES) - 1),
               "layer_macs_per_image": work.layer_macs(model_widths)}
    print(json.dumps(summary), flush=True)
    return {"sections": lines, **summary}


def layer_bytes(model, w_s2d):
    """{layer: bytes of its weights and bias}; conv1 the folded weights'
    when given w_s2d."""
    out = {name: sum(p.nbytes for p in getattr(model, name).parameters())
           for name in stage_layers(len(model.STAGE_LAYERS))}
    if w_s2d is not None:
        out["conv1"] = w_s2d.nbytes + model.conv1.bias.nbytes
    return out

if __name__ == "__main__":
    main()
