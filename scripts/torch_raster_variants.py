"""The engine's raster encoders and its int8 network on one CUDA GPU.

    python3 scripts/torch_raster_variants.py [--reps 5] [--out FILE]

Counterpart of scripts/raster_variants.py. With seed-0 weights
(models/alexnet.init_params) and chip_smoke.random_specs:

1. Engines. For each batch (128, 256), network (bf16, int8) and raster
   kind (s2d, compare, einsum, pallas; int8 has no s2d), the engine's
   images/s through its CUDA graphs on 64 batches, the best of --reps
   calls after one; and the raster alone at that batch (CUDA events, the
   queue held): the plain render_raster_s2d for s2d (whose engine fuses it
   into conv1 with K3), render_raster for compare, render_raster_einsum
   for einsum and K1 for pallas, each in bf16.
2. int8 layers. At each batch, every layer of the int8 network on
   activations of its real shape: the activation quantizer, the im2col
   copies, the torch._int_mm GEMMs, and the whole layer (quantize, im2col,
   GEMMs, dequantize to bf16), against the bf16 layer it replaces as
   AlexNet runs it: cuDNN's F.conv2d (channels_last), conv2, conv4 and
   conv5 as two ungrouped convolutions (conv_halves; the input halves
   made before the timing), or F.linear.
3. Grouped convolutions. The bf16 s2d engine, whose conv2, conv4 and
   conv5 run as two ungrouped convolutions each, against the same engine
   with one grouped cuDNN call a grouped layer (grouped_convs, in this
   script only), in turns (grouped, split, split, grouped, --reps calls
   each), the two outputs' argmax agreement, and one profiled call of each
   (chip_smoke.profile_engine): the device time per batch by kernel,
   which shows the layout kernels cuDNN puts around its grouped calls.
4. Stages. At batch 128, the device time of each stage of the bf16 s2d
   step, split and grouped: each prefix of K3 and AlexNet.stages()
   captured as a CUDA graph (timing.graph_ms), a stage's time the
   difference of two prefixes; and conv3 with conv4 in the two forms the
   split route can give conv3: one whole convolution whose output conv4
   reads in two slices (the shipped form), or two convolutions on halves
   of its output channels.

It prints one JSON line per measurement and the card's name and power
limit; --out writes everything as one JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (128, 256)
CALL_BATCHES = 64            # batches per timed engine call
KINDS = ("s2d", "compare", "einsum", "pallas")
DEVICE = "cuda"


def emit(rows: list, row: dict) -> None:
    rows.append(row)
    print(json.dumps(row), flush=True)


def engines(smoke, params, reps: int, rows: list) -> None:
    import torch
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.ops import fused_conv1, raster_kernel, rasterize
    dev = torch.device(DEVICE)
    rasters = {
        "s2d": lambda *seg: rasterize.render_raster_s2d(*seg),
        "compare": lambda *seg: rasterize.render_raster(*seg),
        "einsum": lambda *seg: rasterize.render_raster_einsum(*seg),
        "pallas": lambda *seg: raster_kernel.render_raster(
            *seg, dtype=torch.bfloat16),
    }
    for bs in BATCHES:
        specs = smoke.random_specs(bs * CALL_BATCHES, seed=0)
        seg = [torch.from_numpy(a).to(dev)
               for a in rasterize.specs_to_endpoints(specs[:bs])]
        for kind in KINDS:
            # the plain rasters launch tens of ops a call: 20 calls of them
            # would fill the launch queue behind the held queue's sleep
            ms = smoke.time_ms(lambda: rasters[kind](*seg),
                               reps=20 if kind == "pallas" else smoke.PLAIN_REPS)
            extra = {}
            if kind == "s2d":
                model = InferenceEngine(params, batch_size=bs,
                                        device=dev)._replicas[0]
                extra["k3_raster_and_conv1_ms"] = smoke.time_ms(
                    lambda: fused_conv1.conv1_fused_raster(*seg, model[1]))
            for net in ("bf16", "int8"):
                if net == "int8" and kind == "s2d":
                    continue
                eng = InferenceEngine(params, batch_size=bs, raster=kind,
                                      int8=net == "int8", device=dev)
                eng.warmup()
                eng.predict_specs(specs)
                emit(rows, dict(part="engine", batch=bs, net=net, kind=kind,
                                images_per_s=smoke.best_rate(eng, specs, reps),
                                raster_ms=ms, **extra))
                del eng
                torch.cuda.empty_cache()


def int8_layers(smoke, params, rows: list) -> None:
    """Each int8 layer against the bf16 layer it replaces, on inputs of the
    layer's real shape (the raster's {0,1} for conv1, random activations
    of a plausible range after it)."""
    import torch
    import torch.nn.functional as F
    from svision_tpu_torch.models import int8
    from svision_tpu_torch.models.alexnet import (AlexNet, fold_conv1_params,
                                                  fold_params_bf16,
                                                  space_to_depth)
    dev = torch.device(DEVICE)
    q8 = int8.AlexNetInt8.from_params(
        int8.quantize_params_int8(fold_conv1_params(params)), device=dev)
    bf = AlexNet.from_params(fold_params_bf16(params), s2d=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {"conv1": (57, 48), "conv2": (27, 96), "conv3": (13, 256),
              "conv4": (13, 384), "conv5": (13, 384)}
    for bs in BATCHES:
        for name, k, pad, groups in q8.convs:
            hw, cin = shapes[name]
            if name == "conv1":
                raster = (torch.rand((bs, 227, 227, 3), generator=gen,
                                     device=dev) < 0.02).to(torch.bfloat16)
                h = space_to_depth(raster)
            else:
                h = (torch.rand((bs, hw, hw, cin), generator=gen, device=dev)
                     * 8).to(torch.bfloat16)
            x8, s = int8.quantize_act(h)
            a_scale = None if name == "conv1" else s
            flat = int8.im2col(x8, k, pad, groups)
            ws = [getattr(q8, f"{name}_w{g}").t() for g in range(groups)]

            def whole(h=h, name=name, k=k, pad=pad, groups=groups):
                x = (h.to(torch.int8) if name == "conv1"
                     else int8.quantize_act(h)[0])
                y = q8._conv8(name, x, k, pad, groups)
                return q8._dequant(name, y, a_scale)
            layer = getattr(bf, name)
            x_bf = h.permute(0, 3, 1, 2)               # channels_last NCHW
            xs = [x.contiguous(memory_format=torch.channels_last)
                  for x in x_bf.chunk(groups, dim=1)]
            emit(rows, dict(
                part="int8_layer", batch=bs, layer=name, groups=groups,
                gemm_shape=[flat[0].shape[0], flat[0].shape[1],
                            ws[0].shape[1]],
                quantize_ms=smoke.time_ms(lambda: int8.quantize_act(h)),
                im2col_ms=smoke.time_ms(
                    lambda: int8.im2col(x8, k, pad, groups)),
                int_mm_ms=smoke.time_ms(
                    lambda: [int8.int_mm(f, w) for f, w in zip(flat, ws)]),
                int8_layer_ms=smoke.time_ms(whole),
                # as AlexNet runs it: K2 adds conv1's and conv2's bias
                bf16_cudnn_ms=smoke.time_ms(
                    lambda: bf._convs(layer, xs, bias=name != "conv2")
                    if groups == 2 else
                    bf._conv(layer, x_bf, bias=name != "conv1"))))
        for name, n_in in (("fc6", 9216), ("fc7", 4096)):
            h = (torch.rand((bs, n_in), generator=gen, device=dev)
                 * 8).to(torch.bfloat16)
            x8, s = int8.quantize_act(h)
            w = getattr(q8, f"{name}_w0").t()
            layer = getattr(bf, name)
            emit(rows, dict(
                part="int8_layer", batch=bs, layer=name, groups=1,
                gemm_shape=[bs, n_in, w.shape[1]],
                quantize_ms=smoke.time_ms(lambda: int8.quantize_act(h)),
                im2col_ms=0.0,
                int_mm_ms=smoke.time_ms(lambda: int8.int_mm(x8, w)),
                int8_layer_ms=smoke.time_ms(
                    lambda: q8._dequant(name, int8.int_mm(
                        int8.quantize_act(h)[0], w), s)),
                bf16_cudnn_ms=smoke.time_ms(lambda: layer(h))))


@contextlib.contextmanager
def grouped_convs():
    """Networks built and captured inside run every grouped layer as one
    grouped cuDNN call, in bf16 too: AlexNet.split_groups reads 0 here, as
    the f32 network's does (the split route's reference)."""
    from svision_tpu_torch.models.alexnet import AlexNet
    real = AlexNet.__dict__["split_groups"]      # the property
    AlexNet.split_groups = property(lambda self: 0)
    try:
        yield
    finally:
        AlexNet.split_groups = real


def grouped_vs_split(smoke, params, reps: int, rows: list) -> None:
    import numpy as np
    from svision_tpu_torch.infer.engine import InferenceEngine
    specs = smoke.random_specs(128 * CALL_BATCHES, seed=0)
    split = InferenceEngine(params, device=DEVICE)
    split.warmup()
    with grouped_convs():
        eng = InferenceEngine(params, device=DEVICE)
        eng.warmup()
    want, got = eng.predict_specs(specs), split.predict_specs(specs)
    rates = {"grouped": [], "split": []}
    for name in ("grouped", "split", "split", "grouped"):
        e = eng if name == "grouped" else split
        rates[name].append(smoke.best_rate(e, specs, reps))
    profiles = {}
    for name, ctx in (("grouped", grouped_convs()),
                      ("split", contextlib.nullcontext())):
        with ctx:
            profiles[name] = smoke.profile_engine(params, modes=[(name, {})],
                                                  eager=False)[name]
    emit(rows, dict(part="grouped_vs_split", batch=128, rates=rates,
                    argmax_agreement=float((want[0] == got[0]).mean()),
                    bit_equal=bool(np.array_equal(want[0], got[0])
                                   and np.array_equal(want[1], got[1])),
                    profiles=profiles))


def split_stages(smoke, params, rows: list) -> None:
    import torch
    import torch.nn.functional as F
    from svision_tpu_torch import timing
    from svision_tpu_torch.models.alexnet import AlexNet, fold_params_bf16
    from svision_tpu_torch.ops import rasterize
    from svision_tpu_torch.ops.fused_conv1 import conv1_fused_raster
    dev = torch.device(DEVICE)
    ep, vis, rev = (torch.from_numpy(a).to(dev) for a in
                    rasterize.specs_to_endpoints(smoke.random_specs(128, 1)))
    model = AlexNet.from_params(fold_params_bf16(params), s2d=True,
                                device=dev)
    w = model.conv1_weight_hwio()
    for route, ctx in (("split", contextlib.nullcontext()),
                       ("grouped", grouped_convs())):
        with ctx, torch.inference_mode():
            prefix = [timing.graph_ms(
                lambda k=k: model.forward_conv1(
                    conv1_fused_raster(ep, vis, rev, w), k), dev)
                for k in range(len(model.stages()) + 1)]
        emit(rows, dict(part="stages", batch=128, route=route,
                        prefix_ms=prefix, stage_ms={
                            "+".join(layers): b - a for layers, a, b in zip(
                                AlexNet.STAGE_LAYERS, prefix, prefix[1:])}))
    with torch.inference_mode():
        h = model.forward_conv1(conv1_fused_raster(ep, vis, rev, w), 2)
        w3, b3 = model.conv3.weight.chunk(2), model.conv3.bias.chunk(2)
        forms = {
            "conv3_whole_sliced": lambda: model._conv4(model._conv3(h)),
            "conv3_halves": lambda: model._conv4(tuple(
                torch.relu(F.conv2d(h, wi, bi, 1, 1))
                for wi, bi in zip(w3, b3)))}
        emit(rows, dict(part="conv3_forms", batch=128, conv3_conv4_ms={
            name: timing.graph_ms(fn, dev) for name, fn in forms.items()}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="timed engine calls; the best counts")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("torch_raster_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from svision_tpu_torch.models.alexnet import init_params
    smi = smoke.nvidia_smi()
    smoke.REPORT["device"] = {"nvidia_smi": smi}
    print(smi, flush=True)
    params = init_params(0)
    rows: list = []
    engines(smoke, params, args.reps, rows)
    int8_layers(smoke, params, rows)
    grouped_vs_split(smoke, params, args.reps, rows)
    split_stages(smoke, params, rows)
    result = dict(device=smi, rows=rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
