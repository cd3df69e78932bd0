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
   GEMMs, dequantize to bf16), against the bf16 layer it replaces: cuDNN's
   F.conv2d (channels_last, grouped where AlexNet is) or F.linear, as
   AlexNet runs it.
3. Grouped convolutions. The bf16 s2d engine with conv2, conv4 and conv5
   run as two ungrouped convolutions each (AlexNet._conv patched in this
   script only) against the grouped engine, in turns (grouped, split,
   split, grouped, --reps calls each), the two outputs' argmax agreement,
   and one profiled call of each (chip_smoke.profile_engine): the device
   time per batch by kernel, which shows whether cuDNN's layout kernels
   around the grouped convolutions go.

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
                    lambda: bf._conv(layer, x_bf,
                                     bias=name not in ("conv1", "conv2")))))
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
def split_groups():
    """AlexNet's grouped convolutions as one ungrouped convolution per
    group, the outputs concatenated on the channel axis (channels_last
    stays channels_last)."""
    import torch
    import torch.nn.functional as F
    from svision_tpu_torch.models.alexnet import AlexNet
    real = AlexNet.__dict__["_conv"]             # the staticmethod

    def split(layer, h, bias=True):
        g = layer.groups
        if g == 1:
            return real.__func__(layer, h, bias)
        cin, cout = h.shape[1] // g, layer.weight.shape[0] // g
        return torch.cat(
            [F.conv2d(h[:, i * cin:(i + 1) * cin],
                      layer.weight[i * cout:(i + 1) * cout],
                      layer.bias[i * cout:(i + 1) * cout] if bias else None,
                      layer.stride, layer.padding)
             for i in range(g)], dim=1)
    AlexNet._conv = staticmethod(split)
    try:
        yield
    finally:
        AlexNet._conv = real


def grouped_vs_split(smoke, params, reps: int, rows: list) -> None:
    import numpy as np
    from svision_tpu_torch.infer.engine import InferenceEngine
    specs = smoke.random_specs(128 * CALL_BATCHES, seed=0)
    eng = InferenceEngine(params, device=DEVICE)
    eng.warmup()
    with split_groups():
        split = InferenceEngine(params, device=DEVICE)
        split.warmup()
    want, got = eng.predict_specs(specs), split.predict_specs(specs)
    rates = {"grouped": [], "split": []}
    for name in ("grouped", "split", "split", "grouped"):
        e = eng if name == "grouped" else split
        rates[name].append(smoke.best_rate(e, specs, reps))
    profiles = {}
    for name, ctx in (("grouped", contextlib.nullcontext()),
                      ("split", split_groups())):
        with ctx:
            profiles[name] = smoke.profile_engine(params, modes=[(name, {})],
                                                  eager=False)[name]
    emit(rows, dict(part="grouped_vs_split", batch=128, rates=rates,
                    argmax_agreement=float((want[0] == got[0]).mean()),
                    bit_equal=bool(np.array_equal(want[0], got[0])
                                   and np.array_equal(want[1], got[1])),
                    profiles=profiles))


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
    result = dict(device=smi, rows=rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
