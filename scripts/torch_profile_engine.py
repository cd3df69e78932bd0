"""Where the PyTorch port's inference time goes on the card.

The port of scripts/profile_engine.py. At batch 256 over 16 batches of
random specs, with the default engine (bf16, raster 's2d', CUDA graphs):
  1. the host's specs_to_endpoints, specs/s;
  2. the engine's step with a synchronization each batch (one
     predict_specs call a batch), images/s;
  3. the engine's step pipelined (one predict_specs call for all batches:
     the chunked plan through its CUDA graphs, one synchronization);
  4. the raster alone and the CNN alone: K1 rendering f32 images and the
     unfolded bf16 network on them (what the JAX script times), and the
     default engine's own halves, K3 (raster fused into conv1) and the
     network after conv1 (AlexNet.forward_conv1); each captured as a CUDA
     graph and timed over its replays with the queue held
     (svision_tpu_torch.timing.graph_ms);
  5. one pipelined call traced as the benchmark traces its slice
     (benchmark/devtrace.py): the device's busy time, its idle share and
     its ten longest operations.

    python scripts/torch_profile_engine.py [--batch 256] [--batches 16]
        [--device cuda|cpu]

Without a GPU it raises unless given --device cpu, where every time is a
host-clock mean and there is no profile. Prints one line per measurement,
then one JSON line.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import torch
    from svision_tpu_torch.timing import device_label, random_specs
    from svision_tpu_torch.timing import graph_ms
    from svision_tpu_torch.device import resolve_device
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.models.alexnet import (AlexNet, cast_params_bf16,
                                                  init_params)
    from svision_tpu_torch.ops import rasterize
    from svision_tpu_torch.ops.fused_conv1 import conv1_fused_raster
    from svision_tpu_torch.ops.raster_kernel import render_images

    dev = resolve_device(args.device)
    bs, n = args.batch, args.batch * args.batches
    report = {"device": device_label(dev), "batch": bs,
              "batches": args.batches}
    params = init_params(0)
    specs = random_specs(n, seed=0)

    t0 = time.perf_counter()
    ep, vis, rev = rasterize.specs_to_endpoints(specs)
    report["host_specs_per_s"] = n / (time.perf_counter() - t0)
    print(f"host specs_to_endpoints: {report['host_specs_per_s']:.0f} "
          "specs/s", flush=True)

    engine = InferenceEngine(params, batch_size=bs, device=dev)
    engine.warmup()
    engine.predict_specs(specs)          # the chunk graphs' first replays
    t0 = time.perf_counter()
    for i in range(0, n, bs):
        engine.predict_specs(specs[i:i + bs])
    report["per_batch_sync_images_per_s"] = n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    engine.predict_specs(specs)
    report["pipelined_images_per_s"] = n / (time.perf_counter() - t0)
    print(f"per-batch sync: {report['per_batch_sync_images_per_s']:.0f} "
          f"images/s; pipelined: {report['pipelined_images_per_s']:.0f} "
          "images/s", flush=True)

    # 4. the halves, each on one batch resident on the device
    e, v, r = (torch.from_numpy(a[:bs]).to(dev) for a in (ep, vis, rev))
    model, w_s2d = engine._replicas[0]
    unfolded = AlexNet.from_params(cast_params_bf16(params), device=dev)
    with torch.inference_mode():
        images = render_images(e, v, r, dtype=torch.float32)
        pre = conv1_fused_raster(e, v, r, w_s2d)
        parts = {
            "raster_k1_f32": lambda: render_images(e, v, r,
                                                   dtype=torch.float32),
            "cnn_unfolded_bf16": lambda: unfolded(images),
            "k3_raster_conv1": lambda: conv1_fused_raster(e, v, r, w_s2d),
            "network_after_conv1": lambda: model.forward_conv1(pre),
        }
        report["alone_ms_per_batch"] = ms = {
            k: graph_ms(fn, dev) for k, fn in parts.items()}
    for k, t in ms.items():
        print(f"{k} alone: {t:.4f} ms a batch, {bs / t * 1e3:.0f} images/s",
              flush=True)

    # 5. the profile of one pipelined call
    if dev.type == "cuda":
        from benchmark import devtrace
        trace = devtrace.profile(lambda: engine.predict_specs(specs), [dev])
        wall_ms, busy_ms = trace.window_s * 1e3, trace.busy_s * 1e3
        report["profile"] = dict(
            wall_ms_per_batch=wall_ms / args.batches,
            device_ms_per_batch=busy_ms / args.batches,
            idle_share=trace.idle_pct() / 100,
            top_kernels_ms_per_batch={
                k: t * 1e3 / args.batches
                for k, t in trace.breakdown()["device_ops"]})
        print(f"profile: {wall_ms / args.batches:.3f} ms a batch wall, "
              f"{busy_ms / args.batches:.3f} on the device, idle share "
              f"{report['profile']['idle_share']:.3f}", flush=True)
    else:
        report["profile"] = "not measured on the CPU"
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
