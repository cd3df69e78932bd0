"""Batch-throughput scaling curve of the PyTorch port's data-parallel
inference over several GPUs: the engine with devices=make_mesh(d) (one
model replica per GPU, each taking whole batches of --batch rows), at
d = 1, 2, 4, ... up to the GPUs visible.

The port of scripts/mesh_scaling.py. Weak scaling: each device runs
batches of --batch rows, so a round of the plan carries --batch x d. Each
size runs the engine's CUDA graphs after one warm call, best of --reps
calls on --n specs (host clock; each call ends in its synchronization):

    python scripts/torch_mesh_scaling.py [--batch 64] [--chunk 8]
        [--n 4096] [--reps 3] [--exact] [--device cuda|cpu]
        [--max-devices N]

With --device cpu the devices are CPU replicas (--max-devices of them, 8
by default), as the JAX script runs on virtual CPU devices. Without a GPU
it raises unless given --device cpu. Prints one JSON line per mesh size:
images/s, speedup and efficiency against one device.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sizes(n_dev):
    """Mesh sizes 1, 2, 4, ... up to n_dev."""
    return [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64,
                    help="rows a batch on each device (a round scales "
                    "with the mesh, weak-scaling style)")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--n", type=int, default=4096,
                    help="specs per measured repetition")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--exact", action="store_true",
                    help="the f32 path (--exact) instead of bf16")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu "
                    "replicas")
    ap.add_argument("--max-devices", type=int, default=None,
                    help="largest mesh (default: every visible GPU; 8 CPU "
                    "replicas with --device cpu)")
    args = ap.parse_args(argv)

    import torch
    from svision_tpu_torch.timing import device_label, random_specs
    from svision_tpu_torch.device import resolve_device
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.models.alexnet import init_params
    from svision_tpu_torch.parallel.mesh import make_mesh

    label = device_label(resolve_device(args.device))
    n_dev = (args.max_devices or 8 if args.device == "cpu"
             else min(args.max_devices or torch.cuda.device_count(),
                      torch.cuda.device_count()))
    params = init_params(0)
    specs = random_specs(args.n, seed=0)
    base = None
    lines = []
    for d in sizes(n_dev):
        engine = InferenceEngine(params, batch_size=args.batch,
                                 bf16=not args.exact, chunk=args.chunk,
                                 device=args.device,
                                 devices=make_mesh(d, args.device)
                                 if d > 1 else None)
        engine.predict_specs(specs)          # build, capture, warm
        best = 0.0
        for _ in range(args.reps):
            t0 = time.perf_counter()
            engine.predict_specs(specs)
            best = max(best, args.n / (time.perf_counter() - t0))
        if base is None:
            base = best
        line = {"devices": d, "images_per_s": best,
                "speedup": best / base, "efficiency": best / base / d,
                "platform": "gpu" if args.device == "cuda" else "cpu",
                "device": label}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del engine
    return lines


if __name__ == "__main__":
    main()
