"""Benchmark of the PyTorch/CUDA port: similarity-image encoding + CNN
forward throughput on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "images/s", "vs_baseline": N,
   "device": "<nvidia-smi name, power limit>"}

value     = the port's default engine (svision_tpu_torch InferenceEngine:
            bf16, the fused raster+conv1 kernel, its CUDA graphs) in
            images/s at batch 128 over 512 batches, best of 3 calls, after a
            warm-up of one full chunk; weights init_params(0)
baseline  = the reference pipeline's per-image path (cv2 rasterization + the
            TF AlexNet graph on CPU), the figure bench.py measured once and
            cached in bench_baseline.json, on another host; this script
            only reads it

    python bench_torch.py [--batch 128] [--batches 512] [--device cuda|cpu]

Runs on the card; without a GPU it raises unless given --device cpu, and a
CPU run's metric says cpu.
"""

import argparse
import json
import os
import time

from svision_tpu_torch.timing import device_label, random_specs

ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE_CACHE = os.path.join(ROOT, "bench_baseline.json")


def baseline():
    """The cached TF-CPU images/s of bench.py; raises when it is missing
    (measuring it needs TensorFlow, which the card's machine lacks)."""
    if not os.path.exists(BASELINE_CACHE):
        raise FileNotFoundError(
            f"{BASELINE_CACHE} is missing: run bench.py --refresh-baseline "
            "on a host with TensorFlow")
    with open(BASELINE_CACHE) as fh:
        return json.load(fh)["images_per_s_tf_cpu"]


def measure(batch_size=128, n_batches=512, seed=0, device=None):
    """Images/s of the default engine on random specs: the best of 3 timed
    predict_specs calls (host clock; each call ends in its
    synchronization), after a warm-up of one full chunk."""
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.models.alexnet import init_params

    engine = InferenceEngine(init_params(0), batch_size=batch_size,
                             device=device)
    specs = random_specs(batch_size * n_batches, seed)
    engine.predict_specs(specs[:batch_size * engine.chunk])
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        engine.predict_specs(specs)
        best = max(best, specs.shape[0] / (time.perf_counter() - t0))
    return best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--batches", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from svision_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    label = device_label(dev)
    base = baseline()
    rate = measure(args.batch, args.batches, device=dev)
    kind = "gpu" if dev.type == "cuda" else "cpu"
    line = {
        "metric": f"similarity_images_per_s_{kind} (encoder+CNN fwd)",
        "value": rate,
        "unit": "images/s",
        "vs_baseline": rate / base,
        "device": label,
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
