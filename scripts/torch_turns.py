"""The port's engine and training rates and K2 times for a parent and a
change checkout, in alternating pairs, on one CUDA GPU.

    python3 scripts/torch_turns.py PARENT CHANGE [--pairs 10] [--out FILE]
        [--engines-only | --training-only]

PARENT and CHANGE are checkouts holding svision_tpu_torch/. Each pair runs
one measuring process per checkout, the parent first in even pairs and the
change first in odd ones. A process builds its checkout's kernels into
CHECKOUT/build/ and measures with this checkout's chip_smoke.py on the
other checkout's package:
- the InferenceEngine's images/s in bf16 (the default s2d raster, K3), in
  bf16 with raster='pallas' (K1 in bf16) and in exact mode (f32) on
  chip_smoke.random_specs(8192, seed=3), batch 128, seed-0 weights, the
  best of 3 calls after a warm-up (chip_smoke.best_rate);
- K2's times through the checkout's own wrapper (chip_smoke.check_pool_lrn):
  back to back, and the cold-L2 median of single launches;
- fit_device's images/s in bf16 and in f32 on the s2d path at batch 64
  (chip_smoke.TRAIN_B), over the second of two epochs of
  chip_smoke.RATE_STEPS steps, as chip_smoke phase 7 reads it; then, in a
  second run, the device's idle share over that epoch under torch.profiler
  (chip_smoke.device_time), started and stopped by the epoch-end log
  calls, which follow a sync.
--engines-only measures the engines alone, --training-only fit_device
alone.
The summary gives, per metric, each side's median, the parent's spread
(the distance between its quartiles), and the pairs the change won. It
calls a gain only where the change won at least 9 pairs in 10 and the
medians differ by more than the parent's spread.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "chip_smoke.py")


# the engines timed: name -> InferenceEngine arguments
ENGINES = {"bf16": dict(bf16=True), "pallas bf16": dict(raster="pallas"),
           "exact": dict(bf16=False)}


def measure(root: str, what: str = "all") -> dict:
    """One process's measurements, with root's package: what is "all",
    "engines" or "training"."""
    import importlib.util
    sys.path.insert(0, root)
    # root's package first: chip_smoke imports its timing helpers from the
    # package, with its own checkout first on the path
    import svision_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.models.alexnet import init_params
    pkg = os.path.dirname(os.path.abspath(svision_tpu_torch.__file__))
    assert os.path.dirname(pkg) == root, pkg
    specs, params, out = smoke.random_specs(8192, seed=3), init_params(0), {}
    if what == "training":
        return measure_training(smoke, params)
    for mode, kw in ENGINES.items():
        eng = InferenceEngine(params, batch_size=smoke.B, **kw)
        eng.warmup()
        eng.predict_specs(specs)
        out[f"engine {mode} images/s"] = smoke.best_rate(eng, specs)
        del eng
        torch.cuda.empty_cache()
    if what == "engines":
        return out
    for v in smoke.check_pool_lrn():
        out[f"K2 {v['tail']} {v['dtype']} ms"] = v["ms"]
        out[f"K2 {v['tail']} {v['dtype']} cold median ms"] = v["cold_ms"]["median"]
    out.update(measure_training(smoke, params))
    return out


def measure_training(smoke, params) -> dict:
    """fit_device on the s2d path, bf16 and f32: images/s over the second
    epoch, and the idle share of that epoch profiled in another run."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    from svision_tpu_torch.models.train import fit_device
    specs, labels = smoke.labeled(smoke.TRAIN_B * smoke.RATE_STEPS, seed=10)
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        kw = dict(epochs=2, batch_size=smoke.TRAIN_B, compute_dtype=dtype,
                  device="cuda")
        stamps = []
        fit_device(params, specs, labels,
                   log=lambda m: stamps.append(time.perf_counter()), **kw)
        rate = smoke.RATE_STEPS * smoke.TRAIN_B / (stamps[1] - stamps[0])
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        stamps.clear()

        def epoch_end(_):
            stamps.append(time.perf_counter())
            (prof.start if len(stamps) == 1 else prof.stop)()
        fit_device(params, specs, labels, log=epoch_end, **kw)
        wall_ms = (stamps[1] - stamps[0]) * 1e3
        _, busy_ms = smoke.device_time(prof, wall_ms, "fit_device epoch")
        out[f"fit_device {name} s2d images/s"] = rate
        out[f"fit_device {name} s2d idle share"] = 1.0 - busy_ms / wall_ms
    return out


def summary(pairs: list) -> dict:
    out = {}
    for key in pairs[0]["parent"]:
        a = [p["parent"][key] for p in pairs]
        b = [p["change"][key] for p in pairs]
        higher = key.endswith("images/s")   # else lower is better
        won = sum((y > x) if higher else (y < x) for x, y in zip(a, b))
        q = statistics.quantiles(a, n=4)
        spread = q[2] - q[0]
        ma, mb = statistics.median(a), statistics.median(b)
        out[key] = dict(parent_median=ma, change_median=mb,
                        parent_spread=spread, change_won=won, pairs=len(a),
                        gain=won >= 0.9 * len(a) and abs(mb - ma) > spread
                        and (mb > ma) == higher)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--measure"]:
        print(json.dumps(measure(os.path.abspath(argv[1]), argv[2])))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="the parent's checkout")
    ap.add_argument("change", help="the change's checkout")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", help="write the results as JSON here")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--engines-only", action="store_true",
                      help="measure the engines alone (no K2, no training)")
    only.add_argument("--training-only", action="store_true",
                      help="measure fit_device alone")
    args = ap.parse_args(argv)
    what = ("engines" if args.engines_only else
            "training" if args.training_only else "all")
    pairs = []
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        pair = dict(first=order[0])
        for side in order:
            root = os.path.abspath(getattr(args, side))
            done = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--measure", root,
                 what],
                cwd=root, capture_output=True, text=True)
            if done.returncode != 0:
                print(done.stdout + done.stderr, file=sys.stderr)
                return 1
            pair[side] = json.loads(done.stdout.splitlines()[-1])
        pairs.append(pair)
        print(json.dumps(pair), flush=True)
    result = dict(parent=os.path.abspath(args.parent),
                  change=os.path.abspath(args.change), pairs=pairs,
                  summary=summary(pairs))
    print(json.dumps(result["summary"], indent=1), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
