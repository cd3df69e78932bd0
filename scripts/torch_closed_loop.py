"""Closed-loop bootstrap with the PyTorch port: simulate -> collect ->
label -> train -> call -> score.

The port of scripts/closed_loop.py: it trains the CNN with
svision_tpu_torch on collection-derived labeled images from one simulated
genome, runs the port's caller (svision_tpu_torch.cli) on a held-out
genome with the trained weights, and scores the calls against the planted
truth. It imports nothing of JAX.

    python scripts/torch_closed_loop.py --out DIR [--epochs 12]
       [--train-per-type 40] [--eval-per-type 10] [--bf16] [--device-loop]
       [--device cuda|cpu]

Prints one JSON line with the train history, the card, and the eval
precision/recall/F1 per type.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="working directory")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--train-per-type", type=int, default=40)
    ap.add_argument("--eval-per-type", type=int, default=10)
    ap.add_argument("--train-seed", type=int, default=11)
    ap.add_argument("--eval-seed", type=int, default=77)
    ap.add_argument("--support", type=int, default=8)
    ap.add_argument("--bf16", action="store_true",
                    help="train in bfloat16 compute")
    ap.add_argument("--csv", action="store_true",
                    help="include complex events (DEL+INS, INV+DEL) in the "
                         "held-out genome and run the caller with --graph")
    ap.add_argument("--device-loop", action="store_true",
                    help="train with fit_device (data, parameters and "
                         "augmentation on the device; no per-step host sync)")
    ap.add_argument("--noise", choices=["hifi", "ont"], default=None,
                    help="realistic read noise on both genomes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ns = ap.parse_args(argv)

    import torch
    from svision_tpu_torch.cli import parse_arguments, run_pipeline
    from svision_tpu_torch.evaluate import score_vcf
    from svision_tpu_torch.infer.engine import resolve_device
    from svision_tpu_torch.models import alexnet
    from svision_tpu_torch.models.checkpoint import save_params
    from svision_tpu_torch.models.dataset import (CLASS_NAMES, build_dataset,
                                                  simulate_events)
    from svision_tpu_torch.models.train import evaluate, fit, fit_device
    from svision_tpu_torch.sim import make_genome, make_sv_bam

    dev = resolve_device(ns.device)
    os.makedirs(ns.out, exist_ok=True)
    report = {"device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "trainer": "fit_device" if ns.device_loop else "fit",
              "dtype": "bf16" if ns.bf16 else "f32"}

    # 1) training data from simulated genome A
    t0 = time.perf_counter()
    train_kinds = ("DEL", "INS", "INV", "DUP", "tDUP")
    if ns.csv:
        train_kinds = train_kinds + ("INV+DEL",)
    specs, labels, _ = build_dataset(n_per_type=ns.train_per_type,
                                     seed=ns.train_seed, support=ns.support,
                                     profile=ns.noise, kinds=train_kinds)
    counts = {CLASS_NAMES[c]: int((labels == c).sum()) for c in range(5)}
    report["train_examples"] = counts
    report["dataset_s"] = time.perf_counter() - t0
    print(f"[1/4] dataset: {len(labels)} examples {counts} "
          f"({report['dataset_s']:.1f}s)", flush=True)

    # 2) train
    t0 = time.perf_counter()
    params = alexnet.init_params(0)
    dtype = torch.bfloat16 if ns.bf16 else torch.float32
    trainer = fit_device if ns.device_loop else fit
    extra = {"noise_aug": True} if ns.device_loop and ns.noise else {}
    params, history = trainer(params, specs, labels, epochs=ns.epochs,
                              batch_size=ns.batch_size, seed=1,
                              learning_rate=ns.lr, compute_dtype=dtype,
                              device=dev,
                              log=lambda m: print("   " + m, flush=True),
                              **extra)
    report["train_s"] = time.perf_counter() - t0
    train_acc = evaluate(params, specs, labels, device=dev)
    weights = os.path.join(ns.out, "trained.npz")
    save_params(params, weights)
    report["loss_first"], report["loss_last"] = history[0], history[-1]
    report["train_acc"] = round(train_acc, 4)
    print(f"[2/4] trained {ns.epochs} epochs: loss {history[0]:.3f} -> "
          f"{history[-1]:.3f}, train acc {train_acc:.3f} "
          f"({report['train_s']:.1f}s)", flush=True)

    # 3) held-out genome B + the port's caller
    t0 = time.perf_counter()
    kinds = ("DEL", "INS", "INV", "DUP", "tDUP")
    if ns.csv:
        kinds = kinds + ("DEL+INS", "INV+DEL")
    events, chrom_len = simulate_events(ns.eval_per_type, seed=ns.eval_seed,
                                        kinds=kinds)
    eval_dir = os.path.join(ns.out, "eval")
    os.makedirs(eval_dir, exist_ok=True)
    genome = os.path.join(eval_dir, "ref.fa")
    bam = os.path.join(eval_dir, "sim.bam")
    seqs = make_genome(genome, {"chr1": chrom_len}, seed=ns.eval_seed)
    make_sv_bam(bam, seqs, seed=ns.eval_seed, support=ns.support,
                events=events, profile=ns.noise)
    cli_args = ["-o", os.path.join(eval_dir, "out"), "-b", bam, "-g", genome,
                "-m", weights, "-n", "loop", "-s", "3",
                "--batch_size", str(ns.batch_size), "--device", dev.type]
    if ns.csv:
        cli_args.append("--graph")
    vcf = run_pipeline(parse_arguments(cli_args))
    report["call_s"] = time.perf_counter() - t0
    print(f"[3/4] called {vcf} ({report['call_s']:.1f}s)", flush=True)

    # 4) score
    score = score_vcf(vcf, events, tol=1500)
    report["eval"] = score
    print(f"[4/4] eval: P={score['precision']} R={score['recall']} "
          f"F1={score['f1']} per-type={score['per_type']}", flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
