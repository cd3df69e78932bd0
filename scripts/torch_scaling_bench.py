"""Genome-sharding scaling harness of the PyTorch port: N shard processes
against one.

The port of scripts/scaling_bench.py. It builds a synthetic
multi-chromosome BAM, then runs the sharded pipeline
(svision_tpu_torch.parallel.dist.run_shard) with 1 and with N shards, each
shard its own spawned process (the layout of a real multi-host run: every
host runs its shard over a shared filesystem and host 0 merges), and
checks that the N-shard merged VCF equals the 1-shard VCF line for line.

Shard k runs its engine on GPU k % (GPUs visible) (CUDA_VISIBLE_DEVICES),
so several shards may share one card, or on the CPU with --device cpu.
Each shard process is pinned to its own slice of the host's cores, the
same size in every configuration. The parent builds the CUDA kernels once
before any shard starts. Each shard reports apart:
  * setup_s: its engine's set-up -- loading the kernels, cuDNN, and
    capturing its CUDA graphs (InferenceEngine.warmup) -- and a warm-up of
    the host's lazy imports and native BAM decoder;
  * work_s: run_shard with that warm engine (collection + prediction +
    its VCF fragments).
The parent reports the merge (host 0) apart, and the scaling efficiency
from the work alone: the 1-shard work over N x the slowest shard's work.
The two configurations run --rounds times in alternating order (1, N, N,
1, ...) and each keeps its best round, so neither gains from going second
(a warmer page cache, disk or card); every round's work is reported too.

    python scripts/torch_scaling_bench.py [--hosts 2] [--chroms 4] [--mb 1]
        [--rounds 2] [--fast-genome] [--device cuda|cpu]

Without a GPU it raises unless given --device cpu. Prints per-shard lines,
then one JSON line.
"""
import argparse
import json
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _options(out_path, genome, bam, weights, device):
    from svision_tpu_torch.cli import RunOptions
    return RunOptions(out_path=out_path, genome=genome, bam_path=bam,
                      model_path=weights, min_support=3, batch_size=64,
                      sample="scale", device=device, mesh="none").normalized()


def _shard_worker(args):
    """One shard in its own process -> {shard, gpu, setup_s, work_s,
    chroms}."""
    (out_path, genome, bam, weights, shard_id, num_shards, cores, device,
     gpu) = args
    if cores:
        try:
            os.sched_setaffinity(0, cores)
        except OSError:
            pass
    if gpu is not None:
        # before torch initializes CUDA: this process sees one card
        os.environ["CUDA_VISIBLE_DEVICES"] = str(gpu)
    sys.path.insert(0, ROOT)
    from svision_tpu_torch.collect.window import run_detect
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.io.bam import BamReader
    from svision_tpu_torch.io.fasta import FastaFile
    from svision_tpu_torch.models.checkpoint import load_params
    from svision_tpu_torch.parallel.dist import run_shard

    options = _options(out_path, genome, bam, weights, device)
    t0 = time.perf_counter()
    engine = InferenceEngine(load_params(weights),
                             batch_size=options.batch_size,
                             bf16=options.bf16, device=device)
    engine.warmup()
    # warm lazy imports / the native decoder outside the work's timer
    with BamReader(bam) as bam_r:
        chrom = bam_r.references[0]
        run_detect(options, bam, chrom, 9999, 0, 1000, bam=bam_r,
                   ref=FastaFile(genome))
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    chroms = run_shard(options, shard_id, num_shards, engine=engine)
    work_s = time.perf_counter() - t0
    return dict(shard=shard_id, gpu=gpu, setup_s=setup_s, work_s=work_s,
                chroms=chroms)


def run_config(workdir, genome, bam, weights, n_hosts, cores_per_host,
               device, n_gpus):
    """Every shard of an n_hosts run in its own spawned process, then host
    0's merge -> (per-shard reports, merge s, merged VCF)."""
    out = os.path.join(workdir, f"hosts{n_hosts}")
    os.makedirs(out, exist_ok=True)
    all_cores = sorted(os.sched_getaffinity(0))
    jobs = [(out, genome, bam, weights, k, n_hosts,
             tuple(all_cores[k * cores_per_host:(k + 1) * cores_per_host]),
             device, k % n_gpus if n_gpus else None)
            for k in range(n_hosts)]
    with mp.get_context("spawn").Pool(n_hosts) as pool:
        shards = pool.map(_shard_worker, jobs)
    from svision_tpu_torch.cli import build_task_list
    from svision_tpu_torch.io.bam import BamReader
    from svision_tpu_torch.io.fasta import FastaFile
    from svision_tpu_torch.parallel.dist import merge_all
    t0 = time.perf_counter()
    options = _options(out, genome, bam, weights, device)
    with BamReader(bam) as bam_r:
        chroms = list(build_task_list(bam_r, FastaFile(genome), options))
    vcf = merge_all(options, chroms)
    merge_s = time.perf_counter() - t0
    for s in shards:
        print(f"[hosts={n_hosts}] shard {s['shard']} (gpu {s['gpu']}): "
              f"setup {s['setup_s']:.3f} s, work {s['work_s']:.3f} s",
              flush=True)
    print(f"[hosts={n_hosts}] merge {merge_s:.3f} s", flush=True)
    return shards, merge_s, vcf


def run_order(hosts, rounds):
    """The configurations' order over rounds: 1, N, then N, 1, ..."""
    order = []
    for r in range(rounds):
        order += [1, hosts] if r % 2 == 0 else [hosts, 1]
    return order


def build_fixture(workdir, n_chroms, mb, fast_genome=False):
    """The JAX script's fixture: per chromosome a 300 bp DEL every 150 kb
    on six reads, and 5 kb background reads every 4 kb -> (genome, BAM,
    read count). fast_genome draws the bases with numpy (sim.make_genome's
    fast=), for chromosomes of tens of Mb."""
    import random
    from svision_tpu_torch import sim
    from svision_tpu_torch.io.bamwrite import SamRecord, write_bam

    genome = os.path.join(workdir, "ref.fa")
    size = int(mb * 1e6)
    seqs = sim.make_genome(genome, {f"chr{i+1}": size
                                    for i in range(n_chroms)}, seed=13,
                            fast=fast_genome)
    records = []
    n_reads = 0
    for ci, (chrom, g) in enumerate(seqs.items()):
        events = [("DEL", chrom, 60000 + k * 150000, 300)
                  for k in range(max(1, size // 150000 - 1))]
        rng = random.Random(ci)
        flank = 2000
        for ei, (kind, ch, anchor, sz) in enumerate(events):
            for s in range(6):
                q = f"{chrom}_sv{ei}_{s}"
                a = anchor + rng.randint(-12, 12)
                records += sim.del_read(q, ch, a, flank, sz, g)
                n_reads += 1
        for i in range(0, len(g) - 6000, 4000):
            records.append(SamRecord(f"{chrom}_bg{i}", 0, chrom, i, 60,
                                     "5000M", g[i:i + 5000]))
            n_reads += 1
    bam = os.path.join(workdir, "scale.bam")
    write_bam(bam, [(c, len(s)) for c, s in seqs.items()], records)
    return genome, bam, n_reads


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--chroms", type=int, default=4)
    ap.add_argument("--mb", type=float, default=1.0, help="chrom size in Mb")
    ap.add_argument("--fast-genome", action="store_true",
                    help="numpy-based base generation (large --mb)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of the two configurations, alternating")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the shards' device (default: %(default)s; raises "
                    "without a GPU unless cpu)")
    args = ap.parse_args(argv)

    import torch
    from svision_tpu_torch.timing import device_label
    from svision_tpu_torch.device import resolve_device
    from svision_tpu_torch.models.alexnet import init_params
    from svision_tpu_torch.models.checkpoint import save_params

    label = device_label(resolve_device(args.device))
    n_gpus = torch.cuda.device_count() if args.device == "cuda" else 0
    build_s = 0.0
    if n_gpus:
        from svision_tpu_torch.ops import _kernels
        t0 = time.perf_counter()
        _kernels.build()       # once, before any shard: none of them runs nvcc
        build_s = time.perf_counter() - t0

    workdir = tempfile.mkdtemp(prefix="torch_scaling_")
    try:
        t0 = time.perf_counter()
        genome, bam, n_reads = build_fixture(workdir, args.chroms, args.mb,
                                              args.fast_genome)
        fixture_s = time.perf_counter() - t0
        weights = os.path.join(workdir, "w.npz")
        save_params(init_params(0), weights)

        cph = max(1, len(os.sched_getaffinity(0)) // args.hosts)
        rounds = {1: [], args.hosts: []}
        for r, n in enumerate(run_order(args.hosts, args.rounds)):
            shards, merge_s, vcf = run_config(
                os.path.join(workdir, f"round{r}"), genome, bam, weights, n,
                cph, args.device, n_gpus)
            recs = [ln for ln in open(vcf) if not ln.startswith("#")]
            rounds[n].append(dict(shards=shards, merge_s=merge_s,
                                  work_s=max(x["work_s"] for x in shards),
                                  records=recs))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    best = {n: min(rs, key=lambda x: x["work_s"]) for n, rs in rounds.items()}
    one, many = best[1], best[args.hosts]
    report = {
        "device": label, "gpus": n_gpus, "hosts": args.hosts,
        "cores_per_host": cph, "reads": n_reads, "calls": len(one["records"]),
        "rounds": args.rounds, "fixture_s": fixture_s,
        "kernel_build_s": build_s,
        "work_s_by_round_1host": [x["work_s"] for x in rounds[1]],
        f"work_s_by_round_{args.hosts}host": [
            x["work_s"] for x in rounds[args.hosts]],
        "shards_1host": one["shards"],
        f"shards_{args.hosts}host": many["shards"],
        "merge_s_1host": one["merge_s"],
        f"merge_s_{args.hosts}host": many["merge_s"],
        "work_s_1host": one["work_s"],
        f"work_s_{args.hosts}host": many["work_s"],
        "reads_per_s_1host": n_reads / one["work_s"],
        f"reads_per_s_{args.hosts}host": n_reads / many["work_s"],
        "scaling_efficiency": one["work_s"] / (args.hosts * many["work_s"]),
        "n_shard_vcf_identical": all(
            x["records"] == one["records"]
            for rs in rounds.values() for x in rs),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
