"""Whole-pipeline benchmark of the PyTorch/CUDA port at realistic scale:
BAM -> VCF with the port's CLI (svision_tpu_torch.cli.run_pipeline).

The port of scripts/e2e_bench.py. It simulates a multi-chromosome genome
with planted SVs at a configurable background depth (the port's sim.py is
a copy of the JAX package's, so both scripts build the same BAM), runs the
FULL pipeline (host collection -> device inference -> VCF), and reports
per-stage wall clock, reads/s, images/s and locus-level recall against the
planted truth, plus the card (nvidia-smi's name and power limit), the
host's CPUs and the collection threads. It accepts any weights (--model),
falling back to the port's init_params(0).

Usage:
  python scripts/torch_e2e_bench.py [--chroms 4] [--mb 5] [--coverage 20]
      [--events-per-chrom 25] [--threads 2] [--model w.npz] [--keep DIR]
      [--device cuda|cpu] [--profile]

--profile passes the CLI its --profile (a torch.profiler trace of the
collection and prediction loop, into the workdir) and reports the device's
busy ms in that trace (the union of its kernels' and copies' intervals).

Runs on the card; without a GPU it raises unless given --device cpu.
"""
import argparse
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KINDS = ["DEL", "INS", "INV", "tDUP", "DUP", "DEL+INS", "INV+DEL"]

# GRCh38-shaped chromosome lengths (Mb) — the whole-genome-scale fixture
# (`--human`): 24 chromosomes, ~3.09 Gb total, the reference's operating
# point (SVision runs 10 Mb windows over whole human genomes, SVision:76).
HUMAN_MB = {
    "chr1": 248.9, "chr2": 242.2, "chr3": 198.3, "chr4": 190.2,
    "chr5": 181.5, "chr6": 170.8, "chr7": 159.3, "chr8": 145.1,
    "chr9": 138.4, "chr10": 133.8, "chr11": 135.1, "chr12": 133.3,
    "chr13": 114.4, "chr14": 107.0, "chr15": 101.9, "chr16": 90.3,
    "chr17": 83.3, "chr18": 80.4, "chr19": 58.6, "chr20": 64.4,
    "chr21": 46.7, "chr22": 50.8, "chrX": 156.0, "chrY": 57.2,
}


def build_inputs(workdir, n_chroms, mb, coverage, events_per_chrom, seed=11,
                 fast_genome=False, noise=None, gt=False, stream=False,
                 human=False, events_per_mb=8.0):
    from svision_tpu_torch.sim import make_genome, make_sv_bam
    if human:
        chroms = {c: int(m * 1e6) for c, m in HUMAN_MB.items()}
        events_map = {c: max(1, round(m * events_per_mb))
                      for c, m in HUMAN_MB.items()}
        params = dict(human=True, coverage=coverage,
                      events_per_mb=events_per_mb, seed=seed,
                      fast_genome=bool(fast_genome), noise=noise,
                      gt=bool(gt), stream=bool(stream))
    else:
        size = int(mb * 1e6)
        chroms = {f"chr{i+1}": size for i in range(n_chroms)}
        events_map = {c: events_per_chrom for c in chroms}
        params = dict(n_chroms=n_chroms, mb=mb, coverage=coverage,
                      events_per_chrom=events_per_chrom, seed=seed,
                      fast_genome=bool(fast_genome), noise=noise,
                      gt=bool(gt), stream=bool(stream))
    t0 = time.time()
    fasta = os.path.join(workdir, "ref.fa")
    bam = os.path.join(workdir, "sample.bam")
    eventsf = os.path.join(workdir, "events.json")
    gtf = os.path.join(workdir, "genotypes.json")
    paramsf = os.path.join(workdir, "fixture_params.json")
    # Bump FIXTURE_VERSION whenever sim.py/noise.py change the bytes a given
    # params dict produces (e.g. an RNG draw-order change): cached fixtures
    # from before the change then rebuild instead of silently passing the
    # params check while containing different reads. Version 1 = the round-4
    # batched-noise draw order; absent in older sidecars, so it defaults.
    FIXTURE_VERSION = 1
    params["fixture_version"] = FIXTURE_VERSION
    if (os.path.exists(fasta) and os.path.getsize(fasta) > 0
            and os.path.exists(bam) and os.path.getsize(bam) > 0
            and os.path.exists(eventsf)
            and (not gt or os.path.exists(gtf))):
        # fixture cache hit (--keep reruns at WGS scale skip the multi-minute
        # simulate+write) — but only when the build parameters match, so a
        # rerun with different --chroms/--mb/... never benchmarks stale
        # files. A --keep dir missing genotypes.json (removed, or a fixture
        # interrupted between the BAM and gt writes) falls through to a
        # rebuild instead of raising at the open below.
        cached = None
        if os.path.exists(paramsf):
            with open(paramsf) as fh:
                cached = json.load(fh)
            if cached is not None:
                cached.setdefault("fixture_version", 1)
        if cached == params:
            with open(eventsf) as fh:
                events = [tuple(e) for e in json.load(fh)]
            genotypes = None
            if gt:
                with open(gtf) as fh:
                    genotypes = json.load(fh)
            return fasta, bam, events, genotypes, 0.0
        print(f"[sim] kept fixtures in {workdir} were built with "
              f"{cached or 'unknown params'}; rebuilding for {params}")
    # invalidate the sidecar BEFORE touching any fixture file: an
    # interrupted rebuild must never leave a stale params file that
    # validates half-rewritten fixtures for a later invocation (the
    # sidecar is rewritten last, after every output is complete)
    if os.path.exists(paramsf):
        os.remove(paramsf)
    genome = make_genome(fasta, chroms, seed=seed, fast=fast_genome)
    rng = random.Random(seed)
    events = []
    for c, size in chroms.items():
        n_ev = events_map[c]
        spacing = (size - 100_000) // n_ev
        for k in range(n_ev):
            anchor = 60_000 + k * spacing + rng.randint(0, spacing // 4)
            kind = KINDS[k % len(KINDS)]
            sz = rng.randint(100, 900)
            if kind == "INV+DEL":
                # independent deletion size clear of the linearOrNot 1.5
                # colinearity band (models/dataset.py:simulate_events)
                events.append((kind, c, anchor, sz,
                               rng.randint(int(0.65 * sz) + 20, sz + 100)))
            elif kind == "DEL+INS":
                events.append((kind, c, anchor, sz,
                               rng.randint(60, max(61, int(0.6 * sz)))))
            else:
                events.append((kind, c, anchor, sz))
    # haplotype-aware genotypes: alternate het/hom so every event kind is
    # scored in both zygosities (sim.make_sv_bam plants het events on half
    # the spanning reads with clean reference-allele reads on the other half)
    genotypes = (["0/1" if i % 2 == 0 else "1/1"
                  for i in range(len(events))] if gt else None)
    # streamed (WGS-scale) fixtures trade disk for build time: BGZF level 1
    # halves the deflate cost and the reader side is unaffected
    make_sv_bam(bam, genome, seed=seed + 1, support=8, events=events,
                coverage=coverage, profile=noise, genotypes=genotypes,
                stream=stream, compress_level=1 if stream else 6)
    with open(eventsf, "w") as fh:
        json.dump(events, fh)
    if gt:
        with open(gtf, "w") as fh:
            json.dump(genotypes, fh)
    with open(paramsf, "w") as fh:
        json.dump(params, fh)
    return fasta, bam, events, genotypes, time.time() - t0


# Chrome-trace categories of the work that runs on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_busy(path):
    """Device time in a torch.profiler Chrome trace: busy ms (the union of
    the kernel and copy intervals, benchmark/devtrace.py's union), the span
    from the first to the last of them, their count, and the five kernels
    that take the most time."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not events:
        raise ValueError(f"{path}: no device activity traced")
    from benchmark.devtrace import union
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events]
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"device_busy_ms": sum(b - a for a, b in union(spans)) / 1e3,
            "device_span_ms": (max(e for _, e in spans)
                               - min(s for s, _ in spans)) / 1e3,
            "device_ops": len(events),
            "top_ms": {k: v / 1e3 for k, v in top}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chroms", type=int, default=4)
    ap.add_argument("--mb", type=float, default=5.0)
    ap.add_argument("--coverage", type=int, default=20)
    ap.add_argument("--events-per-chrom", type=int, default=25)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--support", type=int, default=3)
    ap.add_argument("--model", default=None, help=".npz weights (default: "
                    "random init written to the workdir)")
    ap.add_argument("--keep", default=None, help="workdir to keep (default: "
                    "a tmpdir, removed on exit); reused as a fixture cache")
    ap.add_argument("--fast-genome", action="store_true",
                    help="numpy-based base generation (WGS-scale fixtures)")
    ap.add_argument("--stream", action="store_true",
                    help="per-chromosome streaming fixture generation "
                         "(whole-genome scale: memory bounded by the "
                         "largest chromosome's reads, not the genome's)")
    ap.add_argument("--human", action="store_true",
                    help="GRCh38-shaped 24-chromosome ~3.09 Gb genome "
                         "(overrides --chroms/--mb; forces --fast-genome "
                         "and --stream — the per-base/in-memory paths are "
                         "hours and tens of GB at this scale); events "
                         "scale with chromosome length via --events-per-mb")
    ap.add_argument("--events-per-mb", type=float, default=8.0,
                    help="event density for --human (default 8/Mb = "
                         "1/125 kb, the ~25k-record whole-genome class)")
    ap.add_argument("--noise", choices=["hifi", "ont"], default=None,
                    help="realistic read noise (svision_tpu_torch.noise): donor "
                         "SNPs/small indels + per-instrument sequencing "
                         "errors + mapq variation")
    ap.add_argument("--gt", action="store_true",
                    help="plant het/hom genotypes (alternating 0/1 and 1/1) "
                         "and score GT concordance on matched simple events; "
                         "pair with --cli-extra=--tdup_gt for the het-tDUP "
                         "genotyper fix (docs/PERF.md round 4)")
    ap.add_argument("--collect-only", action="store_true",
                    help="stop after the collection stage (host-side stress)")
    ap.add_argument("--cli-extra", default="",
                    help="comma-joined extra CLI flags passed through to the "
                    "pipeline, e.g. --cli-extra=--hash or "
                    "--cli-extra=--graph,--qname")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the CNN (default: %(default)s; raises "
                    "without a GPU unless cpu)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the CLI run with torch.profiler and report "
                    "the device's busy ms in it")
    args = ap.parse_args(argv)
    if args.human:
        args.fast_genome = args.stream = True
    cli_extra = [f for f in args.cli_extra.split(",") if f]
    if not args.collect_only:
        # no GPU, no run: fail before minutes of simulation
        from svision_tpu_torch.timing import device_label
        from svision_tpu_torch.device import resolve_device
        device = device_label(resolve_device(args.device))

    import tempfile
    workdir = args.keep or tempfile.mkdtemp(prefix="svte2e_")
    os.makedirs(workdir, exist_ok=True)

    if args.human:
        print(f"[sim] human-shaped 24-chrom 3.09 Gb @ {args.coverage}x, "
              f"{args.events_per_mb}/Mb events -> {workdir}")
    else:
        print(f"[sim] {args.chroms} x {args.mb} Mb @ {args.coverage}x, "
              f"{args.events_per_chrom} events/chrom -> {workdir}")
    genome, bam, events, genotypes, t_sim = build_inputs(
        workdir, args.chroms, args.mb, args.coverage, args.events_per_chrom,
        fast_genome=args.fast_genome, noise=args.noise, gt=args.gt,
        stream=args.stream, human=args.human, events_per_mb=args.events_per_mb)
    bam_mb = os.path.getsize(bam) / 1e6
    print(f"[sim] done in {t_sim:.1f}s ({bam_mb:.1f} MB BAM)")

    weights = args.model
    if weights is None:
        from svision_tpu_torch.models.alexnet import init_params
        from svision_tpu_torch.models.checkpoint import save_params
        weights = os.path.join(workdir, "w.npz")
        save_params(init_params(0), weights)

    import svision_tpu_torch.cli as cli
    host = {"host_cpus": os.cpu_count(),
            "host_cpus_affinity": len(os.sched_getaffinity(0)),
            "threads": args.threads}

    outdir = os.path.join(workdir, "out")
    profile_dir = os.path.join(workdir, "profile")
    if args.profile:
        cli_extra = cli_extra + ["--profile", profile_dir]
    t0 = time.time()
    options = cli.parse_arguments([
        "-o", outdir, "-b", bam, "-g", genome, "-m", weights,
        "-n", "e2e", "-s", str(args.support), "-t", str(args.threads),
        "--device", args.device] + cli_extra)

    if args.collect_only:
        # host-side stress: collection only, no device attach
        from svision_tpu_torch.io.bam import BamReader
        from svision_tpu_torch.io.fasta import FastaFile
        br = BamReader(bam); ref = FastaFile(genome)
        tasks = cli.build_task_list(br, ref, options)
        wins = [(c, p, s, e) for c, parts in tasks.items()
                for p, (s, e) in enumerate(parts)]
        n_reads = sum(m for _, m, _ in br.get_index_statistics())
        t0 = time.time()
        if args.threads > 1:
            from svision_tpu_torch.utils.hostpool import host_only_pool
            pool = host_only_pool(args.threads)
            futs = [pool.submit(cli._collect_worker,
                                (options, bam, c, p, s, e))
                    for c, p, s, e in wins]
            res = [f.result() for f in futs]
            pool.shutdown()
        else:
            from svision_tpu_torch.collect.window import run_detect
            res = [run_detect(options, bam, c, p, s, e, bam=br, ref=ref)
                   for c, p, s, e in wins]
        wall = time.time() - t0
        report = {
            "mode": "collect_only", **host, "n_reads": n_reads,
            "wall_s": round(wall, 1),
            "reads_per_s": round(n_reads / wall, 1),
            "windows": len(res),
            "failed": sum(1 for r in res if r.error),
            "signatures": sum(r.n_signatures for r in res),
            "clusters": sum(r.n_clusters for r in res),
            "candidates": sum(len(r.candidates) for r in res),
        }
        print(json.dumps(report, indent=2))
        return report

    vcf = cli.run_pipeline(options)
    wall = time.time() - t0

    m = cli.LAST_METRICS
    from svision_tpu_torch.io.bam import BamReader
    br = BamReader(bam)
    n_reads = sum(mapped for _, mapped, _ in br.get_index_statistics())
    br.close()

    from svision_tpu_torch.evaluate import score_vcf
    res = score_vcf(vcf, events, tol=1500, truth_gt=genotypes)

    import resource
    rss_self = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rss_kids = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    report = {
        "device": device, **host,
        "chroms": "human24" if args.human else args.chroms,
        "mb_per_chrom": "grch38-shaped" if args.human else args.mb,
        "coverage": args.coverage, "noise": args.noise,
        "bam_mb": round(bam_mb, 1),
        "n_reads": n_reads, "planted_events": len(events),
        "wall_s": round(wall, 1),
        "reads_per_s": round(n_reads / wall, 1),
        "stage_s": {k: round(v, 2) for k, v in m.timers.items()},
        "counters": {k: int(v) for k, v in m.counters.items()},
        "peak_rss_gb": round(rss_self / 1e6, 2),
        "peak_rss_child_gb": round(rss_kids / 1e6, 2),
        "locus_recall": res["recall"], "locus_precision": res["precision"],
        "per_type": {k: f"{v['tp']}/{v['tp'] + v['fn']}"
                     for k, v in sorted(res["per_type"].items())},
        "vcf": vcf,
    }
    # breakpoint-resolution axis: |dpos|/|dlen| distributions over matched
    # components + independent strict-tolerance re-matches (VERDICT r4 #4)
    report["bkp"] = res.get("bkp")
    report["strict_recall"] = res.get("strict_recall")
    if args.profile and args.device != "cpu":
        report["profile"] = trace_busy(os.path.join(profile_dir, "trace.json"))
    if genotypes is not None:
        report["gt_concordance"] = res["gt_concordance"]
        report["gt_eval"] = res["gt_eval"]
        report["gt_correct"] = res["gt_correct"]
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
