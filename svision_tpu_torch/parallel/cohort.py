"""Multi-sample cohort calling.

Counterpart of the JAX package's parallel/cohort.py, on the PyTorch engine.
The reference is strictly single-sample; cohort scale-out is built on the
same sharded machinery (parallel/dist.py): (sample, chromosome) pairs are
round-robined across shards (assign_cohort), each shard runs collection +
device inference for its pairs, per-sample VCFs are merged exactly like
single-sample runs, and a final cross-sample merge unifies matching sites
into ONE multi-sample VCF with a genotype column per sample.

Cross-sample site matching: same chromosome + same refined SVTYPE, start
within ``merge_dist`` (default 1 kb, the reference's sub-cluster scale,
cluster_signatures.py:12-28) and size ratio >= 0.7 (the colinearity
tolerance of output_clusters.py:11-26). Greedy in coordinate order, so the
merge is deterministic for any shard count.

Run as:  python -m svision_tpu_torch.parallel.cohort -o OUT -g REF.fa \
             -m MODEL --samples A=a.bam B=b.bam [--num-shards N --shard-id K]
             [--coordinator HOST:PORT] [--device cpu]
Each shard process runs its engine on the GPUs it can see
(CUDA_VISIBLE_DEVICES per process); without a GPU it fails unless given
--device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional

from svision_tpu_torch.cli import RunOptions
from svision_tpu_torch.parallel.dist import (assign_cohort, init_distributed,
                                             merge_all, process_count,
                                             shutdown_distributed)


@dataclasses.dataclass
class CohortSite:
    chrom: str
    start: int
    end: int
    svtype: str
    alt: str
    qual: str
    filter: str
    info: str
    # sample name -> "GT:DR:DV"
    calls: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return max(1, self.end - self.start)


def _sample_options(options: RunOptions, sample: str, bam_path: str
                    ) -> RunOptions:
    return dataclasses.replace(
        options, sample=sample, bam_path=bam_path,
        out_path=os.path.join(options.out_path, sample))


def run_cohort_shard(samples: Dict[str, str], options: RunOptions,
                     shard_id: int = 0, num_shards: int = 1
                     ) -> Dict[str, List[str]]:
    """Run this shard's (sample, chrom) pairs on options.device (and the
    --mesh devices); returns {sample: chrom list} actually processed here.
    Fragments land under out/{sample}/predict_results so each sample merges
    exactly like a single-sample run."""
    from svision_tpu_torch.cli import build_task_list
    from svision_tpu_torch.collect.window import run_detect
    from svision_tpu_torch.infer.aggregate import predict_chromosome
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.io.bam import BamReader
    from svision_tpu_torch.io.fasta import FastaFile
    from svision_tpu_torch.models.checkpoint import load_params
    from svision_tpu_torch.parallel.mesh import resolve_mesh

    ref = FastaFile(options.genome)
    params = load_params(options.model_path)
    engine = InferenceEngine(params, batch_size=options.batch_size,
                             bf16=options.bf16, device=options.device,
                             devices=resolve_mesh(options.mesh,
                                                  options.device))
    warmup_thread = engine.warmup_async()

    # all samples share one chromosome universe for deterministic assignment
    readers = {name: BamReader(path) for name, path in samples.items()}
    tasks_by_sample = {}
    all_chroms: List[str] = []
    for name, bam in readers.items():
        s_opts = _sample_options(options, name, samples[name])
        tasks_by_sample[name] = build_task_list(bam, ref, s_opts)
        for c in tasks_by_sample[name]:
            if c not in all_chroms:
                all_chroms.append(c)

    pairs = assign_cohort(list(samples), all_chroms, num_shards, shard_id)
    done: Dict[str, List[str]] = {}
    for sample, chrom in pairs:
        tasks = tasks_by_sample[sample]
        if chrom not in tasks:
            continue
        s_opts = _sample_options(options, sample, samples[sample])
        predict_dir = os.path.join(s_opts.out_path, "predict_results")
        os.makedirs(predict_dir, exist_ok=True)
        bam = readers[sample]
        cands = []
        for part, (s, e) in enumerate(tasks[chrom]):
            res = run_detect(s_opts, s_opts.bam_path, chrom, part, s, e,
                             bam=bam, ref=ref)
            if res.error:
                # CLI parity (SURVEY.md §5.3): log + one retry rather than
                # silently dropping the window's calls
                logging.warning("cohort %s window %s part %s failed, "
                                "retrying: %s", sample, chrom, part,
                                res.error)
                res = run_detect(s_opts, s_opts.bam_path, chrom, part, s, e,
                                 bam=bam, ref=ref)
                if res.error:
                    logging.error("cohort %s window %s part %s failed: %s",
                                  sample, chrom, part, res.error)
            cands.extend(res.candidates)
        if warmup_thread is not None:
            warmup_thread.join()
            warmup_thread = None
        out_prefix = os.path.join(predict_dir,
                                  f"{chrom}.predict.s{s_opts.min_support}")
        predict_chromosome(cands, engine, out_prefix, bam, s_opts)
        done.setdefault(sample, []).append(chrom)
    if warmup_thread is not None:
        warmup_thread.join()
    return done


def merge_cohort_samples(samples: Dict[str, str], options: RunOptions
                         ) -> Dict[str, str]:
    """Per-sample merged VCFs (host-0 step after all shards finish)."""
    from svision_tpu_torch.cli import build_task_list
    from svision_tpu_torch.io.bam import BamReader
    from svision_tpu_torch.io.fasta import FastaFile

    ref = FastaFile(options.genome)
    out = {}
    for name, path in samples.items():
        s_opts = _sample_options(options, name, path)
        chroms = list(build_task_list(BamReader(path), ref, s_opts).keys())
        out[name] = merge_all(s_opts, chroms)
    return out


def _parse_records(vcf_path: str) -> List[CohortSite]:
    sites = []
    for line in open(vcf_path):
        if line.startswith("#") or not line.strip():
            continue
        p = line.rstrip("\n").split("\t")
        info = {kv.split("=", 1)[0]: kv.split("=", 1)[1]
                for kv in p[7].split(";") if "=" in kv}
        sites.append(CohortSite(
            chrom=p[0], start=int(p[1]), end=int(info.get("END", p[1])),
            svtype=info.get("SVTYPE", "."), alt=p[4], qual=p[5],
            filter=p[6], info=p[7], calls={}))
        sites[-1].calls["__self__"] = p[9] if len(p) > 9 else "./.:0:0"
    return sites


def merge_cohort_vcfs(sample_vcfs: Dict[str, str], out_path: str,
                      options: RunOptions, ref=None,
                      merge_dist: int = 1000, size_ratio: float = 0.7) -> str:
    """Unify per-sample VCFs into one multi-sample VCF."""
    from svision_tpu_torch.io.fasta import FastaFile
    from svision_tpu_torch.call.vcfout import vcf_header_lines

    names = list(sample_vcfs)
    merged: List[CohortSite] = []
    for name in names:
        for site in _parse_records(sample_vcfs[name]):
            call = site.calls.pop("__self__")
            match = None
            for prev in merged:
                if prev.chrom != site.chrom or prev.svtype != site.svtype:
                    continue
                if name in prev.calls:
                    continue
                if abs(prev.start - site.start) > merge_dist:
                    continue
                ratio = min(prev.size, site.size) / max(prev.size, site.size)
                if ratio < size_ratio:
                    continue
                match = prev
                break
            if match is None:
                site.calls = {name: call}
                merged.append(site)
            else:
                match.calls[name] = call

    if ref is None:
        ref = FastaFile(options.genome)
    # header contig order, not lexicographic: chr2 before chr10, or tabix/
    # bcftools reject the cohort VCF as unsorted relative to ##contig lines
    rank = {name: i for i, name in enumerate(ref.references)}
    merged.sort(key=lambda s: (rank.get(s.chrom, len(rank)), s.chrom,
                               s.start, s.end, s.svtype))
    header = vcf_header_lines(ref, "\t".join(names), options.graph)
    header.insert(-1, '##INFO=<ID=SUPP,Number=1,Type=Integer,'
                  'Description="Number of samples carrying the SV">')
    header.insert(-1, '##INFO=<ID=SUPP_VEC,Number=1,Type=String,'
                  'Description="Per-sample presence vector">')
    with open(out_path, "w") as fh:
        for line in header:
            print(line, file=fh)
        for i, site in enumerate(merged):
            vec = "".join("1" if n in site.calls else "0" for n in names)
            info = (f"{site.info};SUPP={len(site.calls)};SUPP_VEC={vec}")
            cols = [site.calls.get(n, "./.:0:0") for n in names]
            print(f"{site.chrom}\t{site.start}\t{i}\tN\t{site.alt}\t"
                  f"{site.qual}\t{site.filter}\t{info}\tGT:DR:DV\t"
                  + "\t".join(cols), file=fh)
    return out_path


def _barrier_all_shards(out_path: str, shard_id: int, num_shards: int,
                        timeout_s: float = 3600.0) -> None:
    """Wait until every shard has finished its compute phase.

    Shards are normally launched as independent processes over a shared
    filesystem (the same assumption merge_all makes), so the barrier is
    done-file based: each shard drops shards/shard{K}.done and shard 0
    polls for the full set. When a process group spans the shards,
    torch.distributed.barrier() is used instead — entered by EVERY shard,
    so nobody blocks on a one-sided collective."""
    if process_count() > 1:
        import torch.distributed as tdist
        tdist.barrier()
        return
    sdir = os.path.join(out_path, "shards")
    os.makedirs(sdir, exist_ok=True)
    mine = os.path.join(sdir, f"shard{shard_id}.done")
    with open(mine, "w") as fh:
        fh.write("done\n")
    if shard_id != 0:
        return
    want = {os.path.join(sdir, f"shard{k}.done") for k in range(num_shards)}
    deadline = time.time() + timeout_s
    while not all(os.path.exists(p) for p in want):
        if time.time() > deadline:
            missing = [p for p in want if not os.path.exists(p)]
            raise TimeoutError(
                f"cohort merge barrier: shards not finished after "
                f"{timeout_s:.0f}s: {missing}")
        time.sleep(0.5)


def run_cohort(samples: Dict[str, str], options: RunOptions,
               num_shards: int = 1, shard_id: Optional[int] = None) -> str:
    """Full cohort pipeline for one process. With shard_id=None (or shard 0
    of 1) this process does everything; in a multi-process launch every
    process calls with its own shard_id and only shard 0 merges, after a
    barrier (done-files on the shared filesystem, or the process group's
    gather when one spans the shards)."""
    my_shard = 0 if shard_id is None else shard_id
    if num_shards > 1:
        # clear this shard's done-file from any previous run before compute
        # starts, so a relaunch cannot satisfy the barrier with stale files
        # (shards are expected to be launched together, as one job)
        stale = os.path.join(options.out_path, "shards",
                             f"shard{my_shard}.done")
        if os.path.exists(stale):
            os.remove(stale)
    run_cohort_shard(samples, options, my_shard, num_shards)

    if process_count() > 1:
        # non-shared-FS finish: every shard's per-sample fragments travel to
        # process 0 over the process group (itself a full barrier), so
        # process 0's out dir looks like a shared-filesystem run before
        # merging
        from svision_tpu_torch.parallel.dist import (
            gather_cohort_fragments_to_host0)
        gather_cohort_fragments_to_host0(options.out_path, list(samples))
    elif num_shards > 1:
        _barrier_all_shards(options.out_path, my_shard, num_shards)
    if my_shard != 0:
        return ""
    per_sample = merge_cohort_samples(samples, options)
    out = os.path.join(
        options.out_path,
        f"cohort.svision.s{options.min_support}.vcf")
    return merge_cohort_vcfs(per_sample, out, options)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="svision-tpu multi-sample cohort caller (PyTorch/CUDA)")
    ap.add_argument("-o", dest="out_path", type=os.path.abspath, required=True)
    ap.add_argument("-g", dest="genome", type=os.path.abspath, required=True)
    ap.add_argument("-m", dest="model_path", type=os.path.abspath, required=True)
    ap.add_argument("--samples", nargs="+", required=True,
                    metavar="NAME=BAM", help="sample name=bam path pairs")
    ap.add_argument("-s", dest="min_support", type=int, default=5)
    ap.add_argument("-t", dest="thread_num", type=int, default=1)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--exact", dest="bf16", action="store_false", default=True,
                    help="Run the CNN in f32 (reference-faithful numerics) "
                    "instead of the default bf16 fast path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Device for the CNN (default: %(default)s)")
    ap.add_argument("--tdup_gt", action="store_true", default=False,
                    help="genotype het tandem duplications with the INS/DUP "
                    "full-span reference-read rule (the reference matches "
                    "'tDUP' against neither rule, so every het tDUP is "
                    "called 1/1; see call/genotype.py)")
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--shard-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="optional process-group rendezvous (gloo over TCP); "
                    "when given, shards need NO shared filesystem: "
                    "per-sample fragments are gathered to process 0 over "
                    "the process group (which is also the merge barrier) "
                    "before the cohort merge")
    ns = ap.parse_args(argv)

    samples = {}
    for item in ns.samples:
        name, path = item.split("=", 1)
        samples[name] = os.path.abspath(path)
    options = RunOptions(out_path=ns.out_path, genome=ns.genome,
                         model_path=ns.model_path, min_support=ns.min_support,
                         thread_num=ns.thread_num, tdup_gt=ns.tdup_gt,
                         batch_size=ns.batch_size, bf16=ns.bf16,
                         device=ns.device).normalized()
    os.makedirs(ns.out_path, exist_ok=True)
    if ns.coordinator:
        init_distributed(coordinator=ns.coordinator,
                         num_processes=ns.num_shards,
                         process_id=ns.shard_id or 0)
    try:
        out = run_cohort(samples, options, num_shards=ns.num_shards,
                         shard_id=ns.shard_id)
    finally:
        shutdown_distributed()
    if out:
        print(out)


if __name__ == "__main__":
    main()
