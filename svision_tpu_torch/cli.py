"""Command-line driver: the `SVision` entry point, on a CUDA GPU.

Counterpart of the JAX package's cli.py: the same flags and the same
pipeline, with the PyTorch engine (infer/engine.py) in place of the JAX one.
Port-specific: --device {cuda,cpu} (cuda by default; a run never falls back
to the CPU unless asked), --profile writes a torch.profiler trace and the
program's own spans (trace.py), and --jax-cache is accepted and ignored. A
--mesh of N devices runs the engine data-parallel over N GPUs (N CPU
replicas with --device cpu);
--num_shards/--shard_id/--merge_shards and --coordinator run the genome
sharded across processes (parallel/dist.py, over torch.distributed's gloo
backend). torch stays out of this module's top level so that the spawn
workers of -t N stay light.

Flag surface and pipeline staging mirror the reference CLI (SVision:27-395):
window task list -> collection -> prediction -> QUAL-rescaled merged VCF ->
optional graph step. Differences by design:
  * candidates flow in memory (bed files only under --debug)
  * one device inference engine is shared across chromosomes (the reference
    rebuilds a TF session per chromosome per process, SVision:311-323)
  * worker errors are logged with the failing window instead of swallowed
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import datetime
import logging
import os
import shutil
import sys
from time import localtime, strftime
from typing import Dict, List, Optional, Tuple

import numpy as np

from svision_tpu_torch import __version__, REFERENCE_VERSION
from svision_tpu_torch.config import Options
from svision_tpu_torch.collect.window import (WindowResult, cache_valid, dump_bed,
                                        load_bed, run_detect,
                                        write_cache_params)
from svision_tpu_torch.io.bam import BamReader
from svision_tpu_torch.io.fasta import FastaFile

# Metrics of the most recent run_pipeline call (benches/tooling).
LAST_METRICS = None


@dataclasses.dataclass
class RunOptions(Options):
    """Options plus the port's device choice."""
    device: str = "cuda"


def parse_arguments(arguments=None) -> Options:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description=f"svision-tpu {__version__} (SVision v{REFERENCE_VERSION} "
                    "capabilities, TPU-native)\n\nShort Usage: svision-tpu "
                    "[parameters] -o <output path> -b <input bam path> "
                    "-g <reference> -m <model path>")

    req = parser.add_argument_group("Input/Output parameters")
    req.add_argument("-o", dest="out_path", type=os.path.abspath, required=True,
                     help="Absolute path to output")
    req.add_argument("-b", dest="bam_path", type=os.path.abspath, required=True,
                     help="Absolute path to bam file")
    req.add_argument("-m", dest="model_path", type=os.path.abspath,
                     required=True, help="Absolute path to CNN predict model "
                     "(TF1 ckpt prefix or .npz)")
    req.add_argument("-g", dest="genome", type=os.path.abspath, required=True,
                     help="Absolute path to your reference genome "
                     "(.fai required in the directory)")
    req.add_argument("-n", dest="sample", type=str, required=True,
                     help="Name of the BAM sample name")

    opt = parser.add_argument_group("Optional parameters")
    opt.add_argument("-t", dest="thread_num", type=int, default=1,
                     help="Thread numbers (default: %(default)s)")
    opt.add_argument("-s", dest="min_support", type=int, default=5,
                     help="Minimum support read number required for SV "
                     "calling (default: %(default)s)")
    opt.add_argument("-c", dest="chrom", type=str, default=None,
                     help="Specific region (chr1:xxx-xxx) or chromosome "
                     "(chr1) to detect")
    opt.add_argument("--hash", action="store_true", default=False,
                     help="Activate local realignment for unmapped sequences")
    opt.add_argument("--qname", action="store_true", default=False,
                     help="Report support names for each events")
    opt.add_argument("--graph", action="store_true", default=False,
                     help="Report graph for events")
    opt.add_argument("--contig", action="store_true", default=False,
                     help="Activate contig mode")
    opt.add_argument("--debug", action="store_true", default=False,
                     help="Activate debug mode and keep intermedia outputs")
    opt.add_argument("--bgzip", action="store_true", default=False,
                     help="bgzip-compress the final VCF and write a tabix "
                     ".tbi index (first-party; equivalent to "
                     "'bgzip f.vcf && tabix -p vcf f.vcf.gz')")
    opt.add_argument("--resume", action="store_true", default=False,
                     help="Cache per-window candidate beds under "
                     "<out>/segments and reuse them on rerun (the reference "
                     "recomputes everything, SVision:370-372)")
    opt.add_argument("--profile", dest="profile_dir", type=str, default=None,
                     help="Write a torch.profiler trace of the prediction "
                     "stage to this directory (trace.json), and the "
                     "program's own spans of it beside (spans.json)")
    opt.add_argument("--jax-cache", dest="jax_cache", type=str, default=None,
                     help="Accepted for command-line compatibility with "
                     "svision-tpu and ignored")
    opt.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="Device for the CNN (default: %(default)s; cpu "
                     "runs the kernels' plain PyTorch versions)")
    opt.add_argument("--dotplots", action="store_true", default=False,
                     help="Dump a grayscale read-vs-reference dotplot PNG "
                     "per multi-segment read under <out>/dotplots (the "
                     "reference's dead debug_plot, "
                     "collect_signatures.py:103-111)")
    opt.add_argument("--cluster", action="store_true", default=False,
                     help="Merge nearby Uncovered records of the same SV "
                     "type into clustered PASS calls (the reference's "
                     "commented v2.0 path, SVision:48-49,389-394)")
    opt.add_argument("--mechanism", action="store_true", default=False,
                     help="Annotate MECHANISM with RepeatMasker/TRF TE/VNTR "
                     "evidence (the reference's commented v2.0 pipeline, "
                     "SVision:64-69,380-394)")
    opt.add_argument("--rpmask", type=str, default="RepeatMasker",
                     help="Path to the RepeatMasker binary (default: "
                     "%(default)s)")
    opt.add_argument("--trf", type=str, default="trf",
                     help="Path to the TRF binary (default: %(default)s)")

    col = parser.add_argument_group("Collect parameters")
    col.add_argument("--min_mapq", type=int, default=10)
    col.add_argument("--min_sv_size", type=int, default=50)
    col.add_argument("--max_sv_size", type=int, default=1000000)
    col.add_argument("--window_size", type=int, default=10000000)

    clu = parser.add_argument_group("Cluster parameters")
    clu.add_argument("--patition_max_distance", type=int, default=5000)
    clu.add_argument("--cluster_max_distance", type=float, default=0.3)

    pre = parser.add_argument_group("Predict parameters")
    pre.add_argument("--batch_size", type=int, default=128,
                     help="Rows a batch on each inference device (default: "
                     "%(default)s)")
    pre.add_argument("--exact", dest="bf16", action="store_false", default=True,
                     help="Run the CNN in f32 (reference-faithful numerics) "
                     "instead of the default bf16 fast path")
    pre.add_argument("--mesh", type=str, default="auto",
                     help="Data-parallel inference devices: 'auto' (every "
                     "visible GPU), 'none' (one device) or a device count "
                     "(CPU replicas with --device cpu); each device takes "
                     "whole batches of --batch_size rows (default: "
                     "%(default)s)")

    gt = parser.add_argument_group("Genotype parameters")
    gt.add_argument("--min_gt_depth", type=int, default=4)
    gt.add_argument("--homo_thresh", type=float, default=0.8)
    gt.add_argument("--hete_thresh", type=float, default=0.2)
    gt.add_argument("--tdup_gt", action="store_true", default=False,
                    help="genotype tDUP calls with the INS/DUP "
                         "reference-read rule. The reference's genotyper "
                         "matches 'tDUP' against neither of its rules "
                         "(genotype.py:45-54), so DR is always 0 and every "
                         "het tandem duplication is called 1/1; default "
                         "keeps that behavior for VCF parity")

    hsh = parser.add_argument_group("Hash table parameters")
    hsh.add_argument("--k_size", type=int, default=10)
    hsh.add_argument("--min_accept", type=int, default=50)
    hsh.add_argument("--max_hash_len", type=int, default=1000)

    dst = parser.add_argument_group(
        "Distribution parameters (multi-host genome-axis sharding)")
    dst.add_argument("--num_shards", type=int, default=1,
                     help="Total shard count; this process runs only its "
                     "round-robin share of chromosomes")
    dst.add_argument("--shard_id", type=int, default=0)
    dst.add_argument("--merge_shards", action="store_true", default=False,
                     help="Merge all shards' fragments into the final VCF "
                     "(run once after every shard finished)")
    dst.add_argument("--coordinator", type=str, default=None,
                     help="distributed coordinator 'host:port': run this "
                     "shard AND the final merge in one launch with NO shared "
                     "filesystem — fragments are gathered to process 0 over "
                     "the distributed channel (out dirs may be disjoint)")

    ns = parser.parse_args(arguments)
    return RunOptions(**vars(ns)).normalized()


def build_task_list(bam: BamReader, ref: FastaFile, options: Options
                    ) -> Dict[str, List[Tuple[int, int]]]:
    """Genomic window task list (SVision:159-242, incl. the region-mode
    window-offset quirk: windows are relative to 0, not the region start)."""
    window_size = options.window_size
    tasks: Dict[str, List[Tuple[int, int]]] = {}
    all_possible_chrs = ref.references

    if options.chrom is None:
        # reference parity: every indexed contig is windowed, with no
        # mapped-count filter (SVision:172-177 iterates ref_info without
        # checking ele[1]); refs absent from the index entirely are already
        # dropped by get_index_statistics
        for chrom, _mapped, _unmapped in bam.get_index_statistics():
            if chrom not in all_possible_chrs:
                continue
            local_len = bam.get_reference_length(chrom)
            if options.contig:
                window_size = local_len
            if local_len < window_size:
                tasks.setdefault(chrom, []).append((0, local_len))
            else:
                pos = 0
                for _ in range(int(local_len / window_size)):
                    tasks.setdefault(chrom, []).append((pos, pos + window_size))
                    pos += window_size
                if pos < local_len:
                    tasks.setdefault(chrom, []).append((pos, local_len))
    else:
        chrom = options.chrom
        if chrom in all_possible_chrs:
            start, end = 0, bam.get_reference_length(chrom)
        else:
            name, cords = chrom.split(":")
            chrom = name
            start, end = int(cords.split("-")[0]), int(cords.split("-")[1])
        tasks[chrom] = []
        region_length = end - start + 1
        if region_length < window_size:
            tasks[chrom].append((start, end))
        else:
            pos = 0
            for _ in range(int(region_length / window_size)):
                tasks[chrom].append((pos, pos + window_size))
                pos += window_size
            if pos < region_length:
                tasks[chrom].append((pos, region_length))
    return tasks


def _collect_worker(args):
    options, bam_path, chrom, part, start, end = args
    return run_detect(options, bam_path, chrom, part, start, end)


def _aggregate_worker(args):
    """Pool worker for the host half of prediction (region aggregation +
    genotyping + VCF-fragment write); opens its own BamReader."""
    candidates, preds, softs, out_prefix, bam_path, options = args
    from svision_tpu_torch.infer.aggregate import aggregate_chromosome
    with BamReader(bam_path) as worker_bam:
        aggregate_chromosome(candidates, preds, softs, out_prefix,
                             worker_bam, options)
    return out_prefix


def finalize_vcf(merged_vcf_path: str, work_dir: str, options: Options) -> str:
    """Post-merge steps shared by every merge site (single-process,
    --merge_shards, --coordinator host 0): the --graph annotation step
    (SVision:341-359 — which then DELETES the plain VCF, reference
    semantics), --mechanism, --cluster, and --bgzip. Returns the final VCF
    path. Before round 3 the sharded merge paths skipped everything but
    bgzip, so a sharded --graph run never produced its .graph.vcf."""
    import shutil

    final_vcf = merged_vcf_path
    if options.graph:
        from svision_tpu_torch.collect.graph import collect_csv_same_format
        logging.info("**** Step3 Computing graphs ****")
        graph_out_path = os.path.join(work_dir, "graphs")
        collect_csv_same_format(graph_out_path, merged_vcf_path, options)
        for entry in os.listdir(graph_out_path):
            full = os.path.join(graph_out_path, entry)
            if os.path.isdir(full):
                shutil.rmtree(full)
        os.remove(merged_vcf_path)
        final_vcf = os.path.join(
            work_dir, f"{options.sample}.svision.s{options.min_support}.graph.vcf")

    if options.mechanism:
        from svision_tpu_torch.call.annotation import annotate_mechanisms
        logging.info("**** Step4 Mechanism annotation ****")
        mech_dir = os.path.join(work_dir, "mechanism_out")
        rpmask_bin = shutil.which(options.rpmask)
        trf_bin = shutil.which(options.trf)
        if not rpmask_bin and not trf_bin:
            logging.warning("RepeatMasker/TRF binaries not found; parsing "
                            "pre-existing outputs under %s only", mech_dir)
        final_vcf = annotate_mechanisms(final_vcf, mech_dir, options,
                                        rpmask_bin=rpmask_bin,
                                        trf_bin=trf_bin)

    if options.cluster:
        from svision_tpu_torch.call.callset_cluster import cluster_original_callset
        logging.info("[Additional Func: cluster] Starting cluster original "
                     "callset......")
        cluster_out_file = os.path.join(
            work_dir, "{0}.svision.s{1}.clusterd.vcf".format(
                options.sample, options.min_support))
        n = cluster_original_callset(final_vcf, options.bam_path,
                                     cluster_out_file)
        logging.info("Clustered callset written to %s (%s merged clusters)",
                     cluster_out_file, n)

    if options.bgzip:
        from svision_tpu_torch.io.tabix import bgzip_vcf
        gz, tbi = bgzip_vcf(final_vcf)
        logging.info("bgzipped + indexed: %s (%s)", gz, tbi)
        final_vcf = gz
    return final_vcf


def run_pipeline(options: Options, engine=None) -> str:
    """Full pipeline; returns the path of the final VCF. `engine` is an
    optional caller-owned, already warm InferenceEngine; by default one is
    built from -m on options.device and the --mesh devices.

    Multi-host mode (--num_shards N --shard_id K): runs only this shard's
    chromosomes and returns the predict_results dir; a final --merge_shards
    invocation (shared filesystem) produces the VCF, or with --coordinator
    process 0 gathers the fragments and merges. Shard assignment is
    deterministic, so the N-shard merge is byte-identical to a 1-shard run
    (tests/test_torch_dist.py)."""
    from svision_tpu_torch.models.checkpoint import load_params
    from svision_tpu_torch.infer.aggregate import predict_chromosome
    from svision_tpu_torch.call.vcfout import cal_scores_max_min, merge_split_vcfs

    work_dir = options.out_path
    os.makedirs(work_dir, exist_ok=True)

    log_path = os.path.join(
        work_dir, "SVision_{}.log".format(strftime("%y%m%d_%H%M%S", localtime())))
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)-7.7s]  %(message)s",
        handlers=[logging.FileHandler(log_path, mode="w"),
                  logging.StreamHandler()])
    logging.info("**** Start svision-tpu, version %s (SVision v%s parity) ****",
                 __version__, REFERENCE_VERSION)
    logging.info("CMD: %s", " ".join(sys.argv))

    if options.merge_shards or options.num_shards > 1:
        from svision_tpu_torch.parallel import dist
        if options.coordinator and not options.merge_shards:
            merged = dist.run_distributed(options)
            if merged is None:      # non-zero process: fragments shipped
                logging.info("shard %d/%d done; fragments gathered to "
                             "process 0", options.shard_id, options.num_shards)
                return os.path.join(work_dir, "predict_results")
            return finalize_vcf(merged, work_dir, options)
        bam = BamReader(options.bam_path)
        ref = FastaFile(options.genome)
        chrom_order = list(build_task_list(bam, ref, options))
        if options.merge_shards:
            merged = dist.merge_all(options, chrom_order)
            return finalize_vcf(merged, work_dir, options)
        handled = dist.run_shard(options, options.shard_id,
                                 options.num_shards)
        logging.info("shard %d/%d finished chromosomes: %s",
                     options.shard_id, options.num_shards, handled)
        return os.path.join(work_dir, "predict_results")

    bam = BamReader(options.bam_path)
    ref = FastaFile(options.genome)

    if bam.header.get("HD", {}).get("SO") != "coordinate":
        logging.error("This is not a coordinate sorted BAM file")
        raise SystemExit(1)
    if not bam.has_index():
        logging.warning("Input BAM file is missing a valid index; window fetch"
                        " falls back to full scans (slow).")

    tasks = build_task_list(bam, ref, options)
    if not tasks:
        logging.error("No mapped reads in the BAM, please check your "
                      "reference input!")
        raise SystemExit(1)

    predict_results_dir = os.path.join(work_dir, "predict_results")
    os.makedirs(predict_results_dir, exist_ok=True)
    if options.graph:
        os.makedirs(os.path.join(work_dir, "graphs"), exist_ok=True)

    start_time = datetime.datetime.now()
    logging.info("**** Step1 Image coding and segmentation ****")

    segments_dir = os.path.join(work_dir, "segments")
    resume_cache = options.resume and cache_valid(segments_dir, options)
    if options.resume and not resume_cache and os.path.isdir(segments_dir):
        logging.warning("--resume: cached beds were produced with different "
                        "collection parameters or inputs; recomputing all "
                        "windows")
    dump_beds = options.debug or options.resume
    if dump_beds and not cache_valid(segments_dir, options):
        # Beds from a different configuration/input must not survive next to
        # the fresh sidecar: a partial overwrite (--debug with new params, a
        # region-mode run) would otherwise poison a later --resume.
        if os.path.isdir(segments_dir):
            for f in os.listdir(segments_dir):
                if f.endswith(".bed") or f == ".collect_params.json":
                    os.remove(os.path.join(segments_dir, f))
        # sidecar first, then beds land incrementally under it — everything
        # below it is always described by it (dump_bed skips errored windows)
        write_cache_params(segments_dir, options)

    def start_chrom(chrom: str, pool):
        """Submit (or inline-defer) a chromosome's windows; returns a list of
        cached WindowResults, Futures, or window specs to run inline."""
        items = []
        for part, (ts, te) in enumerate(tasks[chrom]):
            cached = (load_bed(segments_dir, chrom, part)
                      if resume_cache else None)
            if cached is not None:
                items.append(cached)
            elif pool is not None:
                try:
                    items.append(pool.submit(
                        _collect_worker,
                        (options, options.bam_path, chrom, part, ts, te)))
                except Exception as exc:
                    # a dead pool (e.g. spawn failure in an embedding host)
                    # must degrade to inline collection, not abort the run
                    logging.warning("worker pool unusable (%s); collecting "
                                    "%s part %s inline", exc, chrom, part)
                    items.append((chrom, part, ts, te))
            else:
                items.append((chrom, part, ts, te))
        return items

    def resolve_chrom(items) -> List[WindowResult]:
        """Materialize start_chrom's items, with the per-window retry
        (SURVEY.md §5.3)."""
        out: List[WindowResult] = []
        for item in items:
            if isinstance(item, WindowResult):
                out.append(item)
            elif isinstance(item, concurrent.futures.Future):
                out.append(item.result())
            else:
                chrom, part, ts, te = item
                out.append(run_detect(options, options.bam_path, chrom, part,
                                      ts, te, bam=bam, ref=ref))
        for i, r in enumerate(out):
            if not r.error:
                continue
            logging.warning("window %s part %s failed, retrying: %s",
                            r.chrom, r.part, r.error)
            s, e = tasks[r.chrom][r.part]
            out[i] = run_detect(options, options.bam_path, r.chrom, r.part,
                                s, e, bam=bam, ref=ref)
        return out

    from svision_tpu_torch.utils.metrics import Metrics
    metrics = Metrics()
    global LAST_METRICS   # introspection hook for benches/tooling
    LAST_METRICS = metrics

    logging.info("**** Step2 CNN prediction (pipelined with collection) ****")
    if engine is None:
        from svision_tpu_torch.infer.engine import InferenceEngine
        from svision_tpu_torch.parallel.mesh import resolve_mesh
        params = load_params(options.model_path)
        mesh = resolve_mesh(options.mesh, options.device)
        if mesh is not None:
            logging.info("inference mesh: %d devices (data-parallel)",
                         len(mesh))
        engine = InferenceEngine(params, batch_size=options.batch_size,
                                 bf16=options.bf16, device=options.device,
                                 devices=mesh)
        # Build the kernels, set up cuDNN and capture the engine's CUDA
        # graphs on a background thread while window collection proceeds.
        warmup_thread = engine.warmup_async()
    else:
        # serving mode (svision_tpu_torch.serve): a caller-owned engine is
        # already warm — model load and kernel build amortize across requests
        warmup_thread = None
    profile_ctx = contextlib.nullcontext()
    if options.profile_dir:
        profile_ctx = _torch_profile(options.profile_dir, engine.devices)

    # Producer/consumer pipeline (SURVEY.md §2.3 "PP"): window collection for
    # chromosome k+1.. proceeds in the process pool while chromosome k's
    # candidates run device inference. Per-chromosome ordering (and thus the
    # VCF) is identical to the sequential schedule.
    results: List[WindowResult] = []
    agg_futures: List = []
    pool = None
    agg_pool = None
    try:
        if options.thread_num > 1:
            # spawn, not fork: the parent has initialized torch (multithreaded)
            # by this point, and forking a multithreaded process can deadlock
            # the children. Workers only run host-side collection, and boot
            # without the device runtime (utils/hostpool.py).
            from svision_tpu_torch.utils.hostpool import host_only_pool
            pool = host_only_pool(options.thread_num)
            # aggregation gets its OWN worker: in the shared FIFO pool the
            # host half of chromosome k's prediction queues BEHIND all of
            # chromosome k+1's collection windows, serializing what should
            # overlap (the OS timeshares the extra process fine)
            agg_pool = host_only_pool(min(2, options.thread_num))
        with profile_ctx:
            chrom_order = list(tasks)
            inflight: List = []   # [(chrom, items)] in chrom_order
            depth = 2 if pool is not None else 1
            for chrom in chrom_order[:depth]:
                inflight.append((chrom, start_chrom(chrom, pool)))
            started = len(inflight)

            for chrom in chrom_order:
                if started < len(chrom_order):
                    nxt = chrom_order[started]
                    inflight.append((nxt, start_chrom(nxt, pool)))
                    started += 1
                entry_chrom, items = inflight.pop(0)
                assert entry_chrom == chrom
                with metrics.timer("collect"):
                    chrom_results = resolve_chrom(items)
                results.extend(chrom_results)
                if dump_beds:
                    # incremental: a crash mid-run keeps every finished
                    # chromosome's beds for --resume (dump is per-part atomic)
                    dump_bed(chrom_results, segments_dir)
                cands = []
                for res in sorted(chrom_results, key=lambda r: r.part):
                    cands.extend(res.candidates)

                if warmup_thread is not None:
                    with metrics.timer("compile_wait"):
                        warmup_thread.join()
                    warmup_thread = None
                out_prefix = os.path.join(
                    predict_results_dir,
                    f"{chrom}.predict.s{options.min_support}")
                if pool is not None:
                    # device half here; host half (aggregation + genotyping
                    # + fragment write) in the pool, overlapping the next
                    # chromosome's collection/inference — per-chrom output
                    # files are identical to the inline schedule
                    from svision_tpu_torch.infer.aggregate import (
                        aggregate_chromosome, candidates_to_specs)
                    with metrics.timer("predict"):
                        preds, softs = engine.predict_specs(
                            candidates_to_specs(cands))
                    try:
                        agg_futures.append(agg_pool.submit(
                            _aggregate_worker,
                            (cands, preds, softs, out_prefix,
                             options.bam_path, options)))
                    except Exception as exc:   # broken pool -> degrade
                        logging.warning("aggregate submit failed (%s); "
                                        "running inline", exc)
                        with metrics.timer("predict"):
                            aggregate_chromosome(cands, preds, softs,
                                                 out_prefix, bam, options)
                else:
                    with metrics.timer("predict"):
                        predict_chromosome(cands, engine, out_prefix, bam,
                                           options)
                metrics.count("images", len(cands))
            with metrics.timer("predict"):
                for fut in agg_futures:
                    fut.result()
            if warmup_thread is not None:
                # no chromosome ran: let the warm-up's captures finish
                # before the process goes on to exit
                warmup_thread.join()
    finally:
        if pool is not None:
            pool.shutdown()
        if agg_pool is not None:
            agg_pool.shutdown()

    failures = [r for r in results if r.error]
    for r in failures:
        logging.error("window %s part %s failed: %s", r.chrom, r.part, r.error)

    t_predict = datetime.datetime.now()
    logging.info("[Prediction finished] Cost time: %s",
                 int((t_predict - start_time).total_seconds()))
    metrics.count("windows", len(results))
    metrics.count("windows_failed", len(failures))
    metrics.count("signatures", sum(r.n_signatures for r in results))
    metrics.count("clusters", sum(r.n_clusters for r in results))
    metrics.count("candidates", sum(len(r.candidates) for r in results))
    logging.info("%s", metrics.summary())

    all_scores = cal_scores_max_min(predict_results_dir)
    if not all_scores:
        print("Empty output in the score file!!! Program exit")
        raise SystemExit(1)
    max_score, min_score = np.max(all_scores), np.min(all_scores)
    merged_vcf_path = os.path.join(
        work_dir, f"{options.sample}.svision.s{options.min_support}.vcf")
    merge_split_vcfs(predict_results_dir, merged_vcf_path, max_score,
                     min_score, list(tasks.keys()), ref, options)
    final_vcf = finalize_vcf(merged_vcf_path, work_dir, options)

    if not options.debug:
        shutil.rmtree(predict_results_dir, ignore_errors=True)

    t_final = datetime.datetime.now()
    logging.info("[All steps finished] Total Cost time: %ss",
                 int((t_final - start_time).total_seconds()))
    return final_vcf


@contextlib.contextmanager
def _torch_profile(out_dir: str, devices):
    """torch.profiler trace (CPU + CUDA activity) of the prediction stage,
    written to out_dir as a Chrome trace (trace.json), and the program's
    own spans of the same stage on the host and on `devices` (trace.py),
    written beside it as spans.json in the same format."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from svision_tpu_torch import trace
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof, \
            trace.recording(devices) as rec:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    rec.write_chrome(os.path.join(out_dir, "spans.json"))


def main(argv=None):
    options = parse_arguments(argv)
    run_pipeline(options)


if __name__ == "__main__":
    main()
