"""Multi-host orchestration: genomic-shard data parallelism.

Counterpart of the JAX package's parallel/dist.py. Chromosomes (or
(sample, chromosome) pairs in cohort mode) are assigned to shards; each
shard streams its BAM windows, runs collection + device inference for its
share, and writes per-chrom VCF fragments. The single cross-shard reduction
— QUAL min/max over all raw scores (SVision:330-334) — is the merger's scan
of the shared fragment directory, or, without a shared filesystem, follows
a gather of every shard's fragments to process 0.

Processes talk through torch.distributed with the gloo backend: everything
exchanged is host data (a pair of floats, byte blobs of fragment files), so
a device communicator would add copies for nothing. Each process runs its
own engine on the GPUs it can see (CUDA_VISIBLE_DEVICES per process).

Shard assignment is deterministic, so an N-shard run merges to a VCF
byte-identical to the 1-shard run (tests/test_torch_dist.py).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

# how long a process waits for the others to join or to reach a collective
TIMEOUT_S = 1800


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """gloo process group over tcp://coordinator (no-op when
    single-process). A failure raises: a shard never carries on alone."""
    if num_processes is None or num_processes <= 1:
        return
    if not coordinator:
        raise ValueError("a multi-process run needs --coordinator host:port")
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id or 0,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def shutdown_distributed() -> None:
    """Tear down the process group, if one is up."""
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def process_count() -> int:
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def process_index() -> int:
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


def assign_chroms(chroms: Sequence[str], num_shards: int, shard_id: int
                  ) -> List[str]:
    """Deterministic chromosome -> shard assignment (round-robin in canonical
    order). Prediction is chrom-granular in the reference too (SVision:311-323),
    so this keeps region grouping intact."""
    return [c for i, c in enumerate(chroms) if i % num_shards == shard_id]


def assign_cohort(samples: Sequence[str], chroms: Sequence[str],
                  num_shards: int, shard_id: int) -> List[Tuple[str, str]]:
    """Cohort mode: (sample, chrom) pairs round-robined across shards."""
    pairs = [(s, c) for s in samples for c in chroms]
    return [p for i, p in enumerate(pairs) if i % num_shards == shard_id]


def exchange_score_minmax(local_scores: np.ndarray) -> Tuple[float, float]:
    """Global (min, max) of QUAL scores across processes.

    Multi-process: all-gather of each process's (min, max) over gloo.
    Single process: local reduce.

    COLLECTIVE: when a process group spans several processes every process
    must call this (it blocks until all join). The merge path (merge_all)
    deliberately does NOT use it — fragments land on a shared filesystem
    and the merger's scan already sees every shard's scores — so merging
    from a single process never deadlocks."""
    if process_count() > 1:
        local = np.asarray(local_scores, np.float64)
        # fixed-size summary per process: (min, max); identity elements keep
        # empty shards neutral without corrupting the other side
        summary = torch.tensor([local.min(initial=np.inf),
                                local.max(initial=-np.inf)], dtype=torch.float64)
        gathered = [torch.empty_like(summary) for _ in range(process_count())]
        tdist.all_gather(gathered, summary)
        g = torch.stack(gathered)
        return float(g[:, 0].min()), float(g[:, 1].max())
    if local_scores.size == 0:
        return float("inf"), float("-inf")
    return float(np.min(local_scores)), float(np.max(local_scores))


def _pack_files(base_dir: str, relnames: Sequence[str]) -> bytes:
    """Serialize files (paths relative to base_dir) into one length-prefixed
    blob: [u32 n_files][per file: u32 name_len, name, u64 size, bytes]."""
    import struct
    parts = [struct.pack("<I", len(relnames))]
    for name in relnames:
        with open(os.path.join(base_dir, name), "rb") as fh:
            data = fh.read()
        enc = name.encode()
        parts.append(struct.pack("<I", len(enc)) + enc
                     + struct.pack("<Q", len(data)) + data)
    return b"".join(parts)


def _pack_fragments(out_path: str) -> bytes:
    """This shard's merge inputs as one blob (paths relative to out_path):
    predict_results VCF/score fragments plus, under --graph, the per-read
    GFA region dirs the graph step consumes (graphs/{region}/{read}.gfa)."""
    rels: List[str] = []
    pdir = os.path.join(out_path, "predict_results")
    if os.path.isdir(pdir):
        rels.extend(f"predict_results/{f}" for f in sorted(os.listdir(pdir))
                    if f.endswith(".vcf") or f.endswith(".score.txt"))
    gdir = os.path.join(out_path, "graphs")
    if os.path.isdir(gdir):
        for sub in sorted(os.listdir(gdir)):
            subp = os.path.join(gdir, sub)
            if os.path.isdir(subp):
                rels.extend(f"graphs/{sub}/{f}"
                            for f in sorted(os.listdir(subp))
                            if f.endswith(".gfa"))
    return _pack_files(out_path, rels)


def _unpack_fragments(blob: bytes, dest_dir: str) -> List[str]:
    import struct
    os.makedirs(dest_dir, exist_ok=True)
    (n,) = struct.unpack_from("<I", blob, 0)
    off = 4
    written = []
    for _ in range(n):
        (name_len,) = struct.unpack_from("<I", blob, off)
        off += 4
        name = blob[off:off + name_len].decode()
        off += name_len
        (size,) = struct.unpack_from("<Q", blob, off)
        off += 8
        # relative subdirs are allowed (cohort fragments arrive as
        # sample/predict_results/x.vcf) but traversal out of dest is not
        if (os.path.isabs(name) or os.path.normpath(name) != name
                or ".." in name.split("/")):
            raise ValueError(f"fragment name escapes dest dir: {name!r}")
        dest = os.path.join(dest_dir, name)
        os.makedirs(os.path.dirname(dest) or dest_dir, exist_ok=True)
        with open(dest, "wb") as fh:
            fh.write(blob[off:off + size])
        off += size
        written.append(name)
    return written


def _gather_blob_to_host0(blob_bytes: bytes) -> Optional[List[bytes]]:
    """All-gather one variable-length byte blob per process; returns the
    per-process blob list on process 0, None elsewhere. Two-phase (length
    exchange, then uint8 payloads padded to the longest) because fragment
    sizes differ per shard. COLLECTIVE: every process must call."""
    world = process_count()
    blob = torch.frombuffer(bytearray(blob_bytes), dtype=torch.uint8)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    tdist.all_gather(lens, torch.tensor([blob.numel()], dtype=torch.int64))
    longest = max(int(n) for n in lens)
    padded = torch.zeros(longest, dtype=torch.uint8)
    padded[:blob.numel()] = blob
    blobs = [torch.empty(longest, dtype=torch.uint8) for _ in range(world)]
    tdist.all_gather(blobs, padded)
    if process_index() != 0:
        return None
    return [b[:int(n)].numpy().tobytes() for b, n in zip(blobs, lens)]


def gather_fragments_to_host0(out_path: str) -> None:
    """Ship every shard's merge inputs (VCF/score fragments + --graph GFA
    region dirs) to process 0 over the process group — the
    non-shared-filesystem finish (the reference's merger re-reads per-chrom
    files from one directory, output.py:601-612; here the directory exists
    only on process 0).

    COLLECTIVE: every process must call this after its run_shard."""
    if process_count() <= 1:
        return
    blobs = _gather_blob_to_host0(_pack_fragments(out_path))
    if blobs is not None:
        for p in range(1, len(blobs)):
            names = _unpack_fragments(blobs[p], out_path)
            logging.info("gathered %d fragment files from shard %d",
                         len(names), p)


def gather_cohort_fragments_to_host0(out_path: str,
                                     samples: Sequence[str]) -> None:
    """Cohort-mode non-shared-filesystem finish: ship every shard's
    per-sample predict_results fragments to process 0 over the process
    group. Fragment names are prefixed with the sample
    ("{sample}/predict_results/{chrom}.predict.sN.vcf"), so process 0's out
    dir ends up laid out exactly as a shared-filesystem run and
    merge_cohort_samples needs no changes.

    COLLECTIVE: every process must call this after run_cohort_shard."""
    if process_count() <= 1:
        return
    rels: List[str] = []
    for name in sorted(samples):
        pdir = os.path.join(out_path, name, "predict_results")
        if os.path.isdir(pdir):
            rels.extend(f"{name}/predict_results/{f}"
                        for f in sorted(os.listdir(pdir))
                        if f.endswith(".vcf") or f.endswith(".score.txt"))
    blobs = _gather_blob_to_host0(_pack_files(out_path, rels))
    if blobs is not None:
        for p in range(1, len(blobs)):
            names = _unpack_fragments(blobs[p], out_path)
            logging.info("gathered %d cohort fragment files from shard %d",
                         len(names), p)


def run_distributed(options) -> Optional[str]:
    """One-command multi-host run WITHOUT a shared filesystem: join the
    process group at --coordinator, run this process's shard into its local
    out dir, all-gather the fragments, merge on process 0.

    Returns the merged VCF path on process 0, None on other processes."""
    from svision_tpu_torch.infer.engine import resolve_device
    # a shard without its device fails here, not after its peers have
    # joined and wait for it
    resolve_device(options.device)
    init_distributed(options.coordinator, options.num_shards,
                     options.shard_id)
    try:
        run_shard(options, options.shard_id, options.num_shards)
        gather_fragments_to_host0(options.out_path)
        if process_index() != 0:
            return None
    finally:
        shutdown_distributed()
    from svision_tpu_torch.cli import build_task_list
    from svision_tpu_torch.io.bam import BamReader
    from svision_tpu_torch.io.fasta import FastaFile
    chrom_order = list(build_task_list(BamReader(options.bam_path),
                                       FastaFile(options.genome), options))
    return merge_all(options, chrom_order)


def run_shard(options, shard_id: int, num_shards: int) -> List[str]:
    """Collection + prediction for this shard's chromosomes on
    options.device (and the --mesh devices); returns the chrom list
    handled. Fragments land in the shared predict_results dir under the
    same names the merger expects."""
    from svision_tpu_torch.cli import build_task_list
    from svision_tpu_torch.collect.window import run_detect
    from svision_tpu_torch.infer.aggregate import predict_chromosome
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.io.bam import BamReader
    from svision_tpu_torch.io.fasta import FastaFile
    from svision_tpu_torch.models.checkpoint import load_params
    from svision_tpu_torch.parallel.mesh import resolve_mesh

    # the engine first: a shard without its device fails before it writes
    # anything, and the warm-up overlaps the task list
    params = load_params(options.model_path)
    mesh = resolve_mesh(options.mesh, options.device)
    if mesh is not None:
        logging.info("shard %d inference mesh: %d devices (data-parallel)",
                     shard_id, len(mesh))
    engine = InferenceEngine(params, batch_size=options.batch_size,
                             bf16=options.bf16, device=options.device,
                             devices=mesh)
    warmup_thread = engine.warmup_async()

    bam = BamReader(options.bam_path)
    ref = FastaFile(options.genome)
    tasks = build_task_list(bam, ref, options)
    my_chroms = assign_chroms(list(tasks.keys()), num_shards, shard_id)

    predict_dir = os.path.join(options.out_path, "predict_results")
    os.makedirs(predict_dir, exist_ok=True)
    if options.graph:
        os.makedirs(os.path.join(options.out_path, "graphs"), exist_ok=True)
    for chrom in my_chroms:
        cands = []
        for part, (s, e) in enumerate(tasks[chrom]):
            res = run_detect(options, options.bam_path, chrom, part, s, e,
                             bam=bam, ref=ref)
            if res.error:
                # same policy as the CLI (SURVEY.md §5.3): log + one retry
                # instead of silently losing the window's calls
                logging.warning("shard %d window %s part %s failed, "
                                "retrying: %s", shard_id, chrom, part,
                                res.error)
                res = run_detect(options, options.bam_path, chrom, part, s,
                                 e, bam=bam, ref=ref)
                if res.error:
                    logging.error("shard %d window %s part %s failed: %s",
                                  shard_id, chrom, part, res.error)
            cands.extend(res.candidates)
        if warmup_thread is not None:
            warmup_thread.join()
            warmup_thread = None
        out_prefix = os.path.join(predict_dir,
                                  f"{chrom}.predict.s{options.min_support}")
        predict_chromosome(cands, engine, out_prefix, bam, options)
    if warmup_thread is not None:
        warmup_thread.join()
    return my_chroms


def merge_all(options, chrom_order: Sequence[str]) -> str:
    """Host-0 merge across all shards' fragments (shared filesystem).

    Runs in ONE process only, so it must not enter any collective: the
    score min/max comes from the shared-dir scan, which covers every
    shard's fragments. Mirrors the reference's empty-score abort
    (SVision:330-334) instead of emitting a header-only VCF with exit 0."""
    from svision_tpu_torch.call.vcfout import cal_scores_max_min, merge_split_vcfs
    from svision_tpu_torch.io.fasta import FastaFile

    predict_dir = os.path.join(options.out_path, "predict_results")
    scores = cal_scores_max_min(predict_dir)
    if not len(scores):
        print("Empty output in the score file!!! Program exit")
        raise SystemExit(1)
    mn, mx = float(np.min(scores)), float(np.max(scores))
    merged = os.path.join(
        options.out_path,
        f"{options.sample}.svision.s{options.min_support}.vcf")
    merge_split_vcfs(predict_dir, merged, mx, mn, list(chrom_order),
                     FastaFile(options.genome), options)
    return merged
