"""The port's multi-sample cohort calling (parallel/cohort.py) on the CPU:
the cohort VCF against the JAX package's under test_torch_pipeline's rule,
shard-count invariance in one process and across two processes (over a
shared out dir, and with --coordinator over disjoint ones), and the
cross-sample merge's contig order."""
import os
import sys

import numpy as np
import jax
import pytest
import torch

from svision_tpu.config import default_options
from svision_tpu.models import alexnet as ja
from svision_tpu.parallel import cohort as jax_cohort
from svision_tpu_torch import sim
from svision_tpu_torch.cli import RunOptions
from svision_tpu_torch.io.fasta import FastaFile, write_fasta
from svision_tpu_torch.models.checkpoint import save_params
from svision_tpu_torch.parallel import cohort as cohort_mod
from tests.test_torch_dist import free_port, run_procs
from tests.test_torch_pipeline import assert_vcf_match

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cohort_ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cohort")
    genome = str(root / "ref.fa")
    seqs = sim.make_genome(genome, {"chr1": 120000}, seed=21)
    # shared DEL at 20k in both samples; private events per sample
    bam_a = str(root / "a.bam")
    sim.make_sv_bam(bam_a, seqs, seed=1, support=8,
                    events=[("DEL", "chr1", 20000, 300),
                            ("INS", "chr1", 60000, 200)])
    bam_b = str(root / "b.bam")
    sim.make_sv_bam(bam_b, seqs, seed=2, support=8,
                    events=[("DEL", "chr1", 20000, 300),
                            ("DEL", "chr1", 90000, 400)])
    weights = str(root / "w.npz")
    save_params({k: np.asarray(v) for k, v in
                 ja.init_params(jax.random.PRNGKey(0)).items()}, weights)
    ws = dict(root=root, genome=genome, bams={"A": bam_a, "B": bam_b},
              weights=weights)
    jax_opts = default_options(out_path=str(root / "jax"), genome=genome,
                               model_path=weights, min_support=3,
                               batch_size=32, bf16=False)
    os.makedirs(jax_opts.out_path)
    ws["jax_vcf"] = jax_cohort.run_cohort(ws["bams"], jax_opts)
    one = _opts(ws, root / "one")
    os.makedirs(one.out_path)
    ws["one_vcf"] = cohort_mod.run_cohort(ws["bams"], one)
    return ws


def _opts(ws, outdir):
    return RunOptions(out_path=str(outdir), genome=ws["genome"],
                      model_path=ws["weights"], min_support=3, batch_size=32,
                      bf16=False, device="cpu").normalized()


def _records(path):
    return [l.rstrip("\n").split("\t") for l in open(path)
            if not l.startswith("#") and l.strip()]


def _cli(ws, out, extra):
    return [sys.executable, "-m", "svision_tpu_torch.parallel.cohort",
            "-o", out, "-g", ws["genome"], "-m", ws["weights"],
            "--samples", *[f"{n}={p}" for n, p in ws["bams"].items()],
            "-s", "3", "--batch_size", "32", "--exact", "--device", "cpu",
            *extra]


def test_cohort_single_shard(cohort_ws):
    recs = _records(cohort_ws["one_vcf"])
    assert recs, "cohort VCF empty"
    # two genotype columns, SUPP/SUPP_VEC INFO present
    for r in recs:
        assert len(r) == 11, r
        assert "SUPP=" in r[7] and "SUPP_VEC=" in r[7]
    # the shared DEL site must carry both samples
    assert [r for r in recs if abs(int(r[1]) - 22000) < 3000
            and "SUPP=2" in r[7]], recs
    # private sites carry exactly one sample and a ./. column
    private = [r for r in recs if "SUPP=1" in r[7]]
    assert private
    for r in private:
        assert "./.:0:0" in (r[9], r[10])
    assert_vcf_match(cohort_ws["one_vcf"], cohort_ws["jax_vcf"])


def test_cohort_shard_invariance(cohort_ws, tmp_path):
    """A 2-shard run, both shards in this process, gives the 1-shard
    cohort VCF byte for byte."""
    opts = _opts(cohort_ws, tmp_path / "two")
    os.makedirs(opts.out_path)
    # shard 1 drops its barrier done-file and returns ""; shard 0 then
    # passes the barrier and merges
    assert cohort_mod.run_cohort(cohort_ws["bams"], opts, num_shards=2,
                                 shard_id=1) == ""
    v2 = cohort_mod.run_cohort(cohort_ws["bams"], opts, num_shards=2,
                               shard_id=0)
    assert open(v2).read() == open(cohort_ws["one_vcf"]).read()


def test_cohort_merge_contig_order(cohort_ws, tmp_path):
    """Cohort records follow header contig order, not lexicographic
    (chr2 before chr10), so tabix/bcftools accept the file."""
    genome = str(tmp_path / "ref2.fa")
    write_fasta(genome, {"chr2": "ACGT" * 300, "chr10": "ACGT" * 300})
    v = str(tmp_path / "a.vcf")
    with open(v, "w") as fh:
        fh.write("##fileformat=VCFv4.3\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\tFORMAT\tA\n")
        fh.write("chr10\t100\t0\tN\t<SV>\t90\tPASS\t"
                 "END=200;SVLEN=100;SVTYPE=DEL\tGT:DR:DV\t0/1:3:5\n")
        fh.write("chr2\t100\t1\tN\t<SV>\t90\tPASS\t"
                 "END=200;SVLEN=100;SVTYPE=DEL\tGT:DR:DV\t0/1:3:5\n")
    opts = _opts(cohort_ws, tmp_path)
    out = cohort_mod.merge_cohort_vcfs({"A": v}, str(tmp_path / "m.vcf"),
                                       opts, ref=FastaFile(genome))
    assert [r[0] for r in _records(out)] == ["chr2", "chr10"]
    jax_out = jax_cohort.merge_cohort_vcfs(
        {"A": v}, str(tmp_path / "j.vcf"),
        default_options(genome=genome), ref=FastaFile(genome))
    assert open(out).read() == open(jax_out).read()


def test_cohort_two_process_cli(cohort_ws, tmp_path):
    """Two concurrent CLI processes over a shared out dir: the done-file
    barrier holds shard 0's merge until shard 1 is done."""
    out = str(tmp_path / "mp")
    run_procs([_cli(cohort_ws, out, ["--num-shards", "2", "--shard-id",
                                     str(k)]) for k in (0, 1)])
    merged = os.path.join(out, "cohort.svision.s3.vcf")
    assert open(merged).read() == open(cohort_ws["one_vcf"]).read()


def test_cohort_two_process_disjoint_outdirs(cohort_ws, tmp_path):
    """Two --coordinator processes with disjoint out dirs: the per-sample
    fragments travel to process 0 over gloo, and its cohort VCF is the
    1-shard one."""
    coord = f"127.0.0.1:{free_port()}"
    outs = [str(tmp_path / f"shard{k}") for k in (0, 1)]
    run_procs([_cli(cohort_ws, outs[k],
                    ["--num-shards", "2", "--shard-id", str(k),
                     "--coordinator", coord]) for k in (0, 1)])
    merged = os.path.join(outs[0], "cohort.svision.s3.vcf")
    assert open(merged).read() == open(cohort_ws["one_vcf"]).read()
    assert not os.path.exists(os.path.join(outs[1], "cohort.svision.s3.vcf"))


def test_cohort_without_gpu_raises(cohort_ws, tmp_path, monkeypatch):
    """The cohort entry point defaults to the GPU and fails without one
    rather than calling on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    out = tmp_path / "g"
    with pytest.raises(RuntimeError, match="CUDA"):
        cohort_mod.main(["-o", str(out), "-g", cohort_ws["genome"],
                         "-m", cohort_ws["weights"], "--samples",
                         *[f"{n}={p}" for n, p in cohort_ws["bams"].items()],
                         "-s", "3", "--exact"])
    assert not os.path.exists(out / "A")
