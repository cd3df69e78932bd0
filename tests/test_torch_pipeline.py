"""The port's whole calling path on the CPU against the JAX package's.

On the fixture of tests/test_pipeline_e2e.py (chr1 150 kb, DEL/INS/INV,
support 8) with one seeded .npz, svision_tpu_torch.cli.run_pipeline
(--exact --device cpu, also with -t 2) must give the VCF that
svision_tpu.cli.run_pipeline(--exact) gives: every non-QUAL byte equal and
QUAL within +/-15, the rule of tests/test_noisy_parity.py (the global QUAL
rescale couples every record to the score extrema). The port's copy of
sim.make_sv_bam must write the same bytes as the JAX package's.
"""
import os

import numpy as np
import jax
import pytest
import torch

from svision_tpu import cli as jax_cli
from svision_tpu import sim as jax_sim
from svision_tpu.models import alexnet as ja
from svision_tpu.models.checkpoint import save_params
from svision_tpu_torch import cli as port_cli
from svision_tpu_torch import sim as port_sim

torch.set_num_threads(2)

EVENTS = [("DEL", "chr1", 20000, 300), ("INS", "chr1", 60000, 220),
          ("INV", "chr1", 100000, 400)]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_e2e")
    genome = str(root / "ref.fa")
    seqs = jax_sim.make_genome(genome, {"chr1": 150000}, seed=7)
    bam = str(root / "sample.bam")
    jax_sim.make_sv_bam(bam, seqs, seed=7, support=8, events=EVENTS)
    weights = str(root / "w.npz")
    save_params({k: np.asarray(v) for k, v in
                 ja.init_params(jax.random.PRNGKey(0)).items()}, weights)
    ws = dict(root=root, genome=genome, bam=bam, weights=weights)
    ws["jax_vcf"] = jax_cli.run_pipeline(jax_cli.parse_arguments(
        _args(ws, str(root / "jax_out"), ["--exact"])))
    return ws


def _args(ws, outdir, extra):
    return ["-o", outdir, "-b", ws["bam"], "-g", ws["genome"],
            "-m", ws["weights"], "-n", "synthsample", "-s", "3",
            "--batch_size", "32", *extra]


def _split_qual(line):
    f = line.rstrip("\n").split("\t")
    qual = float(f[5])
    f[5] = "QUAL"
    return "\t".join(f), qual


def assert_vcf_match(got_path, want_path, band=15.0):
    got = open(got_path).read().splitlines(True)
    want = open(want_path).read().splitlines(True)
    assert [l for l in got if l.startswith("#")] == \
        [l for l in want if l.startswith("#")]
    got = [l for l in got if not l.startswith("#")]
    want = [l for l in want if not l.startswith("#")]
    assert want, "reference VCF has no records"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gg, gq = _split_qual(g)
        ww, wq = _split_qual(w)
        assert gg == ww, f"non-QUAL fields differ:\n{w}{g}"
        assert abs(gq - wq) <= band, f"QUAL beyond the band:\n{w}{g}"


@pytest.mark.parametrize("threads", ["1", "2"])
def test_exact_cpu_vcf_matches_jax(workspace, tmp_path, threads):
    opts = port_cli.parse_arguments(_args(
        workspace, str(tmp_path / "port"),
        ["--exact", "--device", "cpu", "-t", threads]))
    assert opts.device == "cpu" and not opts.bf16
    vcf = port_cli.run_pipeline(opts)
    assert os.path.basename(vcf) == os.path.basename(workspace["jax_vcf"])
    assert_vcf_match(vcf, workspace["jax_vcf"])


def test_sim_writes_the_same_bytes(tmp_path):
    out = {}
    for name, mod in (("jax", jax_sim), ("port", port_sim)):
        d = tmp_path / name
        d.mkdir()
        seqs = mod.make_genome(str(d / "ref.fa"), {"chr1": 60000}, seed=5)
        mod.make_sv_bam(str(d / "s.bam"), seqs, seed=5, support=4,
                        events=[("DEL", "chr1", 20000, 300),
                                ("INV", "chr1", 40000, 500)])
        out[name] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    assert out["jax"].keys() == out["port"].keys()
    for f in out["jax"]:
        assert out["jax"][f] == out["port"][f], f
