"""The CLI's optional modes: the port against the JAX package on the CPU.

The twin of tests/test_pipeline_e2e.py. Each mode runs through
svision_tpu_torch.cli.run_pipeline (--exact --device cpu) and through
svision_tpu.cli.run_pipeline (--exact) on the same arguments, and the two
output trees must be equal: the same files, and every one of them equal byte
for byte apart from the timestamped run log (SVision_*.log). That covers the
final VCF, the .graph.vcf and graph_*_match.txt of --graph, the
.mechanism.vcf, the .clusterd.vcf, and the segments/*.bed and
.collect_params.json of --resume. Where the JAX test checks behaviour (the
resume cache and its sidecar, --debug, the option rules, the broken-pool
fallback), the port's twin checks the same behaviour through the port's own
modules. The default bf16 mode is held to the JAX package's default with
--qname by tests/test_torch_pipeline.py's rule (non-QUAL bytes equal, QUAL
within +/-15). Both sides run one device (--mesh none): the port's
--device cpu engine has one, where the JAX package would spread its batches
over the eight virtual CPU devices that tests/conftest.py sets up.

Samples (the JAX package's sim, its init_params weights):
  plain    chr1 150 kb, DEL/INS/INV, support 8, seed 7, PRNGKey(0) weights;
  complex  chr1 200 kb, INV+DEL and DEL+INS, seed 21, PRNGKey(3) weights;
  contig   chr1 120 kb, one DEL on two haplotype contigs (support 2),
           seed 5, PRNGKey(0) weights, -s 5.
Each JAX run is made once per module, when a test first asks for it.
"""
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from svision_tpu import cli as jax_cli
from svision_tpu import sim as jax_sim
from svision_tpu.models import alexnet as ja
from svision_tpu.models.checkpoint import save_params
from svision_tpu_torch import cli as port_cli
from svision_tpu_torch.collect.candidates import Candidate
from svision_tpu_torch.collect.window import cache_valid
from tests.test_torch_pipeline import assert_vcf_match

torch.set_num_threads(2)

# sample -> (genome sizes, sim seed, support, events, weights key, -n, -s)
SAMPLES = {
    "plain": ({"chr1": 150000}, 7, 8,
              [("DEL", "chr1", 20000, 300), ("INS", "chr1", 60000, 220),
               ("INV", "chr1", 100000, 400)], 0, "synthsample", "3"),
    "complex": ({"chr1": 200000}, 21, 8,
                [("INV+DEL", "chr1", 60000, 300),
                 ("DEL+INS", "chr1", 140000, 400)], 3, "csvsample", "3"),
    "contig": ({"chr1": 120000}, 5, 2, [("DEL", "chr1", 40000, 400)], 0,
               "asm", "5"),
}
# mode -> (sample, arguments, runs into one output directory)
MODES = {
    "region": ("plain", ["-c", "chr1"], 1),
    "qname": ("plain", ["--qname"], 1),
    "threads": ("plain", ["-t", "2"], 1),
    "graph": ("plain", ["--graph"], 1),
    "graph_complex": ("complex", ["--graph"], 1),
    "hash": ("plain", ["--hash"], 1),
    "mechanism": ("plain", ["--mechanism"], 1),
    "cluster": ("plain", ["--cluster", "--qname"], 1),
    "contig": ("contig", ["--contig"], 1),
    "resume": ("plain", ["--resume"], 2),
}
EXACT_CPU = ["--exact", "--device", "cpu"]


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_modes")
    weights = {}
    out = {}
    for name, (sizes, seed, support, events, key, sample, s) in \
            SAMPLES.items():
        genome = str(root / f"{name}.fa")
        bam = str(root / f"{name}.bam")
        seqs = jax_sim.make_genome(genome, sizes, seed=seed)
        jax_sim.make_sv_bam(bam, seqs, seed=seed, support=support,
                            events=events)
        if key not in weights:
            weights[key] = str(root / f"w{key}.npz")
            save_params({k: np.asarray(v) for k, v in ja.init_params(
                jax.random.PRNGKey(key)).items()}, weights[key])
        out[name] = dict(bam=bam, genome=genome, weights=weights[key],
                         sample=sample, s=s)
    return out


def _args(fx, outdir, extra):
    return ["-o", outdir, "-b", fx["bam"], "-g", fx["genome"],
            "-m", fx["weights"], "-n", fx["sample"], "-s", fx["s"],
            "--batch_size", "32", "--mesh", "none", *extra]


def _run(cli, fx, outdir, extra, runs=1):
    for _ in range(runs):
        vcf = cli.run_pipeline(cli.parse_arguments(_args(fx, outdir, extra)))
    return vcf


@pytest.fixture(scope="module")
def jax_run(samples, tmp_path_factory):
    """(sample, arguments, runs) -> (final VCF, output directory) of the
    JAX package's CLI, each run once."""
    done = {}

    def run(sample, extra, runs=1):
        key = (sample, tuple(extra), runs)
        if key not in done:
            outdir = str(tmp_path_factory.mktemp("jax") / "out")
            done[key] = (_run(jax_cli, samples[sample], outdir, extra, runs),
                         outdir)
        return done[key]
    return run


def _records(vcf):
    return [l for l in open(vcf) if not l.startswith("#") and l.strip()]


def _tree(outdir):
    """relative path -> bytes of every file under outdir (None for a
    directory), the timestamped run logs left out."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(outdir):
        rel = os.path.relpath(dirpath, outdir)
        for d in dirnames:
            out[os.path.normpath(os.path.join(rel, d))] = None
        for f in filenames:
            if f.startswith("SVision_") and f.endswith(".log"):
                continue
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.normpath(os.path.join(rel, f))] = fh.read()
    return out


def assert_same_tree(got_dir, want_dir):
    got, want = _tree(got_dir), _tree(want_dir)
    assert sorted(got) == sorted(want)
    for path in sorted(want):
        assert got[path] == want[path], f"{path} differs"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_jax(samples, jax_run, tmp_path, mode):
    sample, extra, runs = MODES[mode]
    want_vcf, want_dir = jax_run(sample, extra + ["--exact"], runs)
    got_dir = str(tmp_path / "port")
    got_vcf = _run(port_cli, samples[sample], got_dir, extra + EXACT_CPU,
                   runs)
    assert os.path.basename(got_vcf) == os.path.basename(want_vcf)
    assert _records(got_vcf), f"{mode}: no records"
    assert_same_tree(got_dir, want_dir)


@pytest.mark.parametrize("sample", ["plain", "complex"])
def test_default_mode_matches_jax(samples, jax_run, tmp_path, sample):
    """The default bf16 path against the JAX package's default."""
    want_vcf, _ = jax_run(sample, ["--qname"])
    opts = port_cli.parse_arguments(_args(
        samples[sample], str(tmp_path / "port"), ["--qname", "--device",
                                                  "cpu"]))
    assert opts.bf16
    got_vcf = port_cli.run_pipeline(opts)
    assert os.path.basename(got_vcf) == os.path.basename(want_vcf)
    assert_vcf_match(got_vcf, want_vcf)


def test_resume_reads_the_cache(samples, tmp_path, monkeypatch):
    fx = samples["plain"]
    outdir = str(tmp_path / "port")
    first = _run(port_cli, fx, outdir, ["--resume", *EXACT_CPU])
    seg_dir = os.path.join(outdir, "segments")
    beds = [f for f in os.listdir(seg_dir) if f.endswith(".bed")]
    assert beds
    line = open(os.path.join(seg_dir, beds[0])).readline()
    assert Candidate.from_bed_line(line).to_bed_line() == line
    want = open(first).read()

    def collect(*a, **k):
        raise AssertionError("--resume collected a window it had cached")

    monkeypatch.setattr(port_cli, "run_detect", collect)
    second = _run(port_cli, fx, outdir, ["--resume", *EXACT_CPU])
    assert open(second).read() == want


def test_resume_cache_invalidated_by_different_bam(samples, tmp_path):
    fx = samples["plain"]
    outdir = str(tmp_path / "port")
    _run(port_cli, fx, outdir, ["--resume", *EXACT_CPU])
    seg_dir = os.path.join(outdir, "segments")
    opts = port_cli.parse_arguments(_args(fx, outdir, ["--resume",
                                                       *EXACT_CPU]))
    assert cache_valid(seg_dir, opts)
    other = str(tmp_path / "other.bam")
    shutil.copy(fx["bam"], other)
    assert not cache_valid(seg_dir, dataclasses.replace(opts, bam_path=other))


def test_debug_run_rewrites_the_sidecar(samples, tmp_path):
    fx = samples["plain"]
    outdir = str(tmp_path / "port")
    _run(port_cli, fx, outdir, ["--resume", *EXACT_CPU])
    seg_dir = os.path.join(outdir, "segments")
    opts = port_cli.parse_arguments(_args(fx, outdir, ["--resume",
                                                       *EXACT_CPU]))
    assert cache_valid(seg_dir, opts)
    _run(port_cli, fx, outdir, ["--debug", "--min_sv_size", "60", *EXACT_CPU])
    assert not cache_valid(seg_dir, opts)


@pytest.mark.parametrize("flag,field,want", [
    ("--graph", "qname", True),        # --graph needs READS= in the VCF
    ("--contig", "min_support", 1),    # assembly contigs: support 1
])
def test_option_rules(flag, field, want):
    args = ["-o", "o", "-b", "b", "-g", "g", "-m", "m", "-n", "n", flag]
    assert getattr(port_cli.parse_arguments(args), field) == want


def test_broken_pool_degrades_inline(samples, jax_run, tmp_path,
                                     monkeypatch):
    """A pool whose submit() raises: -t 2 collects inline and still gives
    the JAX package's -t 2 output."""
    import svision_tpu_torch.utils.hostpool as hostpool
    submits = []

    class _BrokenPool:
        def submit(self, *a, **k):
            submits.append(a)
            raise RuntimeError("pool is broken")

        def shutdown(self, *a, **k):
            pass

    monkeypatch.setattr(hostpool, "host_only_pool", lambda n: _BrokenPool())
    want_vcf, want_dir = jax_run("plain", ["-t", "2", "--exact"])
    got_dir = str(tmp_path / "port")
    got_vcf = _run(port_cli, samples["plain"], got_dir, ["-t", "2",
                                                         *EXACT_CPU])
    assert submits, "the broken pool was never tried"
    assert os.path.basename(got_vcf) == os.path.basename(want_vcf)
    assert_same_tree(got_dir, want_dir)
