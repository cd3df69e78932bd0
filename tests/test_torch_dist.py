"""The port's genome-axis sharding (parallel/dist.py) on the CPU: shard
assignment, the gloo exchanges in one and in two processes, and N-shard
runs (in-process, through the CLI's --num_shards/--merge_shards, and as two
--coordinator processes with disjoint out dirs) giving the 1-shard VCF byte
for byte, which itself matches the JAX package's --exact VCF under
test_torch_pipeline's rule."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from svision_tpu import cli as jax_cli
from svision_tpu.models import alexnet as ja
from svision_tpu.parallel import dist as jax_dist
from svision_tpu_torch import cli as port_cli
from svision_tpu_torch import sim
from svision_tpu_torch.io.bam import BamReader
from svision_tpu_torch.io.fasta import FastaFile
from svision_tpu_torch.models.checkpoint import save_params
from svision_tpu_torch.parallel import dist
from tests.test_torch_pipeline import assert_vcf_match

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(argvs, timeout=300):
    """Start every argv at once (CPU torch, one thread each); returns their
    outputs, failing on a non-zero exit."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=ROOT,
                              env=env) for a in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_assignments_cover_and_disjoint():
    chroms = [f"chr{i}" for i in range(7)]
    got = [dist.assign_chroms(chroms, 3, k) for k in range(3)]
    flat = sum(got, [])
    assert sorted(flat) == sorted(chroms)
    assert len(set(flat)) == len(flat)
    assert got == [jax_dist.assign_chroms(chroms, 3, k) for k in range(3)]
    pairs = [dist.assign_cohort(["s1", "s2"], chroms, 4, k) for k in range(4)]
    flatp = sum(pairs, [])
    assert len(flatp) == 14 and len(set(flatp)) == 14
    assert pairs == [jax_dist.assign_cohort(["s1", "s2"], chroms, 4, k)
                     for k in range(4)]


def test_exchange_score_minmax_single():
    assert dist.exchange_score_minmax(np.array([5.0, 1.5, 80.0])) == \
        jax_dist.exchange_score_minmax(np.array([5.0, 1.5, 80.0])) == \
        (1.5, 80.0)
    assert dist.exchange_score_minmax(np.zeros(0)) == \
        (float("inf"), float("-inf"))


def test_init_distributed_needs_a_coordinator():
    """A multi-process run without a rendezvous raises instead of carrying
    on as a single process."""
    dist.init_distributed(None, 1, 0)          # one process: nothing to join
    assert dist.process_count() == 1
    with pytest.raises(ValueError, match="coordinator"):
        dist.init_distributed(None, 2, 0)


_GLOO_WORKER = r"""
import json, sys
import numpy as np
from svision_tpu_torch.parallel import dist
coord, rank = sys.argv[1], int(sys.argv[2])
dist.init_distributed(coord, 2, rank)
scores = [np.array([5.0, 1.5, 80.0]), np.zeros(0)][rank]
lo, hi = dist.exchange_score_minmax(scores)
blobs = dist._gather_blob_to_host0(b"x" * (3 + 1000 * rank))
out = dict(rank=rank, world=dist.process_count(), lo=lo, hi=hi,
           blobs=None if blobs is None else [len(b) for b in blobs])
dist.shutdown_distributed()
print("RESULT " + json.dumps(out))
"""


def test_gloo_exchanges_in_two_processes():
    """exchange_score_minmax keeps an empty shard neutral, and the blob
    gather brings blobs of different lengths to process 0 only."""
    coord = f"127.0.0.1:{free_port()}"
    outs = run_procs([[sys.executable, "-c", _GLOO_WORKER, coord, str(k)]
                      for k in (0, 1)], timeout=120)
    res = [json.loads(next(l for l in o.splitlines()
                           if l.startswith("RESULT "))[7:]) for o in outs]
    assert [r["world"] for r in res] == [2, 2]
    assert all((r["lo"], r["hi"]) == (1.5, 80.0) for r in res)
    assert res[0]["blobs"] == [3, 1003] and res[1]["blobs"] is None


def test_unpack_fragments_refuses_escapes(tmp_path):
    blob = dist._pack_files(str(tmp_path), [])
    assert dist._unpack_fragments(blob, str(tmp_path / "d")) == []
    (tmp_path / "a.vcf").write_text("x")
    blob = dist._pack_files(str(tmp_path), ["a.vcf"]).replace(
        b"a.vcf", b"../..")
    with pytest.raises(ValueError, match="escapes"):
        dist._unpack_fragments(blob, str(tmp_path / "d"))


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dist")
    genome = str(root / "ref.fa")
    seqs = sim.make_genome(genome, {"chr1": 80000, "chr2": 70000}, seed=31)
    bam = str(root / "s.bam")
    sim.make_sv_bam(bam, seqs, seed=31, support=6,
                    events=[("DEL", "chr1", 25000, 250),
                            ("INS", "chr2", 30000, 200)])
    weights = str(root / "w.npz")
    save_params({k: np.asarray(v) for k, v in
                 ja.init_params(jax.random.PRNGKey(0)).items()}, weights)
    ws = dict(root=root, genome=genome, bam=bam, weights=weights)
    ws["jax_vcf"] = jax_cli.run_pipeline(jax_cli.parse_arguments(
        _args(ws, str(root / "jax"), device=False)))
    ws["one_vcf"] = port_cli.run_pipeline(port_cli.parse_arguments(
        _args(ws, str(root / "one"))))
    return ws


def _args(ws, outdir, extra=(), device=True):
    return ["-o", outdir, "-b", ws["bam"], "-g", ws["genome"],
            "-m", ws["weights"], "-n", "dist", "-s", "3", "--batch_size",
            "16", "--exact", *(["--device", "cpu"] if device else []),
            *extra]


def test_one_shard_matches_jax(ws):
    records = [l for l in open(ws["one_vcf"]) if not l.startswith("#")]
    assert {l.split("\t")[0] for l in records} == {"chr1", "chr2"}
    assert_vcf_match(ws["one_vcf"], ws["jax_vcf"])


def test_two_shards_equal_one(ws, tmp_path):
    opts = port_cli.parse_arguments(_args(ws, str(tmp_path / "two")))
    handled = [dist.run_shard(opts, shard, 2) for shard in range(2)]
    order = list(port_cli.build_task_list(BamReader(ws["bam"]),
                                          FastaFile(ws["genome"]), opts))
    assert handled == [["chr1"], ["chr2"]] and order == ["chr1", "chr2"]
    vcf2 = dist.merge_all(opts, order)
    assert open(vcf2).read() == open(ws["one_vcf"]).read()
    assert_vcf_match(vcf2, ws["jax_vcf"])


def test_cli_shard_flags(ws, tmp_path):
    """--num_shards/--shard_id, then --merge_shards, through the CLI."""
    out = str(tmp_path / "two")
    for shard in range(2):
        frag_dir = port_cli.run_pipeline(port_cli.parse_arguments(_args(
            ws, out, ["--num_shards", "2", "--shard_id", str(shard)])))
        assert frag_dir == os.path.join(out, "predict_results")
    vcf2 = port_cli.run_pipeline(port_cli.parse_arguments(
        _args(ws, out, ["--merge_shards"])))
    assert open(vcf2).read() == open(ws["one_vcf"]).read()


def test_cli_shard_graph_merge(ws, tmp_path):
    """A sharded --graph run's --merge_shards runs the graph step and
    equals the single-process --graph run byte for byte."""
    g = ["--graph", "--qname"]
    vcf1 = port_cli.run_pipeline(port_cli.parse_arguments(
        _args(ws, str(tmp_path / "one"), g)))
    assert vcf1.endswith(".graph.vcf")
    out = str(tmp_path / "two")
    for shard in range(2):
        port_cli.run_pipeline(port_cli.parse_arguments(_args(
            ws, out, g + ["--num_shards", "2", "--shard_id", str(shard)])))
    vcf2 = port_cli.run_pipeline(port_cli.parse_arguments(
        _args(ws, out, g + ["--merge_shards"])))
    assert vcf2.endswith(".graph.vcf")
    assert open(vcf1).read() == open(vcf2).read()
    assert not os.path.exists(vcf2.replace(".graph.vcf", ".vcf"))


def test_coordinator_two_processes_disjoint_outdirs(ws, tmp_path):
    """Two --coordinator processes with disjoint out dirs: shard 1's
    fragments reach process 0 over gloo, and process 0's VCF is the
    1-shard VCF."""
    coord = f"127.0.0.1:{free_port()}"
    outs = [str(tmp_path / f"shard{k}") for k in (0, 1)]
    run_procs([[sys.executable, "-m", "svision_tpu_torch.cli",
                *_args(ws, outs[k], ["--num_shards", "2", "--shard_id",
                                     str(k), "--coordinator", coord])]
               for k in (0, 1)])
    merged = os.path.join(outs[0], "dist.svision.s3.vcf")
    assert open(merged).read() == open(ws["one_vcf"]).read()
    assert not os.path.exists(os.path.join(outs[1], "dist.svision.s3.vcf"))
    assert os.listdir(os.path.join(outs[1], "predict_results"))


def test_merge_all_empty_scores_aborts(ws, tmp_path):
    """Header-only merges are an error, like the reference's 'Empty output
    in the score file' abort (SVision:330-334)."""
    opts = port_cli.parse_arguments(_args(ws, str(tmp_path / "empty")))
    os.makedirs(os.path.join(opts.out_path, "predict_results"))
    with pytest.raises(SystemExit):
        dist.merge_all(opts, ["chr1"])


@pytest.mark.parametrize("extra", [
    ["--num_shards", "2", "--shard_id", "1"],
    ["--num_shards", "2", "--shard_id", "0", "--coordinator", "unused:1"]])
def test_shard_run_without_gpu_raises(ws, tmp_path, monkeypatch, extra):
    """A shard asked for the GPU on a machine without one raises before it
    writes a fragment or joins a process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    args = [a for a in _args(ws, str(tmp_path / "g"), extra)
            if a not in ("--device", "cpu")]
    opts = port_cli.parse_arguments(args)
    assert opts.device == "cuda"
    # the rendezvous is not reached: it would wait for a peer that never
    # comes
    monkeypatch.setattr(dist, "init_distributed",
                        lambda *a: pytest.fail("joined a process group"))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.run_pipeline(opts)
    assert not os.path.exists(os.path.join(str(tmp_path / "g"),
                                           "predict_results"))
