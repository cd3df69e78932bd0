"""The port's data-parallel inference (parallel/mesh.py and the engine's
devices= mode) on CPU replicas, against its single-device engine and the
JAX package's mesh engine: argmax equal and softmax within 1e-5, and the
CLI's --mesh 2 VCF byte-equal to --mesh none and within
test_torch_pipeline's rule of the JAX package's --exact VCF."""
import numpy as np
import jax
import pytest
import torch

from bench import random_specs
from svision_tpu import cli as jax_cli
from svision_tpu.infer.engine import InferenceEngine as JaxEngine
from svision_tpu.models import alexnet as ja
from svision_tpu.parallel import mesh as jax_mesh
from svision_tpu_torch import cli as port_cli
from svision_tpu_torch import sim
from svision_tpu_torch.infer.engine import InferenceEngine
from svision_tpu_torch.models.checkpoint import save_params
from svision_tpu_torch.ops import rasterize
from svision_tpu_torch.parallel import mesh as M
from tests.test_torch_pipeline import assert_vcf_match

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def params():
    return {k: np.asarray(v) for k, v in
            ja.init_params(jax.random.PRNGKey(0)).items()}


@pytest.fixture(scope="module")
def specs():
    return random_specs(40, seed=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_sharded_inference_matches_single(params, specs, bf16):
    p1, s1 = InferenceEngine(params, batch_size=16, bf16=bf16,
                             device="cpu").predict_specs(specs)
    sharded = M.ShardedInference(params, M.make_mesh(2, "cpu"),
                                 batch_size=16, bf16=bf16)
    # each replica takes whole batches of 16: a round of 32
    assert sharded.devices == (CPU, CPU) and sharded.batch_size == 32
    p2, s2 = sharded.predict_specs(specs)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_allclose(s1, s2, rtol=0, atol=1e-5)


def test_sharded_inference_matches_jax_mesh(params, specs):
    want_p, want_s = JaxEngine(params, batch_size=16, bf16=False,
                               mesh=jax_mesh.make_mesh(2)).predict_specs(specs)
    got_p, got_s = M.ShardedInference(params, M.make_mesh(2, "cpu"),
                                      batch_size=16,
                                      bf16=False).predict_specs(specs)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)


def _row_keys(ep: torch.Tensor) -> torch.Tensor:
    """A number for each row of endpoints [rows, SEGS, 4]."""
    flat = ep.flatten(1).long()
    return (flat * 7919 ** torch.arange(flat.shape[1]) % 1000003).sum(1)


def test_split_rounds_batch_and_keeps_row_order(params, specs, monkeypatch):
    """Three replicas at batch 8, chunk 2: a round of the plan is 24 rows,
    each device's step takes a whole batch of 8, one dispatch of two rounds
    carries the 40 specs (the second's third batch all padding), and the
    output equals the
    one-device engine's at batch 8. The network gives every one of these
    rows the same class and softmax, so a second pass has each step answer
    with a key of its own rows: the keys come back in the specs' order."""
    eng = InferenceEngine(params, batch_size=8, bf16=False, chunk=2,
                          devices=M.make_mesh(3, "cpu"))
    assert eng.batch_size == 24 and eng.plan(len(specs)) == ([2], 0)
    rows, real = [], eng._step

    def recording(model, w, ep, vis, rev):
        rows.append(ep.shape[0])
        return real(model, w, ep, vis, rev)
    monkeypatch.setattr(eng, "_step", recording)
    p, s = eng.predict_specs(specs)
    assert rows == [8] * 6            # 2 rounds x 3 devices
    p1, s1 = InferenceEngine(params, batch_size=8, bf16=False,
                             device="cpu").predict_specs(specs)
    np.testing.assert_array_equal(p, p1)
    np.testing.assert_array_equal(s, s1)

    def keyed(model, w, ep, vis, rev):
        k = _row_keys(ep)
        return k, k.float()
    monkeypatch.setattr(eng, "_step", keyed)
    want = _row_keys(torch.from_numpy(
        rasterize.specs_to_endpoints(specs)[0])).numpy()
    assert len(set(want.tolist())) == len(specs)
    p, s = eng.predict_specs(specs)
    np.testing.assert_array_equal(p, want)
    np.testing.assert_array_equal(s, want.astype(np.float32))


@pytest.mark.parametrize("spec,device,gpus,want", [
    ("none", "cuda", 4, None), ("0", "cuda", 4, None), ("1", "cuda", 4, None),
    ("auto", "cuda", 1, None), ("auto", "cuda", 0, None),
    ("auto", "cuda", 2, ("cuda:0", "cuda:1")),
    ("3", "cuda", 4, ("cuda:0", "cuda:1", "cuda:2")),
    ("auto", "cpu", 0, None), ("2", "cpu", 0, ("cpu", "cpu")),
])
def test_resolve_mesh_rules(monkeypatch, spec, device, gpus, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    got = M.resolve_mesh(spec, device)
    assert got == (None if want is None else
                   tuple(torch.device(d) for d in want))


@pytest.mark.parametrize("spec,gpus", [("2", 0), ("3", 2), ("8", 4)])
def test_mesh_above_visible_gpus_raises(monkeypatch, spec, gpus):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    with pytest.raises(ValueError, match="--mesh"):
        M.resolve_mesh(spec, "cuda")


def test_global_score_minmax():
    m = M.make_mesh(2, "cpu")
    assert M.global_score_minmax(np.array([3.5, 99.0, 0.25, 42.0]), m) == \
        (0.25, 99.0)
    lo, hi = M.global_score_minmax(np.zeros(0), m)
    assert lo == np.inf and hi == -np.inf
    # the JAX package's reduction gives the same pair
    assert jax_mesh.global_score_minmax(
        np.array([3.5, 99.0, 0.25, 42.0]), jax_mesh.make_mesh(2)) == \
        (0.25, 99.0)


@pytest.fixture(scope="module")
def mesh_ws(tmp_path_factory, params):
    root = tmp_path_factory.mktemp("torch_mesh")
    genome = str(root / "ref.fa")
    seqs = sim.make_genome(genome, {"chr1": 120000}, seed=9)
    bam = str(root / "s.bam")
    sim.make_sv_bam(bam, seqs, seed=9, support=6,
                    events=[("DEL", "chr1", 30000, 250),
                            ("INV", "chr1", 80000, 300)])
    weights = str(root / "w.npz")
    save_params(params, weights)
    ws = dict(root=root, base=["-b", bam, "-g", genome, "-m", weights,
                               "-n", "meshtest", "-s", "3",
                               "--batch_size", "16", "--exact"])
    ws["jax_vcf"] = jax_cli.run_pipeline(jax_cli.parse_arguments(
        ["-o", str(root / "jax"), "--mesh", "none"] + ws["base"]))
    return ws


def test_cli_mesh_vcf_identical(mesh_ws):
    root, base = mesh_ws["root"], mesh_ws["base"] + ["--device", "cpu"]
    vcf1 = port_cli.run_pipeline(port_cli.parse_arguments(
        ["-o", str(root / "one"), "--mesh", "none"] + base))
    vcf2 = port_cli.run_pipeline(port_cli.parse_arguments(
        ["-o", str(root / "two"), "--mesh", "2"] + base))
    assert open(vcf1).read() == open(vcf2).read()
    assert_vcf_match(vcf2, mesh_ws["jax_vcf"])


def test_cli_mesh_without_gpus_raises(mesh_ws, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    opts = port_cli.parse_arguments(
        ["-o", str(mesh_ws["root"] / "x"), "--mesh", "2"] + mesh_ws["base"])
    assert opts.device == "cuda"
    with pytest.raises(ValueError, match="--mesh"):
        port_cli.run_pipeline(opts)
