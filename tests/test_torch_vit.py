"""The ViT (svision_tpu_torch/models/vit.py) on the CPU, at a small width
(hidden 64, 2 layers, 4 heads, MLP 128, patch 16 on the 227 raster),
against the plain reference tests/reference_vit.py: the network's f32
logits, the engine's answers in f32 and bf16, the fold of SVision's
normalisation into the patch embedding, the CPU mesh, the modes that are
AlexNet's alone, the engine's span attributes and K1's calls, and the
CLI reaching the ViT from -m.
"""
import numpy as np
import pytest
import torch

from svision_tpu_torch import graphs, trace
from svision_tpu_torch.infer import engine as engine_mod
from svision_tpu_torch.infer.engine import InferenceEngine
from svision_tpu_torch.models import vit
from svision_tpu_torch.models.alexnet import IMAGE_MEAN
from svision_tpu_torch.models.alexnet import init_params as alexnet_params
from svision_tpu_torch.ops import rasterize
from svision_tpu_torch.timing import random_specs
from tests import reference_vit

torch.set_num_threads(2)

SMALL = vit.Widths(hidden=64, layers=2, heads=4, mlp=128, patch=16)
SENTINEL = InferenceEngine._SENTINEL


def _specs(n=300, seed=1):
    """n random specs with the engine's sentinel among them."""
    specs = random_specs(n, seed=seed)
    specs[::37] = SENTINEL
    return specs


def _raster(specs):
    seg = [torch.from_numpy(a) for a in rasterize.specs_to_endpoints(specs)]
    return rasterize.render_raster(*seg, dtype=torch.float32)


def _reference(params, specs):
    with reference_vit.f32_exact():
        return reference_vit.logits(params, _raster(specs)).double()


@pytest.fixture(scope="module")
def params():
    """Seeded small weights as torchvision initialises them, with the
    head's biases centring the reference's logits of the test's images, so
    that the classes split them (uncentred, every image takes the class of
    the largest bias) while the logits keep their f32 conditioning: their
    spread over images is about 0.01-0.02 a class, and every f32 rounding
    about 1e-6."""
    p = vit.init_params(5, SMALL)
    lg = _reference(p, _specs()).float().numpy()
    p["vit/head/biases"] = (p["vit/head/biases"]
                            - lg.mean(axis=0)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def fitted():
    """The same weights fitted to the test's images as the benchmark fits
    its own (benchmark/drivers/engine_vit.py): the patch embedding's
    channels centred and of std 1 over every patch, then the logits
    centred and of std 2 a class. The images then move the logits by
    whole units, and every rounding with them."""
    p = vit.init_params(5, SMALL)
    specs = _specs()
    w, b = p["vit/patch/weights"], p["vit/patch/biases"]
    x = _raster(specs).numpy() * 255.0 - np.float32(IMAGE_MEAN)
    g, k = SMALL.grid, SMALL.patch
    patches = (x[:, :g * k, :g * k].reshape(-1, g, k, g, k, 3)
               .transpose(0, 1, 3, 2, 4, 5).reshape(-1, k * k * 3))
    emb = patches @ w.reshape(-1, SMALL.hidden) + b
    scale = 1.0 / emb.std(axis=0)
    p["vit/patch/weights"] = (w * scale).astype(np.float32)
    p["vit/patch/biases"] = ((b - emb.mean(axis=0)) * scale).astype(np.float32)
    lg = _reference(p, specs).float().numpy()
    scale = 2.0 / lg.std(axis=0)
    p["vit/head/weights"] = (p["vit/head/weights"] * scale).astype(np.float32)
    p["vit/head/biases"] = ((p["vit/head/biases"] - lg.mean(axis=0))
                            * scale).astype(np.float32)
    return p


def test_leaves_and_widths(params):
    """The named leaves in the AlexNet's layouts, and the widths they hold;
    a leaf of another shape is refused."""
    shapes = vit.leaf_shapes(vit.VIT_B16)
    assert shapes["vit/patch/weights"] == (16, 16, 3, 768)
    assert shapes["vit/pos"] == (197, 768)
    assert shapes["vit/layer11/qkv/weights"] == (768, 2304)
    assert shapes["vit/layer0/mlp2/weights"] == (3072, 768)
    assert shapes["vit/head/weights"] == (768, 5)
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert n == 85_802_501             # ViT-B/16 with a 5-class head
    assert vit.widths_of(params) == SMALL and SMALL.tokens == 197
    assert vit.is_vit(params) and not vit.is_vit(alexnet_params(0))
    bad = dict(params, **{"vit/pos": np.zeros((196, 64), np.float32)})
    with pytest.raises(ValueError, match="other leaves"):
        vit.widths_of(bad)
    lacking = {k: v for k, v in params.items() if k != "vit/heads"}
    with pytest.raises(ValueError, match="lack or misshape"):
        vit.widths_of(lacking)


def test_f32_logits_against_the_reference(params):
    """The network in f32 (TF32 off) on the raster, with the normalisation
    folded in, gives the reference's logits within 1e-5: both sum the same
    products in f32, in other orders."""
    specs = _specs()
    model = vit.VisionTransformer.from_params(
        vit.cast_params(vit.fold_params(params), torch.float32), device="cpu")
    with torch.no_grad(), engine_mod.exact_f32():
        got = model(_raster(specs)).double()
    want = _reference(params, specs)
    assert float((got - want).abs().max()) <= 1e-5


def test_fold_equals_the_unfolded_network(params):
    """The folded network on the {0,1} raster equals the unfolded one on
    raster x 255 - IMAGE_MEAN, within f32 rounding of the fold's sums
    (768 products of magnitude up to 255 x 124 in the bias): 2e-6 here."""
    specs = _specs(64, seed=3)
    raster = _raster(specs)
    folded = vit.VisionTransformer.from_params(
        vit.cast_params(vit.fold_params(params), torch.float32), device="cpu")
    unfolded = vit.VisionTransformer.from_params(
        vit.cast_params(params, torch.float32), device="cpu")
    image = raster * 255.0 - torch.tensor(IMAGE_MEAN)
    with torch.no_grad():
        a, b = folded(raster), unfolded(image)
    assert float((a - b).abs().max()) <= 1e-5


def _engine_readings(params, bf16, specs):
    eng = InferenceEngine(params, batch_size=32, chunk=4, bf16=bf16,
                          device="cpu")
    preds, softs = eng.predict_specs(specs)
    ref = _reference(params, specs)
    soft = torch.softmax(ref, dim=1)
    top2 = ref.topk(2, dim=1).values
    return preds, softs, soft, (top2[:, 0] - top2[:, 1]).numpy()


def test_f32_engine_against_the_reference(params):
    """The exact engine (bf16=False) on 300 specs, sentinels included: its
    max softmax within 1e-5 of the reference's, its argmax the
    reference's wherever the reference's top two logits lie more than
    1e-4 apart (f32 rounding of the logits, about 1e-6 here, decides
    nearer ties)."""
    specs = _specs()
    preds, softs, soft, gap = _engine_readings(params, False, specs)
    assert float(np.abs(softs - soft.max(dim=1).values.numpy()).max()) <= 1e-5
    clear = gap > 1e-4
    assert clear.mean() > 0.95
    assert np.array_equal(preds[clear], soft.argmax(dim=1).numpy()[clear])
    assert len(set(preds.tolist())) >= 3


def test_bf16_engine_against_the_reference(fitted):
    """The default engine (bf16) on the same specs, on the fitted weights.
    bf16 rounds every weight and activation to 8 significant bits (2^-9
    relative), and the fit scales the features' spread over images up to
    logits of std 2, so the rounding moves the softmax by hundredths (mean
    0.028, widest 0.118 here; the argmax agrees on 94% of the rows, and
    no disagreement has a top-two logit gap past 0.24). Bounds at about
    1.5x those: mean max-softmax gap 0.04, widest 0.2, the argmax the
    reference's wherever the top two logits lie more than 0.4 apart and
    on at least 90% of the rows."""
    specs = _specs()
    preds, softs, soft, gap = _engine_readings(fitted, True, specs)
    err = np.abs(softs - soft.max(dim=1).values.numpy())
    assert err.mean() <= 0.04 and err.max() <= 0.2
    want = soft.argmax(dim=1).numpy()
    assert np.array_equal(preds[gap > 0.4], want[gap > 0.4])
    assert (preds == want).mean() >= 0.9


@pytest.mark.parametrize("bf16", [True, False])
def test_mesh_of_two_equals_one_device(params, bf16):
    """A two-replica CPU mesh gives one device's answers bit for bit: each
    replica runs whole batches of the one-device engine's rows."""
    specs = _specs(200, seed=9)
    one = InferenceEngine(params, batch_size=32, chunk=2, bf16=bf16,
                          device="cpu").predict_specs(specs)
    two = InferenceEngine(params, batch_size=32, chunk=2, bf16=bf16,
                          devices=("cpu", "cpu")).predict_specs(specs)
    for a, b in zip(one, two):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("mode", [dict(int8=True), dict(fast=False),
                                  dict(raster="compare"),
                                  dict(raster="einsum"),
                                  dict(raster="pallas")])
def test_alexnet_modes_refuse_vit_weights(params, mode):
    with pytest.raises(ValueError, match="AlexNet's modes"):
        InferenceEngine(params, device="cpu", **mode)


def test_engine_call_attributes_and_k1_calls(params, monkeypatch):
    """engine.call says network 'vit_b16', tokens = padded rows x 197 and
    no split groups; K1 (its plain version on the CPU, which counts no
    launch) renders once a batch, in the compute dtype."""
    calls = []
    k1 = engine_mod.render_raster_kernel

    def counted(ep, vis, rev, *, dtype):
        calls.append((ep.shape[0], dtype))
        return k1(ep, vis, rev, dtype=dtype)
    monkeypatch.setattr(engine_mod, "render_raster_kernel", counted)
    eng = InferenceEngine(params, batch_size=16, chunk=2, device="cpu")
    assert eng.network == "vit_b16"
    specs = _specs(70, seed=2)
    with trace.recording() as rec:
        eng.predict_specs(specs)
    (call,) = rec.find("engine.call")
    chunks, singles = eng.plan(70)
    batches = sum(chunks) + singles
    assert call.attrs["network"] == "vit_b16"
    assert call.attrs["padded_rows"] == batches * 16
    assert call.attrs["tokens"] == batches * 16 * 197
    assert call.attrs["split_groups"] == 0
    assert call.attrs["launches"] == {w.__name__: 0
                                      for w in graphs.kernel_wrappers()}
    assert calls == [(16, torch.bfloat16)] * batches


def test_cli_reaches_the_vit_from_m(params, tmp_path, monkeypatch):
    """svision-tpu-torch -m vit.npz (--exact --device cpu) runs the ViT,
    read from the checkpoint's leaves with no flag, and writes a VCF."""
    from svision_tpu_torch import cli, sim
    from svision_tpu_torch.models.checkpoint import load_params, save_params
    weights = str(tmp_path / "vit.npz")
    save_params(params, weights)
    back = load_params(weights)
    assert set(back) == set(params) and int(back["vit/heads"]) == 4
    genome = str(tmp_path / "ref.fa")
    seqs = sim.make_genome(genome, {"chr1": 60000}, seed=3)
    bam = str(tmp_path / "s.bam")
    sim.make_sv_bam(bam, seqs, seed=3, support=8,
                    events=[("DEL", "chr1", 20000, 300)])
    images = []
    forward = vit.VisionTransformer.forward

    def counted(self, raster):
        images.append(raster.shape[0])
        return forward(self, raster)
    monkeypatch.setattr(vit.VisionTransformer, "forward", counted)
    vcf = cli.run_pipeline(cli.parse_arguments([
        "-o", str(tmp_path / "out"), "-b", bam, "-g", genome, "-m", weights,
        "-n", "s", "-s", "3", "--batch_size", "8", "--exact",
        "--device", "cpu", "--mesh", "none"]))
    assert images and all(n == 8 for n in images)
    lines = open(vcf).read().splitlines()
    assert lines[0].startswith("##fileformat=VCF")
    assert any(not l.startswith("#") for l in lines)
