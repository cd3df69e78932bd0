"""The V-MoE (svision_tpu_torch/models/vit.py with experts, ops/moe.py) on
the CPU, at a small width (hidden 64, 4 layers, 4 heads, MLP 128, patch
16, 8 experts, k = 2 in layers 1 and 3), against the plain reference
tests/reference_vmoe.py: the leaves and widths, the MoE op's plain
versions, the network's and the engine's f32 logits and routing, the bf16
engine, an image's answer alone and in a batch, the modes out of scope, the
engine's span attributes and counters, and the CLI reaching the V-MoE from
-m.
"""
import numpy as np
import pytest
import torch

from svision_tpu_torch import graphs, trace
from svision_tpu_torch.infer import engine as engine_mod
from svision_tpu_torch.infer.engine import InferenceEngine
from svision_tpu_torch.models import vit
from svision_tpu_torch.models.alexnet import IMAGE_MEAN
from svision_tpu_torch.ops import moe, rasterize
from svision_tpu_torch.timing import random_specs
from tests import reference_vmoe

torch.set_num_threads(2)

SMALL = vit.Widths(hidden=64, layers=4, heads=4, mlp=128, patch=16,
                   experts=8, top_k=2, moe_layers=(1, 3))
SENTINEL = InferenceEngine._SENTINEL


def _specs(n=200, seed=1):
    """n random specs with the engine's sentinel among them."""
    specs = random_specs(n, seed=seed)
    specs[::37] = SENTINEL
    return specs


def _raster(specs):
    seg = [torch.from_numpy(a) for a in rasterize.specs_to_endpoints(specs)]
    return rasterize.render_raster(*seg, dtype=torch.float32)


def _reference(params, specs, routed=None):
    with reference_vmoe.f32_exact():
        return reference_vmoe.logits(params, _raster(specs), routed).double()


@pytest.fixture(scope="module")
def params():
    """Seeded small weights (vit.init_params), the routers scaled by 4 so
    that the gates are peaked as a trained router's are (about 0.5 of the
    mass on the top two), and the head's biases centring the reference's
    logits of the test's images so that the classes split them."""
    p = vit.init_params(5, SMALL)
    for i in SMALL.moe_layers:
        p[f"vit/layer{i}/router/weights"] *= np.float32(4.0)
    lg = _reference(p, _specs()).float().numpy()
    p["vit/head/biases"] = (p["vit/head/biases"]
                            - lg.mean(axis=0)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def fitted():
    """The same weights fitted to the test's images as the ViT's tests fit
    theirs (tests/test_torch_vit.py): the patch embedding's channels
    centred and of std 1 over every patch, then the logits centred and of
    std 2 a class, so that the images move the logits by whole units."""
    p = vit.init_params(5, SMALL)
    for i in SMALL.moe_layers:
        p[f"vit/layer{i}/router/weights"] *= np.float32(4.0)
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


def _model(params, dtype=torch.float32):
    return vit.VisionTransformer.from_params(
        vit.cast_params(vit.fold_params(params), dtype), device="cpu")


def test_leaves_widths_and_size(params):
    """V-MoE-B/16's leaves: the dense layers' MLPs and the sparse layers'
    routers and experts, in the ViT's layouts; 964,322,309 weights with a
    5-class head (6 x 32 x 4,722,432 in the experts); the small widths read
    back from the leaves; the routers stay f32 in a bf16 cast."""
    shapes = vit.leaf_shapes(vit.VMOE_B16)
    assert shapes["vit/layer0/mlp1/weights"] == (768, 3072)
    assert "vit/layer1/mlp1/weights" not in shapes
    assert shapes["vit/layer1/router/weights"] == (768, 32)
    assert shapes["vit/layer11/experts/mlp1/weights"] == (32, 768, 3072)
    assert shapes["vit/layer11/experts/mlp1/biases"] == (32, 3072)
    assert shapes["vit/layer11/experts/mlp2/weights"] == (32, 3072, 768)
    assert shapes["vit/layer11/experts/mlp2/biases"] == (32, 768)
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert n == 964_322_309
    assert vit.widths_of(params) == SMALL
    assert vit.is_vmoe(params) and vit.is_vit(params)
    assert not vit.is_vmoe(vit.init_params(0, vit.Widths(hidden=64, layers=2,
                                                         heads=4, mlp=128)))
    cast = vit.cast_params(params, torch.bfloat16)
    assert cast["vit/layer1/router/weights"].dtype == torch.float32
    assert cast["vit/layer1/experts/mlp1/weights"].dtype == torch.bfloat16
    assert int(cast["vit/top_k"]) == 2


@pytest.mark.parametrize("leaf,shape", [
    ("vit/layer1/experts/mlp1/weights", (8, 64, 127)),
    ("vit/layer3/experts/mlp2/biases", (7, 64)),
    ("vit/layer1/router/weights", (64, 9)),
])
def test_widths_of_refuses_a_misshapen_expert_leaf(params, leaf, shape):
    bad = dict(params, **{leaf: np.zeros(shape, np.float32)})
    with pytest.raises(ValueError):
        vit.widths_of(bad)


def test_widths_of_refuses_a_missing_or_wrong_k(params):
    lacking = {k: v for k, v in params.items() if k != "vit/top_k"}
    with pytest.raises(ValueError, match="lack or misshape"):
        vit.widths_of(lacking)
    for k in (0, 9):
        with pytest.raises(ValueError, match="other leaves"):
            vit.widths_of(dict(params, **{"vit/top_k": np.asarray(k)}))


def _layer_inputs(t=300, e=8, d=64, m=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    return dict(y=torch.randn(t, d, generator=g),
                u=torch.randn(t, d, generator=g),
                router=torch.randn(d, e, generator=g),
                w1=0.1 * torch.randn(e, d, m, generator=g),
                b1=0.1 * torch.randn(e, m, generator=g),
                w2=0.1 * torch.randn(e, m, d, generator=g),
                b2=0.1 * torch.randn(e, d, generator=g))


def _reference_layer(x, k):
    p = {"L/router/weights": x["router"],
         "L/experts/mlp1/weights": x["w1"], "L/experts/mlp1/biases": x["b1"],
         "L/experts/mlp2/weights": x["w2"], "L/experts/mlp2/biases": x["b2"]}
    routed = []
    out = reference_vmoe.moe(x["y"], x["u"], p, "L", k, routed)
    return out, routed[0]


@pytest.mark.parametrize("case", ["even", "one_idle_one_everywhere"])
def test_moe_plain_against_the_reference(case):
    """The MoE op's plain versions (the CPU's route) against the reference's
    loop over experts in f32: the same two experts on every token, and the
    layer's output within 1e-5 (the same products in f32, summed in other
    orders); with expert 2 given no rows and expert 5 given every token's
    first row, the offsets show it and the histogram counts each expert's
    rows."""
    x = _layer_inputs()
    if case != "even":
        # u's first feature >= 4 and W_r's first row +4 on expert 5, -4 on
        # expert 2: logits >= 16 and <= -16 there, N(0, 2) elsewhere, so
        # 5 is every token's first and 2 no token's; no probability
        # underflows, so the reference's top-2 of the softmax is defined
        x["router"] *= 0.25
        x["router"][0] = 0.0
        x["router"][0, 5] = 4.0
        x["router"][0, 2] = -4.0
        x["u"][:, 0] = x["u"][:, 0].abs() + 4.0
    rows = torch.zeros(8, dtype=torch.int64)
    with torch.no_grad():
        got = moe.moe_mlp(x["y"], x["u"], x["router"], x["w1"], x["b1"],
                          x["w2"], x["b2"], 2, rows)
        want, experts = _reference_layer(x, 2)
        top = moe.moe_route(x["u"] @ x["router"], 2)[0]
    assert torch.equal(top.long(), experts)
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(rows, torch.bincount(experts.reshape(-1),
                                            minlength=8))
    if case != "even":
        assert int(rows[2]) == 0 and int(rows[5]) == 300
        offsets = moe.moe_route(x["u"] @ x["router"], 2)[4]
        assert int(offsets[2]) == int(offsets[1])


def test_moe_route_slots_are_expert_order():
    """The route's slots (bases + ranks, as the dispatch makes them) put the
    pairs in (expert, token, j) order over every route block: a stable
    sort of the experts, each slot once; ties go to the lower index."""
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(700, 8, generator=g)
    logits[100:400, 3] += 5.0
    logits[7] = 1.0
    top, gates, ranks, bases, offsets = moe.moe_route(logits, 3)
    _, slots = moe.moe_dispatch(torch.zeros(700, 16), top, ranks, bases)
    flat = top.reshape(-1).long()
    assert torch.equal(slots.reshape(-1).long().argsort(),
                       torch.sort(flat, stable=True)[1])
    assert offsets.tolist() == torch.bincount(flat, minlength=8).cumsum(
        0).tolist()
    assert top[7].tolist() == [0, 1, 2]
    torch.testing.assert_close(gates, torch.softmax(logits, 1).gather(
        1, top.long()))


def test_f32_logits_and_routing_against_the_reference(params):
    """The network in f32 (TF32 off) on the raster, with the normalisation
    folded in, routes every token of every sparse layer to the reference's
    two experts and gives its logits within 1e-5: both sum the same
    products in f32, in other orders."""
    specs = _specs()
    model = _model(params)
    with torch.no_grad(), engine_mod.exact_f32():
        got = model(_raster(specs)).double()
    routed = []
    want = _reference(params, specs, routed)
    assert float((got - want).abs().max()) <= 1e-5
    rows = model.expert_rows
    assert rows.shape == (2, 8)
    for got_rows, experts in zip(rows, routed):
        assert torch.equal(got_rows, torch.bincount(experts.reshape(-1),
                                                    minlength=8))


def _engine_readings(params, bf16, specs, **kw):
    eng = InferenceEngine(params, batch_size=32, chunk=4, bf16=bf16,
                          device="cpu", **kw)
    preds, softs = eng.predict_specs(specs)
    ref = _reference(params, specs)
    soft = torch.softmax(ref, dim=1)
    top2 = ref.topk(2, dim=1).values
    return eng, preds, softs, soft, (top2[:, 0] - top2[:, 1]).numpy()


def test_f32_engine_against_the_reference(params, monkeypatch):
    """The engine in f32 (bf16=False, the CPU's plain MoE) on 200 specs,
    sentinels included: every token of every sparse layer routed to the
    reference's two experts, its max softmax within 1e-5 of the
    reference's, its argmax the reference's wherever the reference's top
    two logits lie more than 1e-4 apart (f32 rounding of the logits, about
    1e-6 here, decides nearer ties)."""
    specs = _specs()
    tops = []
    route = moe.moe_route

    def kept(logits, k, rows=None):
        out = route(logits, k, rows)
        tops.append(out[0].long())
        return out
    kept.launches = 0
    monkeypatch.setattr(moe, "moe_route", kept)
    eng, preds, softs, soft, gap = _engine_readings(params, False, specs)
    assert float(np.abs(softs - soft.max(dim=1).values.numpy()).max()) <= 1e-5
    clear = gap > 1e-4
    assert clear.mean() > 0.95
    assert np.array_equal(preds[clear], soft.argmax(dim=1).numpy()[clear])
    assert len(set(preds.tolist())) >= 3
    # the engine's batches of 32 (the sentinel padding after the specs)
    # against the reference's routing of the same images
    routed = []
    padded = np.concatenate([specs, np.repeat(SENTINEL, 224 - len(specs), 0)])
    _reference(params, padded, routed)
    per_layer = [torch.cat(tops[j::2]) for j in range(2)]
    for got, want in zip(per_layer, routed):
        assert torch.equal(got, want)
    # expert_choices: the same routing, image by image
    choices = eng.expert_choices(specs)
    assert [c.shape for c in choices] == [(200, 197, 2)] * 2
    for got, want in zip(choices, routed):
        assert np.array_equal(got.reshape(-1, 2),
                              want[:200 * 197].numpy())


def test_expert_choices_read_past_a_faulty_step(params):
    """expert_choices() runs the network alone, not the step that answers a
    call: with the benchmark's half_batch fault planted in the step (each
    batch's second half answered with its first half's answers), the
    engine's answers change and its routing reads as it does without it."""
    from benchmark import faults
    specs = _specs(64)
    eng = InferenceEngine(params, batch_size=32, chunk=2, bf16=False,
                          device="cpu")
    preds, _ = eng.predict_specs(specs)
    choices = eng.expert_choices(specs)
    with faults.half_batch():
        bad, _ = eng.predict_specs(specs)
        planted = eng.expert_choices(specs)
    assert np.array_equal(bad[16:32], bad[:16])
    assert not np.array_equal(bad, preds)
    assert all(np.array_equal(a, b) for a, b in zip(choices, planted))


def test_reference_takes_a_given_routing(fitted):
    """The reference given its own routing gives its own logits. Given the
    bf16 engine's routing (expert_choices, which differs from the f32
    routing in some tokens' second expert), the engine's bf16 answers lie
    closer to it than to the reference with its own routing: in the mean
    of the max-softmax gap, and in its widest, which the tokens whose
    routing differs dominate."""
    specs = _specs()
    routed = []
    own = _reference(fitted, specs, routed)
    with reference_vmoe.f32_exact():
        again = reference_vmoe.logits(fitted, _raster(specs), routing=routed)
    assert torch.equal(own, again.double())
    eng = InferenceEngine(fitted, batch_size=32, chunk=2, device="cpu")
    choices = eng.expert_choices(specs)
    differ = [(torch.from_numpy(c).long().reshape(-1, 2)
               != r[:len(specs) * 197]).any(1).float().mean()
              for c, r in zip(choices, routed)]
    assert all(0 < float(d) < 0.2 for d in differ)
    with reference_vmoe.f32_exact():
        given = reference_vmoe.logits(fitted, _raster(specs), routing=[
            torch.from_numpy(c).long().reshape(-1, 2) for c in choices])
    _, softs = eng.predict_specs(specs)
    err_given = np.abs(softs - torch.softmax(given.double(), 1).max(1)
                       .values.numpy())
    err_own = np.abs(softs - torch.softmax(own, 1).max(1).values.numpy())
    assert err_given.mean() < err_own.mean()
    assert err_given.max() < err_own.max()


def test_bf16_engine_against_the_reference(fitted):
    """The default engine (bf16) on the same specs, on the fitted weights.
    bf16 rounds every weight and activation to 8 significant bits (2^-9
    relative), the fit scales the features' spread over images up to
    logits of std 2, and the rounding moves the routing besides: here 2%
    of the first sparse layer's tokens and 7% of the second's take another
    second expert than in f32 (gates within the rounding of each other),
    which moves an image's output by a share of a gate. The max softmax
    moves by mean 0.030, widest 0.45 (two images past 0.2); the argmax
    agrees on 94.5% of the rows, and no disagreement has a top-two logit
    gap past 1.35. Bounds at about 1.5x those: mean 0.045, widest 0.7,
    the argmax the reference's wherever the top two logits lie more than 2
    apart and on at least 90% of the rows."""
    specs = _specs()
    _, preds, softs, soft, gap = _engine_readings(fitted, True, specs)
    err = np.abs(softs - soft.max(dim=1).values.numpy())
    assert err.mean() <= 0.045 and err.max() <= 0.7
    want = soft.argmax(dim=1).numpy()
    assert np.array_equal(preds[gap > 2.0], want[gap > 2.0])
    assert (preds == want).mean() >= 0.9


@pytest.mark.parametrize("bf16", [True, False])
def test_an_image_alone_equals_it_in_a_batch(params, bf16):
    """No capacity: a token reaches its experts whatever its batchmates
    route, so an image's answer alone (a batch of sentinel padding) is its
    answer among 99 others, bit for bit."""
    specs = _specs(100, seed=6)
    eng = InferenceEngine(params, batch_size=32, chunk=2, bf16=bf16,
                          device="cpu")
    p_all, s_all = eng.predict_specs(specs)
    for i in (0, 41, 99):
        p, s = eng.predict_specs(specs[i:i + 1])
        assert p[0] == p_all[i] and s[0] == s_all[i]


@pytest.mark.parametrize("mode", [dict(int8=True), dict(fast=False),
                                  dict(raster="compare"),
                                  dict(raster="pallas")])
def test_modes_out_of_scope_refuse_vmoe_weights(params, mode):
    with pytest.raises(ValueError, match="vmoe_b16 weights"):
        InferenceEngine(params, device="cpu", **mode)


def test_exact_mode_refuses_the_card(params):
    """bf16=False runs the plain MoE on the CPU; a card's replicas refuse
    it, since the kernels and torch._grouped_mm take bf16 alone."""
    eng = InferenceEngine(params, bf16=False, device="cpu")
    with pytest.raises(ValueError, match="bf16"):
        eng._replicas_for(params, "cuda")


def test_engine_call_attributes_and_expert_rows(params):
    """engine.call says network 'vmoe_b16', tokens = padded rows x 197, the
    experts, k, the sparse layers and routed rows = padded rows x 197 x 2
    x 2, and no kernel launches on the CPU; expert_rows() gives the rows
    each expert took in each sparse layer since its last call, summed over
    the replicas (a CPU mesh of two here), then zeroed, and counts them
    under moe.expert_rows/<layer>/<expert> while recording."""
    eng = InferenceEngine(params, batch_size=16, chunk=2,
                          devices=("cpu", "cpu"))
    assert eng.network == "vmoe_b16"
    eng.predict_specs(_specs(5, seed=3))
    assert int(eng.expert_rows().sum()) == 32 * 197 * 2 * 2
    specs = _specs(70, seed=2)
    with trace.recording() as rec:
        eng.predict_specs(specs)
        rows = eng.expert_rows()
    (call,) = rec.find("engine.call")
    chunks, singles = eng.plan(70)
    padded = (sum(chunks) + singles) * 32
    assert call.attrs["network"] == "vmoe_b16"
    assert call.attrs["padded_rows"] == padded
    assert call.attrs["tokens"] == padded * 197
    assert (call.attrs["experts"], call.attrs["top_k"],
            call.attrs["moe_layers"]) == (8, 2, [1, 3])
    assert call.attrs["routed_rows"] == padded * 197 * 2 * 2
    assert call.attrs["launches"] == {w.__name__: 0
                                      for w in graphs.kernel_wrappers()}
    assert rows.shape == (2, 8) and rows.dtype == np.int64
    assert int(rows.sum()) == call.attrs["routed_rows"]
    assert dict(rec.counts) == {f"moe.expert_rows/{layer}/{e}": int(n)
                                for layer, row in zip((1, 3), rows)
                                for e, n in enumerate(row)}
    assert int(eng.expert_rows().sum()) == 0
    dense = InferenceEngine(vit.init_params(0, vit.Widths(
        hidden=64, layers=1, heads=4, mlp=128)), device="cpu")
    assert dense.expert_rows() is None


def test_cli_reaches_the_vmoe_from_m(params, tmp_path, monkeypatch):
    """svision-tpu-torch -m vmoe.npz (--exact --device cpu) runs the V-MoE,
    read from the checkpoint's leaves with no flag, through its sparse
    layers, and writes a VCF."""
    from svision_tpu_torch import cli, sim
    from svision_tpu_torch.models.checkpoint import load_params, save_params
    weights = str(tmp_path / "vmoe.npz")
    save_params(params, weights)
    back = load_params(weights)
    assert set(back) == set(params) and int(back["vit/top_k"]) == 2
    genome = str(tmp_path / "ref.fa")
    seqs = sim.make_genome(genome, {"chr1": 60000}, seed=3)
    bam = str(tmp_path / "s.bam")
    sim.make_sv_bam(bam, seqs, seed=3, support=8,
                    events=[("DEL", "chr1", 20000, 300)])
    layers = []
    mlp = moe.moe_mlp

    def counted(y, u, *a, **k):
        layers.append(y.shape[0])
        return mlp(y, u, *a, **k)
    monkeypatch.setattr(moe, "moe_mlp", counted)
    vcf = cli.run_pipeline(cli.parse_arguments([
        "-o", str(tmp_path / "out"), "-b", bam, "-g", genome, "-m", weights,
        "-n", "s", "-s", "3", "--batch_size", "8", "--exact",
        "--device", "cpu", "--mesh", "none"]))
    assert layers and all(n == 8 * 197 for n in layers)
    assert len(layers) % 2 == 0
    lines = open(vcf).read().splitlines()
    assert lines[0].startswith("##fileformat=VCF")
    assert any(not l.startswith("#") for l in lines)
