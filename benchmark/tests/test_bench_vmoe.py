"""The V-MoE cell's own pieces: its work counts against a hand sum, its
reference against the plain one of the port's tests, its weights and their
fit, its mix, its entries, and its readers on a synthetic traced run
(nothing read from a program whose engine runs another network)."""

import math
import types

import numpy as np
import pytest
import torch

from benchmark import spec, traffic, work, work_vit, work_vmoe
from benchmark.drivers import engine_vmoe
from benchmark.reference import alexnet as ref_alexnet
from benchmark.reference import raster as ref_raster
from benchmark.reference import vmoe as ref_vmoe
from benchmark.tests.test_bench_vit import kernel_trace, span_record
from tests import reference_vmoe

torch.set_num_threads(2)

BENCH = spec.load()
CELL = "vmoe-b16.genome"
CONFIG = "svision-vmoe-b16-e32-bf16"
H100 = "NVIDIA H100 80GB HBM3"
MODEL = spec.config(BENCH, CONFIG)["model"]
SMALL = dict(MODEL, hidden=64, layers=4, heads=4, mlp=128, experts=8,
             moe_layers=[1, 3], head_images=48)
METRICS = ("mfu_pct.vmoe", "moe_gemm_roofline.vmoe",
           "moe_route_roofline.vmoe", "expert_load_max_pct.vmoe",
           "device_idle_pct.vmoe", "host_busy_pct.vmoe",
           "attn_roofline.vmoe", "norm_act_roofline.vmoe", "k1_roofline.vmoe",
           "dispatch_idle_pct.vmoe")
# the ViT's readers that the V-MoE's siblings of the same name delegate to
SHARED = {"attn_roofline.vmoe": "attn_roofline.vit",
          "norm_act_roofline.vmoe": "norm_act_roofline.vit",
          "k1_roofline.vmoe": "k1_roofline.vit",
          "dispatch_idle_pct.vmoe": "dispatch_idle_pct.predict"}
GEMM = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_"
        "sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShapeIN4cute5"
        "tupleIJiiiEEEEENS5_10collective13CollectiveMma")


def test_inference_flops_against_a_hand_sum():
    """The ViT's 35,126,128,128 FLOPs an image, plus each token's second
    expert in each of the 6 sparse layers (6 x 197 x 2 x 2 x 768 x
    3,072), plus the 6 routers (6 x 197 x 2 x 768 x 32)."""
    vit = work_vit.inference_flops(MODEL)
    assert vit == 35_126_128_128
    second = 6 * 197 * 2 * 2 * 768 * 3072
    routers = 6 * 197 * 2 * 768 * 32
    assert (second, routers) == (11_154_751_488, 58_097_664)
    assert work_vmoe.inference_flops(MODEL) == vit + second + routers \
        == 46_338_977_280
    macs = work_vmoe.layer_macs(MODEL)
    assert macs["mlp1"] == (12 + 6) * 197 * 768 * 3072
    assert macs["router"] == 6 * 197 * 768 * 32


def test_stage_counts():
    """A launch's bytes at 128 images (T = 25,216 tokens, R = 50,432 routed
    rows): each grouped product reads its rows and all 32 experts'
    matrices and writes its products, at 2 R x 768 x 3,072 FLOPs; the
    bias-GELU reads and writes R x 3,072 and reads the biases; the
    dispatch reads T rows and writes R; the combine reads T and R rows and
    writes T."""
    t, r = 128 * 197, 128 * 197 * 2
    gemm = work_vmoe.gemm_stages(MODEL, 128, "bfloat16")
    assert gemm["mlp1"] == ((r * 768 + 32 * 768 * 3072 + r * 3072) * 2
                            + 32 * 4, 2 * r * 768 * 3072)
    assert gemm["mlp2"][0] == gemm["mlp1"][0]
    st = work_vmoe.route_stages(MODEL, 128, "bfloat16")
    blocks = -(-t // 128)
    assert st["bias_gelu"] == (2 * r * 3072 * 2 + 32 * 3072 * 2 + 32 * 4,
                               15 * r * 3072)
    assert st["dispatch"][0] == (t * 768 * 2 + r * 768 * 2 + 3 * r * 4
                                 + blocks * 32 * 4)
    assert st["combine"][0] == (2 * t * 768 * 2 + r * 768 * 2
                                + 32 * 768 * 2 + 3 * r * 4)


def test_the_config_is_the_vits_with_experts():
    """The configuration's model section is the ViT cell's, key for key, and
    experts 32, top_k 2, moe_layers 1, 3, ..., 11 and gate_mass 0.6; its
    engine section is the ViT's; nothing is reduced."""
    vit_cfg = spec.config(BENCH, "svision-vit-b16-bf16")
    cfg = spec.config(BENCH, CONFIG)
    extra = {k: v for k, v in MODEL.items() if k not in vit_cfg["model"]}
    assert extra == {"experts": 32, "top_k": 2,
                     "moe_layers": [1, 3, 5, 7, 9, 11], "gate_mass": 0.6}
    assert all(MODEL[k] == v for k, v in vit_cfg["model"].items())
    assert cfg["engine"] == vit_cfg["engine"] and cfg["reduced"] == []
    (entry,) = [c for c in BENCH["configs"] if c["name"] == CONFIG]
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]


def test_the_mix_is_genome_vits_but_for_its_driver():
    vit_mix, mix = spec.traffic("genome-vit"), spec.traffic("genome-vmoe")
    assert mix["driver"] == "engine_vmoe"
    assert {k: v for k, v in mix.items() if k not in ("driver", "about")} \
        == {k: v for k, v in vit_mix.items() if k not in ("driver", "about")}


def test_entries():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in METRICS:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "images_per_s"
    (ips,) = [m for m in BENCH["end_to_end"] if m["name"] == "images_per_s"]
    assert CELL in ips["workloads"]
    (cell,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "genome-vmoe", 1)
    lim = spec.limits(CELL)
    assert lim["control"] == "fp8"
    assert lim["faults"] == ["answer_altered", "half_batch"]


def small_images(n=24, seed=5):
    specs = traffic.random_specs(n, traffic.rng(seed, "vmoe"))
    ep, vis, rev = (torch.from_numpy(np.ascontiguousarray(a))
                    for a in ref_raster.endpoints(specs))
    return ref_raster.draw(ep, vis, rev)


def test_reference_equals_the_tests_plain_vmoe():
    """The benchmark's reference and the port's tests' reference
    (tests/reference_vmoe.py) are written apart; on one small seeded
    V-MoE and one set of images they route every token to the same two
    experts and agree to f32 rounding."""
    params = engine_vmoe.params(SMALL, 3, torch.device("cpu"))
    raster = small_images()
    p = {k: v for k, v in params.items()
         if k not in ("vit/heads", "vit/top_k")}
    routed = []
    with torch.no_grad(), ref_alexnet.f32_exact():
        ours = ref_vmoe.logits(p, ref_raster.normalize(raster), SMALL)
        theirs = reference_vmoe.logits(params, raster, routed)
    assert len(routed) == 2
    assert float((ours - theirs).abs().max()) <= 1e-4 * float(ours.abs().max())


def test_weights_are_the_seeds_and_the_fit_holds():
    """The same seed gives the same weights, another seed others; vit/heads
    and vit/top_k hold 4 and 2; each expert's matrix is Xavier-uniform
    over its own fans before the fit; the fit gives the seed's head
    images a mean top-2 gate mass of gate_mass in every sparse layer and
    logits of std logit_std a class, and the classes split the images."""
    dev = torch.device("cpu")
    a = engine_vmoe.params(SMALL, 7, dev)
    b = engine_vmoe.params(SMALL, 7, dev)
    c = engine_vmoe.params(SMALL, 8, dev)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vit/layer1/experts/mlp1/weights"],
                           c["vit/layer1/experts/mlp1/weights"])
    assert (int(a["vit/heads"]), int(a["vit/top_k"])) == (4, 2)
    w = a["vit/layer3/experts/mlp2/weights"]
    assert w.shape == (8, 128, 64)
    assert float(w.abs().max()) <= (6.0 / (128 + 64)) ** 0.5
    specs = traffic.random_specs(SMALL["head_images"], traffic.rng(7, "head"))
    p = {k: v for k, v in a.items() if k not in ("vit/heads", "vit/top_k")}
    masses = []

    def watch(name, pre):
        if name.endswith("/router"):
            top = torch.softmax(pre, -1).topk(2, dim=-1).values.sum(-1)
            masses.append(float(top.mean()))
        return pre
    with torch.no_grad(), ref_alexnet.f32_exact():
        lg = ref_vmoe.logits(p, ref_raster.images(specs, dev), SMALL,
                             fit=watch)
    assert masses == pytest.approx([0.6, 0.6], abs=1e-3)
    assert float(lg.mean(0).abs().max()) < 0.01
    assert torch.allclose(lg.std(0), torch.full((5,), 2.0), atol=0.01)
    share = torch.bincount(lg.argmax(1), minlength=5).float() / len(lg)
    assert int((share >= 0.05).sum()) >= 3


def test_gate_scale():
    """The bisection finds the scale at which the mean top-k mass is the
    target, from the even spread k / E at scale 0 up."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(500, 32, generator=g)
    for mass in (0.2, 0.6, 0.95):
        s = engine_vmoe.gate_scale(logits, 2, mass)
        got = torch.softmax(logits * s, -1).topk(2, -1).values.sum(-1).mean()
        assert float(got) == pytest.approx(mass, abs=1e-4)


def test_the_driver_reads_the_counter_outside_the_timed_path():
    """The driver reads the engine's expert_rows() at the end of the window
    and of each slice, after the window's clock has stopped."""
    reads = []
    drv = engine_vmoe.Driver.__new__(engine_vmoe.Driver)
    drv.engine = types.SimpleNamespace(
        expert_rows=lambda: reads.append("rows"),
        predict_specs=lambda specs: reads.append("call") or (
            np.zeros(len(specs), np.int64), np.zeros(len(specs), np.float32)),
        plan=lambda n: ([], 1), batch_size=128,
        _SENTINEL=np.zeros((1, 12), np.int64))
    drv.calls = [("chr1", np.zeros((5, 12), np.int64))]
    drv.mix = {"trace_calls": 1}
    drv.window(0.0)
    assert reads == ["call", "rows"]
    drv.slice()
    assert reads == ["call", "rows", "call", "rows"]


def counted_record(network, rows):
    """span_record's slice with the program's counters of each sparse
    layer's rows (rows: {layer: [rows of each expert]})."""
    rec = span_record(network)
    rec.counts = {f"moe.expert_rows/{layer}/{e}": n
                  for layer, row in rows.items() for e, n in enumerate(row)}
    return rec


def vmoe_ctx(network="vmoe_b16", rows=None):
    """A traced run's ctx: one sparse layer's MoE kernels a batch and the
    kernels the V-MoE shares with the ViT (K1, attention, LayerNorm, the
    dense layers' GELU, the adds), named as the trace names them, at 128
    rows a launch."""
    tr = kernel_trace(
        [("void raster_kernel<1>(int const*, unsigned char const*, "
          "unsigned char const*, __nv_bfloat16*, int)", 20, 1),
         ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_"
          "64x128x64_4x1x1_cga1x1x1_kernel0_0", 80, 12),
         ("void at::native::(anonymous namespace)::vectorized_layer_norm_"
          "kernel<c10::BFloat16, float, false>(int, float, c10::BFloat16 "
          "const*, c10::BFloat16 const*, c10::BFloat16 const*, float*, "
          "float*, c10::BFloat16*)", 30, 25),
         ("void at::native::vectorized_elementwise_kernel<8, "
          "at::native::GeluCUDAKernelImpl(at::TensorIteratorBase&, "
          "at::native::GeluType)::{lambda()#1}>", 120, 6),
         ("void at::native::vectorized_elementwise_kernel<8, "
          "at::native::CUDAFunctor_add<c10::BFloat16>>", 40, 19),
         (GEMM + "...", 400, 2),
         ("void at::cuda::detail::prepare_grouped_gemm_data<cutlass::"
          "bfloat16_t>(int const*)", 2, 2),
         ("(anonymous namespace)::moe_route_kernel(float const*, int, int, "
          "int, int*, float*, int*, int*, int*, long long*, unsigned int*)",
          45, 1),
         ("(anonymous namespace)::moe_dispatch_kernel(uint4 const*, int, int, "
          "int, int, int const*, int const*, int const*, int*, uint4*)", 40,
          1),
         ("(anonymous namespace)::moe_bias_gelu_kernel(uint4*, uint4 const*, "
          "int, int, int const*)", 210, 1),
         ("(anonymous namespace)::moe_combine_kernel(uint4 const*, uint4 "
          "const*, uint4 const*, int const*, float const*, int const*, int, "
          "int, int, uint4*)", 55, 1)])
    rows = rows or {1: [30, 10, 0, 0], 3: [10, 10, 10, 10]}
    return types.SimpleNamespace(
        window={"images": 8_000, "seconds": 1.0}, trace=tr,
        spans=counted_record(network, rows),
        driver=types.SimpleNamespace(rows_per_launch=128),
        device_name=H100, chips=1, config=spec.config(BENCH, CONFIG))


def test_readers_on_a_traced_run():
    ctx = vmoe_ctx()
    got = {m: spec.metric(m).read(ctx) for m in METRICS}
    assert got["mfu_pct.vmoe"] == pytest.approx(
        100 * 8_000 * 46_338_977_280 / 989.4e12)
    gemm = work_vmoe.gemm_stages(MODEL, 128, "bfloat16")
    least = 2 * sum(work.least_s(b, f, H100, "bfloat16")
                    for b, f in gemm.values()) / 2
    assert got["moe_gemm_roofline.vmoe"] == pytest.approx(
        100 * least / 800e-6)
    st = work_vmoe.route_stages(MODEL, 128, "bfloat16")
    least = sum(work.least_s(*st[k], H100, "float32")
                for k in ("dispatch", "bias_gelu", "combine"))
    assert got["moe_route_roofline.vmoe"] == pytest.approx(
        100 * least / 305e-6)
    # layer 1: the busiest expert 30 rows of a mean of 10
    assert got["expert_load_max_pct.vmoe"] == pytest.approx(300.0)
    assert got["device_idle_pct.vmoe"] == ctx.trace.idle_pct()
    assert got["host_busy_pct.vmoe"] == pytest.approx(40.0)
    for name, vit_name in SHARED.items():
        assert got[name] == spec.metric(vit_name).read(ctx), name
    for name, v in got.items():
        assert 0 < v <= 400, name
    even = vmoe_ctx(rows={1: [5, 5, 5, 5]})
    assert spec.metric("expert_load_max_pct.vmoe").read(even) == 100.0


@pytest.mark.parametrize("network", ["vit_b16", "alexnet", None])
def test_readers_need_the_vmoe(network):
    """A program whose engine ran another network, or says nothing of it (a
    parent without the V-MoE), gives no metric of this cell."""
    ctx = vmoe_ctx(network)
    for name in METRICS:
        assert spec.metric(name).read(ctx) is None, name


def test_untraced_and_empty_runs_read_nothing():
    ctx = vmoe_ctx()
    untraced = types.SimpleNamespace(**{**vars(ctx), "trace": None,
                                        "window": {}})
    for name in METRICS:
        assert spec.metric(name).read(untraced) is None, name
    empty = types.SimpleNamespace(**{**vars(ctx), "trace": kernel_trace(
        [("void other_kernel()", 10, 1)])})
    for name in ("moe_gemm_roofline.vmoe", "moe_route_roofline.vmoe"):
        assert spec.metric(name).read(empty) is None, name
    uncounted = vmoe_ctx(rows={1: [0, 0]})
    uncounted.spans.counts = {}
    assert spec.metric("expert_load_max_pct.vmoe").read(uncounted) is None


def stub_driver(seed=3):
    drv = engine_vmoe.Driver.__new__(engine_vmoe.Driver)
    drv.model, drv.devices = SMALL, [torch.device("cpu")]
    drv.params = {k: v.numpy() for k, v in
                  engine_vmoe.params(SMALL, seed, torch.device("cpu")).items()}
    return drv


def test_readings_hold_answers_to_the_reference_given_their_routing():
    """The check's readings: the reference's own answers, given its own
    routing, read 0 everywhere, and so they do given its top two in the
    other order. Given each token's first expert alone (the top1
    control's routing), the routing falls short of the top-2 mass by the
    second gate, past the tie where that gate is, and the reference keeps
    its own top two on those tokens, so the softmax readings see it too.
    A routing that cannot be read for every row reads inf."""
    drv = stub_driver()
    specs = traffic.random_specs(40, traffic.rng(2, "readings"))
    own = []
    lg = drv.reference_logits(specs, routed=own)
    pr = torch.softmax(lg, 1)
    preds, softs = pr.argmax(1).numpy(), pr.max(1).values.numpy()
    routing = [e.numpy() for e, _ in own]
    assert [r.shape for r in routing] == [(40, 197, 2)] * 2
    got = drv.readings(specs, preds, softs, routing)
    assert set(got) == set(engine_vmoe.READINGS)
    assert got["argmax_gap"] == 0 and got["route_miss_max"] == 0
    assert got["softmax_err"] < 1e-6
    swapped = drv.readings(specs, preds, softs, [r[..., ::-1].copy()
                                                 for r in routing])
    assert swapped["route_miss_max"] < 1e-6 and swapped["softmax_err"] < 1e-6
    one = []
    lg1 = drv.reference_logits(specs, top1=True, routed=one)
    pr1 = torch.softmax(lg1, 1)
    got1 = drv.readings(specs, pr1.argmax(1).numpy(),
                        pr1.max(1).values.numpy(),
                        [e.numpy() for e, _ in one])
    # the first sparse layer's inputs are the reference's own: there the
    # shortfall is each token's second gate
    second = one[0][1].reshape(-1)
    assert got1["route_miss_max"] >= float(second.max()) > engine_vmoe.TIE
    assert 0.05 < got1["route_miss_mean"] < 0.4
    assert got1["softmax_err"] > 0.01
    short = [r[:20] for r in routing]
    assert all(v == float("inf")
               for v in drv.readings(specs, preds, softs, short).values())
    assert all(v == float("inf")
               for v in drv.readings(specs, preds, softs, None).values())


def test_a_wrong_expert_past_the_tie_moves_the_answers(monkeypatch):
    """A routing fault that gives a twentieth of the tokens their least
    likely expert in place of their second: the reference keeps its own
    experts on those whose second gate lies past the tie, so the answers
    given that routing differ from its own, and route_miss_max reads the
    worst token's shortfall, past the tie."""
    drv = stub_driver()
    specs = traffic.random_specs(40, traffic.rng(2, "readings"))
    own = []
    drv.reference_logits(specs, routed=own)
    wrong = []
    g = torch.Generator().manual_seed(0)
    for e, _ in own:
        r = e.clone()
        hit = torch.rand(r.shape[:2], generator=g) < 0.05
        r[..., 1] = torch.where(hit, (r[..., 0] + 1) % SMALL["experts"],
                                r[..., 1])
        wrong.append(r.numpy())
    # the faulty program's answers: every token on the experts it was given
    with monkeypatch.context() as m:
        m.setattr(engine_vmoe, "TIE", math.inf)
        lg = drv.reference_logits(specs, routing=wrong)
    pr = torch.softmax(lg, 1)
    got = drv.readings(specs, pr.argmax(1).numpy(), pr.max(1).values.numpy(),
                       wrong)
    assert got["route_miss_max"] > engine_vmoe.TIE
    assert got["softmax_err"] > 0.01
    assert spec.limits(CELL)["limits"]["route_miss_max"] == engine_vmoe.TIE
