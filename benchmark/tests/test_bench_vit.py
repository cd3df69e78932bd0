"""The ViT cell's own pieces: its work counts, its reference against the
plain one of the port's tests, its weights, and its readers on a
synthetic traced run (nothing read from a program whose engine runs
another network)."""

import types

import numpy as np
import pytest
import torch

from benchmark import devtrace, spec, work, work_vit
from benchmark.drivers import engine_vit
from benchmark.reference import alexnet as ref_alexnet
from benchmark.reference import raster as ref_raster
from benchmark.reference import vit as ref_vit
from svision_tpu_torch import trace
from tests import reference_vit

torch.set_num_threads(2)

BENCH = spec.load()
CELL = "vit-b16.genome"
H100 = "NVIDIA H100 80GB HBM3"
MODEL = spec.config(BENCH, "svision-vit-b16-bf16")["model"]
SMALL = dict(MODEL, hidden=64, layers=2, heads=4, mlp=128, head_images=48)
METRICS = ("mfu_pct.vit", "attn_roofline.vit", "norm_act_roofline.vit",
           "k1_roofline.vit", "device_idle_pct.vit", "dispatch_idle_pct.vit",
           "host_busy_pct.vit")


def test_inference_flops():
    """2 x the multiply-accumulates of the patch embedding, q k v, q k^T,
    the softmax times v, the output projection, both MLP layers and the
    head, at ViT-B/16's widths on the 227 image's 197 tokens."""
    assert work_vit.tokens(MODEL) == 197
    assert work_vit.inference_flops(MODEL) == 35_126_128_128
    macs = work_vit.layer_macs(MODEL)
    assert macs["patch"] == 196 * 768 * 768
    assert macs["qk"] == macs["pv"] == 12 * 197 * 197 * 768
    assert macs["head"] == 768 * 5


def test_stage_counts():
    """A launch's bytes: attention reads q, k, v and writes its output; a
    batch launches 2 LayerNorms a layer and the last one, a GELU a layer,
    2 residual adds a layer and the positions' add."""
    nbytes, flops = work_vit.attn_stage(MODEL, 128, "bfloat16")
    assert nbytes == 4 * 128 * 197 * 768 * 2
    assert flops == 4 * 128 * 12 * 197 * 197 * 64
    st = work_vit.norm_act_stages(MODEL, 128, "bfloat16")
    assert [len(st[k]) for k in ("ln", "gelu", "add")] == [25, 12, 25]
    assert st["gelu"][0][0] == 2 * 128 * 197 * 3072 * 2
    assert st["ln"][-1][0] == (2 * 128 * 768 + 2 * 768) * 2


def test_reference_equals_the_tests_plain_vit():
    """The benchmark's reference and the port's tests' reference
    (tests/reference_vit.py) are written apart; on one small seeded ViT
    and one set of images they agree to f32 rounding."""
    params = engine_vit.params(SMALL, 3, torch.device("cpu"))
    specs = ref_raster_specs(24)
    ep, vis, rev = (torch.from_numpy(np.ascontiguousarray(a))
                    for a in ref_raster.endpoints(specs))
    raster = ref_raster.draw(ep, vis, rev)
    p = {k: v for k, v in params.items() if k != "vit/heads"}
    with torch.no_grad(), ref_alexnet.f32_exact():
        ours = ref_vit.logits(p, ref_raster.normalize(raster), SMALL)
        theirs = reference_vit.logits(params, raster)
    assert float((ours - theirs).abs().max()) <= 1e-4 * float(ours.abs().max())


def ref_raster_specs(n, seed=5):
    from benchmark import traffic
    return traffic.random_specs(n, traffic.rng(seed, "vit"))


def test_weights_are_the_seeds_and_the_classes_split():
    """The same seed gives the same weights, another seed others; vit/heads
    holds the head count; the fit gives the seed's head images logits of
    mean 0 and std logit_std a class, so that at least 3 classes take 5% of
    the images or more."""
    dev = torch.device("cpu")
    a = engine_vit.params(SMALL, 7, dev)
    b = engine_vit.params(SMALL, 7, dev)
    c = engine_vit.params(SMALL, 8, dev)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vit/pos"], c["vit/pos"])
    assert int(a["vit/heads"]) == 4
    from benchmark import traffic
    specs = traffic.random_specs(SMALL["head_images"], traffic.rng(7, "head"))
    p = {k: v for k, v in a.items() if k != "vit/heads"}
    with torch.no_grad(), ref_alexnet.f32_exact():
        lg = ref_vit.logits(p, ref_raster.images(specs, dev), SMALL)
    # computed again, the logits round otherwise: the fit scales the
    # images' small spread of features up to std 2, and f32 rounding with
    # it, to about 2e-3 here
    assert float(lg.mean(0).abs().max()) < 0.01
    assert torch.allclose(lg.std(0), torch.full((5,), 2.0), atol=0.01)
    share = torch.bincount(lg.argmax(1), minlength=5).float() / len(lg)
    assert int((share >= 0.05).sum()) >= 3


def kernel_trace(kernels):
    """A profiled slice of 10 ms on one card: each (name, us, times)."""
    ev = [types.SimpleNamespace(
        name=devtrace.SLICE, key=devtrace.SLICE,
        time_range=types.SimpleNamespace(start=0, end=10_000),
        device_type="DeviceType.CPU", device_index=-1, thread=1,
        is_user_annotation=True)]
    at = 0
    for name, us, times in kernels:
        for _ in range(times):
            ev.append(types.SimpleNamespace(
                name=name, key=name, time_range=types.SimpleNamespace(
                    start=at, end=at + us), device_type="DeviceType.CUDA",
                device_index=0, thread=1, is_user_annotation=False))
            at += us
    return devtrace.Trace(ev, [0])


def span_record(network):
    rec = types.SimpleNamespace()
    attrs = {"rows": 10, "padded_rows": 128, "network": network}
    call = trace.Span("engine.call", 1, None, 1, 1, 0, 600, attrs)
    sync = trace.Span("engine.sync", 2, 1, 1, 1, 400, 600, {})
    dev = trace.Span("engine.dispatch", 3, None, 1, 1, 100, 500, {}, device=0)
    spans = [call, sync, dev]
    rec.spans, rec.start_ns, rec.end_ns = spans, 0, 1000
    rec.find = lambda name, device=None: [
        s for s in spans if s.name == name and (
            device is None or (s.device is not None) == device)]
    return rec


def vit_ctx(network="vit_b16"):
    """A traced run's ctx: one batch's kernels, named as the trace names
    them, at 128 rows a launch."""
    ln = [("void at::native::(anonymous namespace)::vectorized_layer_norm_"
           "kernel<c10::BFloat16, float, false>(int, float, c10::BFloat16 "
           "const*, c10::BFloat16 const*, c10::BFloat16 const*, float*, "
           "float*, c10::BFloat16*)", 30, 25)]
    tr = kernel_trace(
        [("void raster_kernel<1>(int const*, unsigned char const*, "
          "unsigned char const*, __nv_bfloat16*, int)", 20, 1),
         ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_"
          "64x128x64_4x1x1_cga1x1x1_kernel0_0", 80, 12)] + ln
        + [("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::GeluCUDAKernelImpl(at::TensorIteratorBase&, "
            "at::native::GeluType)::{lambda()#1}>", 120, 12),
           ("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::CUDAFunctor_add<c10::BFloat16>>", 40, 25)])
    driver = types.SimpleNamespace(rows_per_launch=128)
    return types.SimpleNamespace(
        window={"images": 10_000, "seconds": 1.0}, trace=tr,
        spans=span_record(network), driver=driver, device_name=H100,
        chips=1, config=spec.config(BENCH, "svision-vit-b16-bf16"))


def test_entries():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in METRICS:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "images_per_s"
    (ips,) = [m for m in BENCH["end_to_end"] if m["name"] == "images_per_s"]
    assert CELL in ips["workloads"] and ips["bound"] == 0.035


def test_readers_on_a_traced_run():
    ctx = vit_ctx()
    got = {m: spec.metric(m).read(ctx) for m in METRICS}
    assert got["mfu_pct.vit"] == pytest.approx(
        100 * 10_000 * 35_126_128_128 / 989.4e12)
    least = work.least_s(*work_vit.attn_stage(MODEL, 128, "bfloat16"), H100,
                         "bfloat16")
    assert got["attn_roofline.vit"] == pytest.approx(100 * least / 80e-6)
    nbytes, _ = work.k1_stage(MODEL, 128, "bfloat16")
    assert got["k1_roofline.vit"] == pytest.approx(
        100 * nbytes / 3.35e12 / 20e-6)
    st = work_vit.norm_act_stages(MODEL, 128, "bfloat16")
    least = sum(work.least_s(b, f, H100, "float32")
                for kind in st.values() for b, f in kind)
    assert got["norm_act_roofline.vit"] == pytest.approx(
        100 * least / (25 * 30e-6 + 12 * 120e-6 + 25 * 40e-6))
    assert got["device_idle_pct.vit"] == ctx.trace.idle_pct()
    assert got["dispatch_idle_pct.vit"] == pytest.approx(60.0)
    assert got["host_busy_pct.vit"] == pytest.approx(40.0)
    for name, v in got.items():
        assert 0 < v <= 100, name


@pytest.mark.parametrize("network", ["alexnet", None])
def test_span_readers_need_the_vit(network):
    """A program whose engine ran another network, or says nothing of it
    (a parent without the ViT), gives no span metric here."""
    ctx = vit_ctx(network)
    assert spec.metric("dispatch_idle_pct.vit").read(ctx) is None
    assert spec.metric("host_busy_pct.vit").read(ctx) is None


def test_untraced_and_empty_runs_read_nothing():
    ctx = vit_ctx()
    untraced = types.SimpleNamespace(**{**vars(ctx), "trace": None,
                                        "window": {}})
    empty = types.SimpleNamespace(**{**vars(ctx), "trace": kernel_trace(
        [("void other_kernel()", 10, 1)])})
    for name in METRICS:
        assert spec.metric(name).read(untraced) is None, name
    for name in ("attn_roofline.vit", "norm_act_roofline.vit",
                 "k1_roofline.vit"):
        assert spec.metric(name).read(empty) is None, name
