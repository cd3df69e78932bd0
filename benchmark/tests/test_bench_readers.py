"""The readers as the program runs them: the engine driver's rows a
launch, K3 f32's roofline, the four-card cell's metrics under names of
their own, and the order of a traced run's slices."""

import types

import pytest
import torch

from benchmark import devtrace, run, spec, work
from benchmark.drivers import engine as engine_driver
from svision_tpu_torch import trace

BENCH = spec.load()
H100 = "NVIDIA H100 80GB HBM3"
MESH = "bf16-mesh4.genome"
SIBLINGS = {"images_per_s.mesh4": "images_per_s",
            "mfu_pct.mesh4": "mfu_pct.predict",
            "k3_roofline.mesh4": "k3_roofline",
            "k2_roofline.mesh4": "k2_roofline.predict",
            "dispatch_idle_pct.mesh4": "dispatch_idle_pct.predict",
            "call_gap_ms.mesh4": "call_gap_ms.predict",
            "host_busy_pct.mesh4": "host_busy_pct.predict",
            "host_rows_per_s.mesh4": "host_rows_per_s.predict"}


def event(name, start_us, end_us, device=None, annotation=False):
    return types.SimpleNamespace(
        name=name, key=name, time_range=types.SimpleNamespace(
            start=start_us, end=end_us),
        device_type="DeviceType.CUDA" if device is not None else
        "DeviceType.CPU", device_index=device if device is not None else -1,
        thread=1, is_user_annotation=annotation)


def kernel_trace(kernels, cards):
    """A profiled slice of 1 ms: each (name, us) kernel once on each card."""
    ev = [event(devtrace.SLICE, 0, 1000, annotation=True)]
    for d in range(cards):
        at = 0
        for name, us in kernels:
            ev.append(event(name, at, at + us, device=d))
            at += us
    return devtrace.Trace(ev, list(range(cards)))


@pytest.mark.parametrize("cards", [1, 4])
def test_rows_per_launch_is_the_engines(cards):
    """The engine takes whole batches of its configuration's batch a
    replica: its batch_size is that batch x the cards, and each card's
    launches carry that batch."""
    cfg = {"name": "c", "model": {}, "engine": {"devices": cards,
                                                "batch_size": 128}}
    d = engine_driver.Driver(cfg, {}, 0, cards)
    d.engine = types.SimpleNamespace(batch_size=128 * cards,
                                     devices=tuple(d.devices))
    assert d.rows_per_launch == 128
    d.engine = types.SimpleNamespace(batch_size=64 * cards,
                                     devices=tuple(d.devices))
    assert d.rows_per_launch == 64


F32_KERNEL = ("(anonymous namespace)::simt::conv1_raster_f32(int const*, "
              "unsigned char const*, float const*, float*, int)")


def f32_ctx(tr, lit_macs=0):
    cfg = spec.config(BENCH, "svision-alexnet-f32")
    driver = types.SimpleNamespace(rows_per_launch=128,
                                   slice_lit_macs=lambda: lit_macs)
    return types.SimpleNamespace(trace=tr, config=cfg, driver=driver,
                                 device_name=H100)


def test_k3_f32_roofline_without_its_kernel_is_none():
    read = spec.metric("k3_roofline.f32").read
    assert read(f32_ctx(None)) is None
    other = kernel_trace([("void pool_lrn_ring<float, 96, 8>(Args)", 50),
                          ("conv1_raster_f32_host_helper", 50)], 1)
    assert read(f32_ctx(other)) is None
    assert spec.metric("k3_roofline").read(
        f32_ctx(kernel_trace([(F32_KERNEL, 60)], 1))) is None


def test_k3_f32_roofline_share():
    """Two launches of 60 us: the f32 stage's bytes over the memory rate,
    its lit FLOPs far under the f32 peak."""
    cfg = spec.config(BENCH, "svision-alexnet-f32")
    nbytes, _ = work.k3_stage(cfg["model"], 128, "float32", 0)
    tr = kernel_trace([(F32_KERNEL, 60), (F32_KERNEL, 60),
                       ("void pool_lrn_ring<float, 96, 8>(Args)", 70)], 1)
    got = spec.metric("k3_roofline.f32").read(f32_ctx(tr, 10**8))
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 60e-6)
    assert 60 < got < 80
    # FLOPs past the bytes bound it against the f32 peak
    macs = 10**10
    got = spec.metric("k3_roofline.f32").read(f32_ctx(tr, macs))
    assert got == pytest.approx(100 * 2 * (2 * macs / 2) / 67e12 / 120e-6)


def mesh_ctx():
    """One context of the four-card cell that every reader finds something
    in: the window, the profiled slice and the span record."""
    us = 1000
    rec = trace.Record()
    call = [trace.Span("engine.call", 1, None, 1, 1, 0, 400 * us,
                       {"rows": 2048}),
            trace.Span("engine.host_rows", 2, 1, 1, 1, 10 * us, 30 * us,
                       {"rows": 2048}),
            trace.Span("engine.sync", 3, 1, 1, 1, 300 * us, 400 * us, {}),
            trace.Span("engine.call", 4, None, 4, 1, 500 * us, 900 * us,
                       {"rows": 512}),
            trace.Span("engine.host_rows", 5, 4, 4, 1, 510 * us, 520 * us,
                       {"rows": 512}),
            trace.Span("engine.sync", 6, 4, 4, 1, 800 * us, 900 * us, {})]
    dev = [trace.Span("engine.dispatch", 10 + 2 * d + k, 1 + 3 * k,
                      1 + 3 * k, None, a * us, b * us, {}, device=d)
           for d in range(4) for k, (a, b) in enumerate(
               ((40 + 10 * d, 300), (530, 780 + 10 * d)))]
    rec.spans, rec.start_ns, rec.end_ns = call + dev, 0, 1000 * us
    tr = kernel_trace([("(anonymous namespace)::tc::conv1_raster_wgmma("
                        "int const*)", 120),
                       ("void pool_lrn_ring<__nv_bfloat16, 96, 8>(Args)", 40),
                       ("void pool_lrn_ring<__nv_bfloat16, 256, 8>(Args)",
                        30)], 4)
    driver = types.SimpleNamespace(rows_per_launch=128,
                                   slice_lit_macs=lambda: 4 * 10**9)
    return types.SimpleNamespace(
        window={"images": 600_000, "seconds": 1.0}, trace=tr, spans=rec,
        driver=driver, device_name=H100, chips=4,
        config=spec.config(BENCH, "svision-alexnet-bf16-mesh4"))


def test_siblings_are_the_mesh_cells_alone():
    entries = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert set(SIBLINGS) <= set(entries)
    for name, orig in SIBLINGS.items():
        assert entries[name]["workloads"] == [MESH]
        assert MESH not in entries[orig]["workloads"]
        for k in ("unit", "better", "source"):
            assert entries[name][k] == entries[orig][k], (name, k)
        if name != "images_per_s.mesh4":
            assert entries[name]["moves"] == "images_per_s.mesh4"
            assert entries[name]["layer"] == entries[orig]["layer"]


@pytest.mark.parametrize("name", sorted(SIBLINGS))
def test_sibling_reads_as_its_original(name):
    ctx = mesh_ctx()
    want = spec.metric(SIBLINGS[name]).read(ctx)
    assert want is not None
    assert spec.metric(name).read(ctx) == want
    untraced = types.SimpleNamespace(**{**vars(ctx), "trace": None,
                                        "window": {}})
    assert spec.metric(name).read(untraced) is None


def test_traced_run_takes_its_spans_before_the_profiled_slice(monkeypatch):
    """The span slice runs first, with the recorder on, and the profiled
    slice after it, with the recorder off; without a span metric among
    the entries there is no span slice."""
    order = []

    def slice_():
        with trace.span("stub.slice") as sp:
            order.append("spans" if sp else "plain")

    def profile(fn, devices):
        order.append("profile")
        fn()
        return "trace"
    monkeypatch.setattr(devtrace, "profile", profile)
    driver = types.SimpleNamespace(devices=[torch.device("cpu")],
                                   slice=slice_)
    entries = spec.reported(BENCH, MESH, True)
    got = run.slices(driver, entries)
    assert order == ["spans", "profile", "plain"]
    assert got["trace"] == "trace"
    assert [s.name for s in got["spans"].spans] == ["stub.slice"]
    order.clear()
    got = run.slices(driver, [m for m in entries
                              if m["source"] != "program_span"])
    assert order == ["profile", "plain"] and "spans" not in got
