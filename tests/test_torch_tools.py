"""The port's benchmark, profiling and entry-point tools on the CPU, against
the JAX package's twins where they have one:

  * timing.random_specs equals bench.random_specs;
  * __graft_entry_torch__.entry(device="cpu") gives what the JAX entry()
    gives on the same specs and weights (the JAX package's
    init_params(PRNGKey(0)), carried across as numpy) at the bf16 bar of
    tests/test_torch_engine_modes.py: argmax agreement >= 0.9, max softmax
    within 0.02, its median difference within 0.004;
  * dryrun_multichip(2, device="cpu") passes;
  * the benchmark's MAC count (benchmark/work.py), which
    scripts/torch_roofline.py reads, equals the MACs of conv1-5 and fc6-8
    written out layer by layer, its peaks are benchmark/peaks.json's, and
    its full prefix is the engine's step;
  * chip_smoke.py's bound of each phase-2 kernel launch is
    benchmark/work.py's least time of the same stage, whose bytes are
    those of the tensors the launch reads and writes;
  * scripts/torch_e2e_bench.py's build_inputs writes the bytes
    scripts/e2e_bench.py's writes, and with --cli-extra=--exact and the
    JAX weights its report has the JAX script's reads, events, recall,
    precision and per-type counts (1 chromosome of 0.3 Mb);
  * every new entry point raises without a GPU unless asked for the CPU,
    and the scaling, mesh and profile scripts run on the CPU at tiny
    sizes."""
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import bench
from svision_tpu_torch.timing import random_specs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    """A script of scripts/ as a module, imported by name, so that the
    spawned workers of the scaling bench can import it too."""
    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.append(scripts)
    return importlib.import_module(name)


def load_root(name):
    """A module at the repository's root, by file name."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_entry():
    return load_root("__graft_entry__").entry()


@pytest.fixture(scope="module")
def jax_weights(jax_entry):
    """The JAX package's init_params(PRNGKey(0)), as its entry() made them,
    as numpy."""
    return {k: np.asarray(v) for k, v in jax_entry[1][0].items()}


@pytest.mark.parametrize("n,seed", [(1, 0), (129, 0), (1000, 3), (4096, 7)])
def test_random_specs_equal_bench(n, seed):
    np.testing.assert_array_equal(random_specs(n, seed),
                                  bench.random_specs(n, seed))


def test_entry_matches_jax_entry(jax_entry, jax_weights):
    fn, args = jax_entry
    want_p, want_s = (np.asarray(o) for o in jax.jit(fn)(*args))
    port = load_root("__graft_entry_torch__")
    pfn, pargs = port.entry("cpu", params=jax_weights)
    for a, b in zip(pargs[1:], args[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    p, s = (o.numpy() for o in pfn(*pargs))
    assert p.shape == want_p.shape == (16,) and s.dtype == np.float32
    assert (p == want_p).mean() >= 0.9
    d = np.abs(s - want_s)
    assert d.max() <= 0.02 and np.median(d) <= 0.004


def test_dryrun_multichip_two_cpu_replicas():
    load_root("__graft_entry_torch__").dryrun_multichip(2, device="cpu")


def test_dryrun_needs_its_gpus(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="need 4 GPUs"):
        load_root("__graft_entry_torch__").dryrun_multichip(4)


def test_roofline_flops_layer_by_layer():
    from benchmark import work
    roof = load_script("torch_roofline")
    want = {"conv1": 55 * 55 * 96 * 11 * 11 * 3,
            "conv2": 27 * 27 * 256 * 5 * 5 * 48,
            "conv3": 13 * 13 * 384 * 3 * 3 * 256,
            "conv4": 13 * 13 * 384 * 3 * 3 * 192,
            "conv5": 13 * 13 * 256 * 3 * 3 * 192,
            "fc6": 6 * 6 * 256 * 4096, "fc7": 4096 * 4096, "fc8": 4096 * 5}
    assert work.layer_macs(roof.bench_model()) == want
    assert roof.stage_flops(6) == work.inference_flops(roof.bench_model()) \
        == 2 * sum(want.values()) == 1440662592
    assert roof.stage_flops(0) == 0
    assert roof.stage_flops(2) == 2 * (want["conv1"] + want["conv2"])
    # every layer in one stage of the step, in the network's order
    assert roof.stage_layers(6) == list(want)


def test_roofline_peaks_rules():
    roof = load_script("torch_roofline")
    with open(os.path.join(ROOT, "benchmark", "peaks.json")) as f:
        h100 = json.load(f)["NVIDIA H100 80GB HBM3"]
    label = "NVIDIA H100 80GB HBM3, 700.00 W"
    assert roof.peaks(label) == (h100["bfloat16_flops"],
                                 h100["hbm_bytes_per_s"])
    assert roof.peaks(label, f32=True) == (h100["float32_flops"],
                                           h100["hbm_bytes_per_s"])
    assert roof.peaks(label, 7e14, 2e12) == (7e14, 2e12)
    assert roof.peaks("NVIDIA H100 PCIe, 350.00 W", 7e14, 2e12) == (7e14,
                                                                   2e12)
    with pytest.raises(SystemExit, match="--peak-flops"):
        roof.peaks("NVIDIA H100 PCIe, 350.00 W")
    assert roof.peaks("cpu") is None


def test_roofline_full_prefix_is_the_engine_step(capsys):
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.models.alexnet import init_params
    from svision_tpu_torch.ops import rasterize
    roof = load_script("torch_roofline")
    eng = InferenceEngine(init_params(0), batch_size=4, device="cpu")
    model, w = eng._replicas[0]
    ep, vis, rev = (torch.from_numpy(a) for a in rasterize.specs_to_endpoints(
        random_specs(4, 2)))
    with torch.inference_mode():
        got = roof.build_prefix(model, w, 6)(ep, vis, rev)
        want = eng._step(model, w, ep, vis, rev)
        shapes = [tuple(t.shape) if isinstance(t, torch.Tensor)
                  else [tuple(h.shape) for h in t]
                  for t in (roof.build_prefix(model, w, n)(ep, vis, rev)
                            for n in range(6))]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # conv1's block (K2's two NHWC halves), conv3 and conv4 hand on the two
    # halves of the bf16 network's split groups
    assert shapes == [(4, 57, 57, 48), [(4, 27, 27, 48)] * 2, (4, 256, 13, 13),
                      [(4, 192, 13, 13)] * 2, [(4, 192, 13, 13)] * 2,
                      (4, 256, 6, 6)]
    out = roof.main(["--device", "cpu", "--batch", "2", "--reps", "1"])
    assert [s["section"] for s in out["sections"]] == [
        s[0] for s in roof.STAGES]
    assert all(s["cum_ms"] > 0 for s in out["sections"])
    assert out["flops_per_image"] == 1440662592
    assert len(capsys.readouterr().out.strip().splitlines()) == 8


def test_roofline_exact_prefixes_are_the_exact_steps(capsys):
    """--exact: the k1_cudnn route's full prefix is the CPU exact engine's
    step and the k3 route's is fused_logits on the folded f32 weights, each
    prefix of the right shape; main times both routes' sections."""
    from svision_tpu_torch.infer.engine import (InferenceEngine, exact_f32,
                                                fused_logits)
    from svision_tpu_torch.models.alexnet import (AlexNet, fold_conv1_params,
                                                  init_params)
    from svision_tpu_torch.ops import rasterize
    roof = load_script("torch_roofline")
    eng = InferenceEngine(init_params(0), batch_size=4, bf16=False,
                          device="cpu")
    model, _ = eng._replicas[0]
    folded = AlexNet.from_params(fold_conv1_params(init_params(0)), s2d=True,
                                 device="cpu")
    w = folded.conv1_weight_hwio()
    seg = tuple(torch.from_numpy(a) for a in rasterize.specs_to_endpoints(
        random_specs(4, 2)))
    with torch.inference_mode(), exact_f32():
        got = roof.build_exact_prefix(model, 6)(*seg)
        want = eng._step(model, None, *seg)
        logits = fused_logits(folded, w, *seg)
        fused = roof.build_exact_prefix(folded, 6, w)(*seg)
        shapes = {n: tuple(roof.build_exact_prefix(model, n)(*seg).shape)
                  for n in (None, 0, 1, 5)}
        k3 = tuple(roof.build_exact_prefix(folded, 0, w)(*seg).shape)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(fused[0], logits.argmax(dim=1))
    assert torch.equal(fused[1], torch.softmax(logits, dim=1).amax(dim=1))
    assert shapes == {None: (4, 227, 227, 3), 0: (4, 55, 55, 96),
                      1: (4, 27, 27, 96), 5: (4, 256, 6, 6)}
    assert k3 == (4, 55, 55, 96)
    assert roof.exact_layers(None) == [] and roof.exact_layers(0) == ["conv1"]
    out = roof.main(["--device", "cpu", "--batch", "2", "--reps", "1",
                     "--exact"])
    assert [(s["route"], s["section"]) for s in out["sections"]] == [
        (r, lab) for r, stages in roof.EXACT_STAGES.items()
        for lab, _ in stages]
    assert all(s["cum_ms"] > 0 for s in out["sections"]) and out["exact"]
    assert len(capsys.readouterr().out.strip().splitlines()) == 16
    # the k3 route's conv1 counts the lit pixels' MACs; the k1_cudnn
    # route's the dense conv
    from benchmark import work
    two = tuple(torch.from_numpy(a) for a in rasterize.specs_to_endpoints(
        random_specs(2, 0)))
    model = roof.bench_model()
    first = {}
    for s in out["sections"]:
        if s["flops"]:
            first.setdefault(s["route"], s)
    assert first["k3"]["flops"] == 2 * work.conv1_lit_macs(
        rasterize.render_raster(*two), model) > 0
    assert first["k1_cudnn"]["flops"] == 2 * 2 * work.layer_macs(
        model)["conv1"]


# phase 2's kernel launches: (kernel, dtype, tail, segments an image)
PHASE2 = ([("render_raster", k, None, s) for s in (2, 4)
           for k in ("f32", "bf16")]
          + [(name, k, t, 2) for name in ("bias_relu_pool_lrn",
                                          "bias_relu_pool_lrn_backward")
             for t in ("conv1", "conv2") for k in ("bf16", "f32")]
          + [("conv1_fused_raster", k, None, 2) for k in ("bf16", "f32")])
H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("kernel,kind,tail,segs", PHASE2)
def test_chip_smoke_bound_is_the_benchmarks(monkeypatch, kernel, kind, tail,
                                            segs):
    """chip_smoke's bound of a phase-2 launch, here on 3 images, is
    benchmark/work.py's least time of the same stage on peaks.json's H100:
    its bytes those of the tensors the launch reads and writes (the plain
    version's, on the CPU), its FLOPs read against tensor cores for K3 in
    bf16 and CUDA cores otherwise, labelled by the larger term. K1 on
    fragments, which the benchmark does not count, takes its tensors'
    bytes."""
    from benchmark import work
    from svision_tpu_torch.ops import fused_conv1, fused_pool_lrn, rasterize
    smoke = load_root("chip_smoke")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: H100)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    n = 3
    seg = tuple(torch.from_numpy(a) for a in rasterize.specs_to_endpoints(
        random_specs(n, 1)))
    gen = torch.Generator().manual_seed(0)
    peak, flops, macs = "float32", 0, 0
    if kernel == "render_raster":
        if segs == 4:
            seg = smoke.fragments(*seg)
        out = rasterize.render_raster(*seg, dtype=dt)
        tensors, got = (*seg, out), smoke.k1_least(seg, out, kind)
    elif kernel == "conv1_fused_raster":
        w = torch.randn((3, 3, 48, 96), generator=gen).to(dt)
        out = fused_conv1.conv1_fused_raster_plain(*seg, w)
        macs = smoke.lit_macs(*seg)
        assert macs > 0
        tensors, flops = (*seg, w, out), 2 * macs
        peak = {"bf16": "bfloat16", "f32": "float32"}[kind]
        got = smoke.least(*smoke.stage(kernel, kind, n, lit_macs=macs))
    else:
        h, c = {"conv1": (55, 96), "conv2": (27, 256)}[tail]
        x = torch.randn((n, h, h, c), generator=gen).to(dt)
        b = torch.randn((c,), generator=gen).to(dt)
        if kernel == "bias_relu_pool_lrn":
            tensors = (x, b, fused_pool_lrn.bias_relu_pool_lrn_plain(x, b))
            flops = work.k2_stage(smoke.bench_model(), n, tail,
                                  smoke.PRECISION[kind])[1]
        else:
            ho = (h - 3) // 2 + 1
            dy = torch.randn((n, ho, ho, c), generator=gen).to(dt)
            tensors = (x, b, dy, *fused_pool_lrn
                       .bias_relu_pool_lrn_backward_plain(x, b, dy))
            flops = work.k2_backward_stage(smoke.bench_model(), n, tail,
                                           smoke.PRECISION[kind])[1]
        got = smoke.least(*smoke.stage(kernel, kind, n, tail))
    nbytes = sum(t.nbytes for t in tensors)
    if segs == 2:
        assert smoke.stage(kernel, kind, n, tail, macs) == (
            (nbytes, flops), peak)
    p = work.peaks(H100)
    by = ("bytes" if nbytes / p["hbm_bytes_per_s"]
          >= flops / p[f"{peak}_flops"] else "operations")
    assert got == (pytest.approx(work.least_s(nbytes, flops, H100, peak)
                                 * 1e3, rel=1e-12), by)


@pytest.fixture(scope="module")
def e2e_dirs(tmp_path_factory):
    """The tiny fixture built by each script's build_inputs."""
    root = tmp_path_factory.mktemp("torch_e2e_bench")
    dirs = {}
    for name in ("e2e_bench", "torch_e2e_bench"):
        dirs[name] = str(root / name)
        os.makedirs(dirs[name])
        load_script(name).build_inputs(dirs[name], 1, 0.3, 20, 7)
    return dirs


def test_e2e_build_inputs_equal_jax(e2e_dirs):
    for f in ("ref.fa", "sample.bam", "events.json", "fixture_params.json"):
        with open(os.path.join(e2e_dirs["e2e_bench"], f), "rb") as a, \
                open(os.path.join(e2e_dirs["torch_e2e_bench"], f), "rb") as b:
            assert a.read() == b.read(), f


def _jax_report(capsys, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["e2e_bench.py"] + argv)
    load_script("e2e_bench").main()
    out = capsys.readouterr().out
    return json.loads(out[out.index("\n{") + 1:])


def test_e2e_report_matches_jax(e2e_dirs, jax_weights, tmp_path, capsys,
                                monkeypatch):
    from svision_tpu_torch.models.checkpoint import save_params
    weights = str(tmp_path / "w.npz")
    save_params(jax_weights, weights)
    flags = ["--chroms", "1", "--mb", "0.3", "--events-per-chrom", "7",
             "--threads", "1", "--model", weights, "--cli-extra=--exact"]
    got = load_script("torch_e2e_bench").main(
        flags + ["--keep", e2e_dirs["torch_e2e_bench"], "--device", "cpu"])
    capsys.readouterr()
    want = _jax_report(capsys, monkeypatch,
                       flags + ["--keep", e2e_dirs["e2e_bench"]])
    for k in ("n_reads", "planted_events", "locus_recall",
              "locus_precision", "per_type"):
        assert got[k] == want[k], k
    assert got["device"] == "cpu" and got["threads"] == 1
    assert got["host_cpus"] == os.cpu_count()
    assert set(got["stage_s"]) >= {"collect", "predict"}


def test_e2e_collect_only_matches_jax(e2e_dirs, capsys, monkeypatch):
    flags = ["--chroms", "1", "--mb", "0.3", "--events-per-chrom", "7",
             "--collect-only"]
    got = load_script("torch_e2e_bench").main(
        flags + ["--keep", e2e_dirs["torch_e2e_bench"], "--threads", "2"])
    capsys.readouterr()
    want = _jax_report(capsys, monkeypatch, flags + [
        "--keep", e2e_dirs["e2e_bench"], "--threads", "1"])
    for k in ("n_reads", "windows", "failed", "signatures", "clusters",
              "candidates"):
        assert got[k] == want[k], k


def test_e2e_trace_busy(tmp_path):
    """--profile's reading of the CLI's trace: the union of the device's
    kernel and copy intervals; host events do not count."""
    e2e = load_script("torch_e2e_bench")
    path = str(tmp_path / "trace.json")
    events = [
        dict(ph="X", cat="kernel", name="k", ts=100, dur=10),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=105, dur=10),
        dict(ph="X", cat="kernel", name="k", ts=120, dur=5),
        dict(ph="X", cat="gpu_memset", name="Memset", ts=121, dur=1),
        dict(ph="X", cat="cpu_op", name="aten::conv2d", ts=0, dur=500),
        dict(ph="i", cat="kernel", name="k", ts=300)]
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh)
    got = e2e.trace_busy(path)
    assert got["device_busy_ms"] == pytest.approx(0.020)
    assert got["device_span_ms"] == pytest.approx(0.025)
    assert got["device_ops"] == 4
    assert got["top_ms"] == pytest.approx(
        {"k": 0.015, "Memcpy HtoD": 0.010, "Memset": 0.001})
    with open(path, "w") as fh:
        json.dump({"traceEvents": events[4:]}, fh)
    with pytest.raises(ValueError, match="no device activity"):
        e2e.trace_busy(path)


@pytest.mark.parametrize("hosts,rounds,want", [
    (2, 1, [1, 2]), (2, 2, [1, 2, 2, 1]), (3, 3, [1, 3, 3, 1, 1, 3])])
def test_scaling_bench_alternates_its_configs(hosts, rounds, want):
    assert load_script("torch_scaling_bench").run_order(hosts,
                                                        rounds) == want


def test_scaling_bench_on_cpu():
    # one round: the rounds' order is the test above
    r = load_script("torch_scaling_bench").main(
        ["--device", "cpu", "--hosts", "2", "--chroms", "2", "--mb", "0.2",
         "--rounds", "1"])
    assert r["n_shard_vcf_identical"] and r["calls"] > 0
    shards = r["shards_2host"]
    assert sorted(s["shard"] for s in shards) == [0, 1]
    assert all(s["setup_s"] > 0 and s["work_s"] > 0 for s in shards)
    assert sorted(c for s in shards for c in s["chroms"]) == ["chr1", "chr2"]
    assert r["scaling_efficiency"] == r["work_s_1host"] / (
        2 * r["work_s_2host"])
    assert r["work_s_by_round_2host"] == [r["work_s_2host"]]


def test_mesh_scaling_on_cpu_replicas(capsys):
    lines = load_script("torch_mesh_scaling").main(
        ["--device", "cpu", "--max-devices", "2", "--batch", "4", "--n", "16",
         "--reps", "1", "--exact"])
    assert [ln["devices"] for ln in lines] == [1, 2]
    assert lines[0]["efficiency"] == 1.0 and lines[1]["platform"] == "cpu"
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == lines


def test_profile_engine_on_cpu():
    r = load_script("torch_profile_engine").main(
        ["--device", "cpu", "--batch", "2", "--batches", "2"])
    assert set(r["alone_ms_per_batch"]) == {
        "raster_k1_f32", "cnn_unfolded_bf16", "k3_raster_conv1",
        "network_after_conv1"}
    assert r["pipelined_images_per_s"] > 0
    assert r["profile"] == "not measured on the CPU"


NO_GPU_CALLS = {
    "torch_e2e_bench": lambda: load_script("torch_e2e_bench").main([]),
    "torch_roofline": lambda: load_script("torch_roofline").main([]),
    "torch_profile_engine": lambda: load_script(
        "torch_profile_engine").main([]),
    "torch_mesh_scaling": lambda: load_script("torch_mesh_scaling").main([]),
    "torch_scaling_bench": lambda: load_script(
        "torch_scaling_bench").main([]),
    "entry": lambda: load_root("__graft_entry_torch__").entry(),
    "dryrun_multichip": lambda: load_root(
        "__graft_entry_torch__").dryrun_multichip(1),
}


@pytest.mark.parametrize("name", list(NO_GPU_CALLS))
def test_entry_points_raise_without_gpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        NO_GPU_CALLS[name]()
