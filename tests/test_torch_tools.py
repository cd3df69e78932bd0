"""The port's benchmark, profiling and entry-point tools on the CPU, against
the JAX package's twins where they have one:

  * bench_torch.random_specs equals bench.random_specs, and bench_torch
    prints bench.py's keys;
  * __graft_entry_torch__.entry(device="cpu") gives what the JAX entry()
    gives on the same specs and weights (the JAX package's
    init_params(PRNGKey(0)), carried across as numpy) at the bf16 bar of
    tests/test_torch_engine_modes.py: argmax agreement >= 0.9, max softmax
    within 0.02, its median difference within 0.004;
  * dryrun_multichip(2, device="cpu") passes;
  * scripts/torch_roofline.py's closed-form FLOP count equals 2 x the MACs
    of conv1-5 and fc6-8 written out layer by layer, and its full prefix is
    the engine's step;
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
import bench_torch

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
    np.testing.assert_array_equal(bench_torch.random_specs(n, seed),
                                  bench.random_specs(n, seed))


def test_bench_line_has_bench_keys(capsys):
    line = bench_torch.main(["--device", "cpu", "--batch", "8",
                             "--batches", "2"])
    assert json.loads(capsys.readouterr().out.strip()) == line
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["metric"].startswith("similarity_images_per_s_cpu")
    assert line["device"] == "cpu" and line["value"] > 0
    assert line["vs_baseline"] == line["value"] / bench_torch.baseline()


def test_bench_refuses_a_missing_baseline(monkeypatch, tmp_path):
    monkeypatch.setattr(bench_torch, "BASELINE_CACHE",
                        str(tmp_path / "none.json"))
    with pytest.raises(FileNotFoundError):
        bench_torch.main(["--device", "cpu", "--batches", "1"])


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
    roof = load_script("torch_roofline")
    want = {"conv1": 55 * 55 * 96 * 11 * 11 * 3,
            "conv2": 27 * 27 * 256 * 5 * 5 * 48,
            "conv3": 13 * 13 * 384 * 3 * 3 * 256,
            "conv4": 13 * 13 * 384 * 3 * 3 * 192,
            "conv5": 13 * 13 * 256 * 3 * 3 * 192,
            "fc6": 6 * 6 * 256 * 4096, "fc7": 4096 * 4096, "fc8": 4096 * 5}
    assert roof.layer_macs() == want
    assert roof.stage_flops(6) == 2 * sum(want.values()) == 1440662592
    assert roof.stage_flops(0) == 0
    assert roof.stage_flops(2) == 2 * (want["conv1"] + want["conv2"])
    # every layer in one stage of the step, in the network's order
    assert roof.stage_layers(6) == list(want)


def test_roofline_peaks_rules():
    roof = load_script("torch_roofline")
    assert roof.peaks("NVIDIA H100 80GB HBM3, 700.00 W") == (989.4e12,
                                                            3.35e12)
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
        bench_torch.random_specs(4, 2)))
    with torch.inference_mode():
        got = roof.build_prefix(model, w, 6)(ep, vis, rev)
        want = eng._step(model, w, ep, vis, rev)
        shapes = [tuple(roof.build_prefix(model, w, n)(ep, vis, rev).shape)
                  for n in range(6)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert shapes == [(4, 57, 57, 48), (4, 27, 27, 96), (4, 256, 13, 13),
                      (4, 384, 13, 13), (4, 384, 13, 13), (4, 256, 6, 6)]
    out = roof.main(["--device", "cpu", "--batch", "2", "--reps", "1"])
    assert [s["section"] for s in out["sections"]] == [
        s[0] for s in roof.STAGES]
    assert all(s["cum_ms"] > 0 for s in out["sections"])
    assert out["flops_per_image"] == 1440662592
    assert len(capsys.readouterr().out.strip().splitlines()) == 8


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
    "bench_torch": lambda: bench_torch.main(["--batches", "1"]),
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
