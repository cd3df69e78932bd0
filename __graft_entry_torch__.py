"""Entry points of the PyTorch/CUDA port: the fused forward step on
one device, and a dry run of every multi-device path.

The H100 counterpart of __graft_entry__.py, with svision_tpu_torch's
modules. Both run on the card unless asked for the CPU (device="cpu"),
where a "device" of a mesh is a CPU replica, as the JAX version's are
virtual CPU devices.

    python __graft_entry_torch__.py [--device cuda|cpu] [--devices N]
"""

import numpy as np


def example_specs(batch: int = 16) -> np.ndarray:
    """__graft_entry__.py's batch of candidate specs [batch,12]."""
    rng = np.random.RandomState(0)
    specs = np.zeros((batch, 12), dtype=np.int64)
    specs[:, 2] = rng.randint(0, 500, batch)          # ys1
    specs[:, 3] = specs[:, 2] + rng.randint(50, 900, batch)
    specs[:, 4] = 1
    specs[:, 5] = rng.randint(0, 800, batch)          # xs2
    specs[:, 7] = rng.randint(0, 900, batch)
    specs[:, 8] = specs[:, 7] + rng.randint(50, 700, batch)
    specs[:, 9] = rng.randint(0, 2, batch)
    specs[:, 10] = 1800
    specs[:, 11] = 1800
    return specs


def entry(device="cuda", params=None):
    """(fn, example_args): the fused forward step on the flagship model --
    segment-pair endpoints -> f32 similarity images (K1, render_images) ->
    AlexNet with bf16 weights (K2 after conv1 and conv2) -> (pred, max
    softmax), the engine's fast=False step. fn(model, endpoints, visible,
    reverse) runs under torch.inference_mode(). Weights: the port's
    init_params(0), or `params`, JAX-style numpy params (TF names, HWIO),
    carried across by params_from_numpy."""
    import torch
    from svision_tpu_torch.device import resolve_device
    from svision_tpu_torch.models.alexnet import (AlexNet, cast_params_bf16,
                                                  init_params)
    from svision_tpu_torch.ops import rasterize
    from svision_tpu_torch.ops.raster_kernel import render_images

    dev = resolve_device(device)
    host = init_params(0) if params is None else {
        k: np.asarray(v) for k, v in params.items()}
    model = AlexNet.from_params(cast_params_bf16(host), device=dev)

    @torch.inference_mode()
    def fused_step(model, endpoints, visible, reverse):
        images = render_images(endpoints, visible, reverse,
                               dtype=torch.float32)
        logits = model(images)
        pred = logits.argmax(dim=1)
        soft = torch.softmax(logits, dim=1)
        return pred, soft.amax(dim=1)      # == soft[argmax], no gather

    ep, vis, rev = rasterize.specs_to_endpoints(example_specs())
    example_args = (model,) + tuple(torch.from_numpy(a).to(dev)
                                    for a in (ep, vis, rev))
    return fused_step, example_args


def _device_kind(n_devices: int, device: str) -> str:
    """'cuda' or 'cpu', the kind of device the mesh is made of; raises
    unless n_devices GPUs are visible for 'cuda' (a CPU mesh is replicas,
    always there)."""
    import torch
    from svision_tpu_torch.device import resolve_device
    kind = resolve_device(device).type
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} GPUs, have "
                           f"{torch.cuda.device_count()}; run on a machine "
                           "with that many, or pass device='cpu'")
    return kind


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Validate every multi-device path on n devices at tiny shapes:
      1. the full training step, data parallel x tensor parallel on
         fc6/fc7 (make_mesh_train_step on make_train_mesh(data, model),
         model axis 2 when n is even), with a finite loss;
      2. data-parallel inference (ShardedInference: batch rows split over
         the devices) equal to the one-device engine, on the exact f32
         path and the bf16 s2d production path;
      3. a miniature genome-sharded pipeline over 4 contigs, plain and
         --graph: N shards of run_shard + the merge give the VCF of the
         one-process CLI byte for byte;
      4. a 2-sample cohort: the sharded run + merge equals the
         single-shard cohort run byte for byte.
    Raises when fewer than n GPUs are visible (device="cuda")."""
    import os
    import tempfile

    import torch
    from svision_tpu_torch.models.alexnet import init_params
    from svision_tpu_torch.models.checkpoint import save_params
    from svision_tpu_torch.models.train import make_mesh_train_step
    from svision_tpu_torch.parallel.mesh import (make_train_mesh,
                                                 replicate_params,
                                                 shard_params_tp)

    device = _device_kind(n_devices, device)
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    grid = make_train_mesh(n_devices // model_axis, model_axis, device)
    params = init_params(0)
    cells = (shard_params_tp(params, grid) if model_axis > 1
             else replicate_params(params, grid))
    _, train_step = make_mesh_train_step(cells)
    dev0 = grid[0][0]
    batch = 2 * len(grid)              # tiny, divisible by the data axis
    images = torch.zeros((batch, 227, 227, 3), dtype=torch.float32,
                         device=dev0)
    labels = torch.zeros((batch,), dtype=torch.int64, device=dev0)
    gens = {d: torch.Generator(device=d).manual_seed(1)
            for row in grid for d in row}
    loss = float(train_step(images, labels, gens))
    assert np.isfinite(loss), loss

    _dryrun_sharded_inference(n_devices, device, params)
    with tempfile.TemporaryDirectory(prefix="svtorch_dryrun_w_") as root:
        weights = os.path.join(root, "w.npz")
        save_params(params, weights)
        _dryrun_genome_sharded_pipeline(n_devices, device, weights)
        _dryrun_cohort(n_devices, device, weights)


def _dryrun_sharded_inference(n_devices: int, device: str,
                              params) -> None:
    """ShardedInference == the one-device engine, on both numeric paths:
    exact (f32) and the bf16 s2d production path."""
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.parallel.mesh import ShardedInference, make_mesh

    rng = np.random.RandomState(3)
    n = 3 * n_devices + 1          # deliberately ragged
    specs = np.zeros((n, 12), dtype=np.int64)
    specs[:, 2] = rng.randint(0, 400, n)
    specs[:, 3] = specs[:, 2] + rng.randint(30, 500, n)
    specs[:, 4] = 1
    specs[:, 7] = rng.randint(0, 600, n)
    specs[:, 8] = specs[:, 7] + rng.randint(30, 400, n)
    specs[:, 9] = rng.randint(0, 2, n)
    specs[:, 10] = 1500
    specs[:, 11] = 1500

    mesh = make_mesh(n_devices, device)
    for bf16, label in ((False, "exact"), (True, "bf16/s2d")):
        single = InferenceEngine(params, batch_size=n_devices, bf16=bf16,
                                 device=mesh[0])
        p1, s1 = single.predict_specs(specs)
        sharded = ShardedInference(params, mesh, batch_size=n_devices,
                                   bf16=bf16)
        assert not bf16 or (sharded.fast and sharded.raster == "s2d"), \
            "bf16 engine did not select the s2d production path"
        p2, s2 = sharded.predict_specs(specs)
        assert (p1 == p2).all(), \
            f"sharded argmax != single-device argmax ({label})"
        assert np.allclose(s1, s2, atol=1e-5), \
            f"sharded softmax drifted ({label})"


def _dryrun_genome_sharded_pipeline(n_shards: int, device: str,
                                    weights: str) -> None:
    """run_shard x N + merge == the one-process run_pipeline, byte-equal,
    each run's engine data-parallel over the N devices (--mesh N), in
    plain and --graph (the graph step runs on the merged VCF through
    cli.finalize_vcf). A 4-contig genome, so every shard up to 4 gets
    work; the shards run one after another in this process: what is held
    is the assignment and the merge, not concurrency."""
    import os
    import tempfile

    from svision_tpu_torch import sim
    from svision_tpu_torch.cli import parse_arguments, run_pipeline
    from svision_tpu_torch.parallel import dist

    contigs = {"chr1": 60000, "chr2": 50000, "chr3": 55000, "chr4": 45000}
    mesh = str(n_shards)               # every run's engine on all n devices
    n_shards = min(n_shards, len(contigs))
    with tempfile.TemporaryDirectory(prefix="svtorch_dryrun_") as root:
        genome = os.path.join(root, "ref.fa")
        seqs = sim.make_genome(genome, contigs, seed=13)
        bam = os.path.join(root, "s.bam")
        sim.make_sv_bam(bam, seqs, seed=13, support=6,
                        events=[("DEL", "chr1", 20000, 200),
                                ("INS", "chr2", 25000, 180),
                                ("INV", "chr3", 22000, 240),
                                ("tDUP", "chr4", 18000, 200)])
        for extra, label in (([], "plain"), (["--graph", "--qname"],
                                             "graph")):
            base = ["-b", bam, "-g", genome, "-m", weights, "-n", "dry",
                    "-s", "3", "--batch_size", "16", "--device", device,
                    "--mesh", mesh] + extra
            single_vcf = run_pipeline(parse_arguments(
                ["-o", os.path.join(root, f"one_{label}")] + base))

            shard_out = os.path.join(root, f"many_{label}")
            for k in range(n_shards):
                opts = parse_arguments(
                    ["-o", shard_out, "--num_shards", str(n_shards),
                     "--shard_id", str(k)] + base)
                dist.run_shard(opts, k, n_shards)
            merged_vcf = run_pipeline(parse_arguments(
                ["-o", shard_out, "--merge_shards"] + base))
            if label == "graph":
                assert merged_vcf.endswith(".graph.vcf"), merged_vcf

            with open(single_vcf) as a, open(merged_vcf) as b:
                assert a.read() == b.read(), \
                    f"{n_shards}-shard merged VCF != single-process " \
                    f"VCF ({label})"


def _dryrun_cohort(n_shards: int, device: str, weights: str) -> None:
    """A 2-sample cohort: the 2-shard (sample x chrom round-robin) run +
    merge == the 1-shard run, byte-equal multi-sample VCF; every engine
    on all N devices."""
    import os
    import tempfile

    from svision_tpu_torch import sim
    from svision_tpu_torch.cli import RunOptions
    from svision_tpu_torch.parallel import cohort as cohort_mod

    with tempfile.TemporaryDirectory(prefix="svtorch_dryrun_cohort_") as root:
        genome = os.path.join(root, "ref.fa")
        seqs = sim.make_genome(genome, {"chr1": 80000}, seed=21)
        bam_a = os.path.join(root, "a.bam")
        sim.make_sv_bam(bam_a, seqs, seed=1, support=6,
                        events=[("DEL", "chr1", 20000, 250)])
        bam_b = os.path.join(root, "b.bam")
        sim.make_sv_bam(bam_b, seqs, seed=2, support=6,
                        events=[("DEL", "chr1", 20000, 250),
                                ("INS", "chr1", 50000, 180)])
        samples = {"A": bam_a, "B": bam_b}

        def opts(sub):
            d = os.path.join(root, sub)
            os.makedirs(d, exist_ok=True)
            return RunOptions(out_path=d, genome=genome, model_path=weights,
                              min_support=3, batch_size=16, device=device,
                              mesh=str(n_shards)).normalized()

        single = cohort_mod.run_cohort(samples, opts("one"))
        o2 = opts("two")
        n = min(n_shards, 2)
        for k in range(n - 1, -1, -1):      # shard 0 last: it merges
            out = cohort_mod.run_cohort(samples, o2, num_shards=n,
                                        shard_id=k)
        with open(single) as a, open(out) as b:
            assert a.read() == b.read(), \
                "sharded cohort VCF != single-shard cohort VCF"


if __name__ == "__main__":
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size of the dry run (default: every visible "
                    "GPU; 2 CPU replicas with --device cpu)")
    a = ap.parse_args()
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
    n = a.devices or (2 if a.device == "cpu" else torch.cuda.device_count())
    dryrun_multichip(n, a.device)
    print(f"dryrun_multichip({n}) ok")
