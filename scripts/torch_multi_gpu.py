"""The port's multi-GPU paths on a machine with two or more CUDA GPUs.

    python3 scripts/torch_multi_gpu.py [--out FILE]

chip_smoke.py runs these only where it sees more than one GPU; this
script runs just them:
- the data-parallel engine (InferenceEngine(devices=...), one replica and
  one set of CUDA graphs per device) over 2 and over all visible GPUs, in
  both numeric modes and the int8 engine (raster='pallas'): its graph
  replays bit for bit against its eager step at 1, 128, 129 and 8,192
  specs, and, since each replica takes whole batches of the one-GPU
  engine's rows, bit for bit against the one-GPU engine, with its
  launches held to launches per batch x batches x devices
  (chip_smoke.counted);
- the CLI with --mesh 2 on chip_smoke phase 6's two-chromosome sample,
  its VCF byte-equal to the one-GPU run's;
- chip_smoke.check_dp_tp: the DP x TP training step (model axis 2) in f64
  against the one-device step;
- chip_smoke.check_mesh_graph_steps: the DP x TP step's CUDA graphs
  against eager twins, on four cells of one GPU and, with four GPUs, on a
  2 x 2 grid of them;
- the trainer's rates (train_rates): images/s of the DP x TP step, eager
  and graphed, on a 2 x 2 grid (1 x 2 on two GPUs), beside fit's graphed
  step on one card, at global batch 64 and 256, and fit itself on the grid
  and on one card.
Every check fails the run; the last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def check_engines(smoke, params) -> dict:
    import torch
    from svision_tpu_torch.infer.engine import InferenceEngine
    n_gpus = torch.cuda.device_count()
    out = {}
    for mode, kw in (("bf16", {}), ("exact", dict(bf16=False)),
                     ("int8_pallas", dict(int8=True, raster="pallas"))):
        bf16 = kw.get("bf16", True)
        one = InferenceEngine(params, **kw)
        for nd in sorted({2, n_gpus}):
            devs = tuple(torch.device("cuda", i) for i in range(nd))
            eng = InferenceEngine(params, devices=devs, **kw)
            eng.warmup()
            got = {}
            with smoke.counted() as run:
                for n in (1, 128, 129, 8192):
                    specs = smoke.random_specs(n, seed=n)
                    gp, gs = eng.predict_specs(specs)
                    with torch.inference_mode():
                        ep, es = eng._predict(specs, graphed=False)
                    assert np.array_equal(gp, ep) and np.array_equal(gs, es), \
                        f"{mode} x{nd}: graphs differ from eager at n={n}"
                    got[n] = (specs, gp, gs)
            smoke.hold_launches(f"engine {mode} x{nd}",
                                mode if eng.int8 else
                                "default" if bf16 else "exact", run,
                                warmups=0, devices=nd)
            # the one-GPU engine runs outside the count: its own warm-up
            # and launches are not the data-parallel engine's
            for n, (specs, gp, gs) in got.items():
                # each device runs whole batches of the one-GPU engine's
                # rows, at its batch shape: the same answers, bit for bit
                op, os_ = one.predict_specs(specs)
                assert np.array_equal(gp, op) and np.array_equal(gs, os_), \
                    f"{mode} x{nd}: argmax agreement {(gp == op).mean()}"
            out[f"{mode}_x{nd}"] = dict(launches=run["launches"],
                                        batches=run["batches"],
                                        images_per_s=smoke.best_rate(
                                            eng, smoke.random_specs(8192, 3)))
            smoke.log(f"engine {mode} over {nd} GPUs: graphs equal eager and "
                      f"the one-GPU engine; {out[f'{mode}_x{nd}']}")
            del eng
        del one
        torch.cuda.empty_cache()
    return out


def check_mesh_cli(smoke, params) -> dict:
    from svision_tpu_torch import cli
    with tempfile.TemporaryDirectory() as work:
        fx = smoke.make_fixtures(params, work)
        base = ["-b", fx["bam2"], "-g", fx["genome2"], "-m", fx["weights"],
                "-n", "SB", "-s", "3"]
        solo = cli.run_pipeline(cli.parse_arguments(
            ["-o", os.path.join(work, "solo"), *base, "--mesh", "none"]))
        with smoke.counted() as run:
            vcf = cli.run_pipeline(cli.parse_arguments(
                ["-o", os.path.join(work, "mesh2"), *base, "--mesh", "2"]))
        smoke.hold_launches("--mesh 2", "default", run,
                            warmups=smoke.warmup_batches(), devices=2)
        smoke.same_bytes(vcf, solo, "--mesh 2")
        smoke.log(f"--mesh 2: VCF equal to one GPU's, launches "
                  f"{run['launches']}")
        return dict(launches=run["launches"], batches=run["batches"],
                    records=len(smoke._records(vcf)))


RATE_STEPS = 20      # timed steps of each turn of a step rate
BATCHES = (64, 256)  # the global batches of the training rates


def sync_all() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def step_rate(step, batch: int, steps: int = RATE_STEPS) -> float:
    """Images/s of step() over `steps` calls by host clock, every GPU
    synchronized at both ends."""
    sync_all()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    sync_all()
    return steps * batch / (time.perf_counter() - t0)


def busy_by_device(step) -> dict:
    """One call of step() traced as the benchmark traces its slice
    (benchmark/devtrace.py), every GPU synchronized at both ends: the
    window's ms, and each GPU's busy ms (the union of its kernels, copies
    and sets)."""
    import torch
    from benchmark import devtrace
    trace = devtrace.profile(step, [torch.device("cuda", i) for i in
                                    range(torch.cuda.device_count())])
    return {"wall_ms": trace.window_s * 1e3,
            "busy_ms_by_gpu": {d: s * 1e3 for d, s in trace.busy.items()}}


def train_rates(smoke, params) -> dict:
    """Training images/s at global batch 64 and 256, f32 with fit's
    settings (clip 1, lr 1e-3, keep_prob 0.5), on one pre-rendered batch:
    the DP x TP step on a 2 x 2 grid (1 x 2 with two GPUs), eager
    (eager=True) and graphed, and fit's step on one card
    (make_train_step, graphed). Each is first run past its capture
    (graphs.WARMUP_STEPS + 2 steps), then timed over RATE_STEPS steps in
    turns: one card, eager, graphed, graphed, eager, one card; each rate is
    the better of its two turns. The host's CUDA calls in one step of each
    (chip_smoke.host_calls) and each GPU's busy time in one profiled step
    (busy_by_device). Then fit itself on the grid and on one card,
    two epochs of chip_smoke.RATE_STEPS steps each, the rate the second
    epoch's (K1 renders each batch; chip_smoke.train_rates' method)."""
    import torch
    from svision_tpu_torch import graphs
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import AlexNet
    from svision_tpu_torch.parallel import mesh as M
    n = torch.cuda.device_count()
    grid = M.make_train_mesh(2 if n >= 4 else 1, 2, device="cuda")
    dev0 = grid[0][0]
    kw = dict(learning_rate=1e-3, clip_norm=1.0, keep_prob=0.5)
    out = {"grid": [len(grid), 2], "steps": {}, "fit": {}}
    for batch in BATCHES:
        specs, labels = smoke.labeled(batch, seed=15)
        images = train.specs_to_images(specs, device=dev0)
        y = torch.from_numpy(labels).long().to(dev0)
        gens = {d: torch.Generator(device=d).manual_seed(0)
                for row in grid for d in row}
        _, one = train.make_train_step(AlexNet.trainable(params, device=dev0),
                                       **kw)
        gen0 = torch.Generator(device=dev0).manual_seed(0)
        steps = {"one_card_graphed": lambda: one(images, y, gen0)}
        for how, eager in (("mesh_eager", True), ("mesh_graphed", False)):
            _, mstep = train.make_mesh_train_step(
                M.shard_params_tp(params, grid), eager=eager, **kw)
            steps[how] = lambda mstep=mstep: mstep(images, y, gens)
        for fn in steps.values():
            for _ in range(graphs.WARMUP_STEPS + 2):
                fn()
        rates = {k: [] for k in steps}
        for k in ("one_card_graphed", "mesh_eager", "mesh_graphed",
                  "mesh_graphed", "mesh_eager", "one_card_graphed"):
            rates[k].append(step_rate(steps[k], batch))
        r = {k: dict(images_per_s=max(v), turns=v,
                     host_calls=smoke.host_calls(steps[k], sync_all)["total"],
                     profile=busy_by_device(steps[k]))
             for k, v in rates.items()}
        out["steps"][batch] = r
        smoke.log(f"train step rates at batch {batch} on a {len(grid)}x2 "
                  f"grid ({smoke.REPORT['device']['nvidia_smi']}): " +
                  ", ".join(f"{k} {v['images_per_s']:.1f} images/s "
                            f"({v['host_calls']} host CUDA calls a step; "
                            f"profiled {v['profile']})"
                            for k, v in r.items()))
        del steps, one, mstep
        torch.cuda.empty_cache()
        specs, labels = smoke.labeled(batch * smoke.RATE_STEPS, seed=16)
        for how, mesh in (("fit_one_card", None), ("fit_mesh", grid)):
            stamps = []
            _, hist = train.fit(params, specs, labels, epochs=2,
                                batch_size=batch, mesh=mesh,
                                log=lambda m: stamps.append(
                                    time.perf_counter()))
            assert np.isfinite(hist).all(), f"{how}: {hist}"
            out["fit"].setdefault(batch, {})[how] = rate = (
                smoke.RATE_STEPS * batch / (stamps[1] - stamps[0]))
            smoke.log(f"{how} at batch {batch}: {rate:.1f} images/s")
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if torch.cuda.device_count() < 2:
        print("torch_multi_gpu: needs two or more CUDA GPUs", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from svision_tpu_torch.models.alexnet import init_params
    smoke.REPORT["device"] = {"nvidia_smi": smoke.nvidia_smi()}
    params = init_params(0)
    out = dict(device=smoke.REPORT["device"]["nvidia_smi"],
               gpus=torch.cuda.device_count(), failed={})
    # the trainer first: its graphs are the newest of these paths. A check
    # that fails is recorded and the others still run; any failure fails
    # the run.
    for name, check in (
            ("dp_tp", smoke.check_dp_tp),
            ("mesh_graph_steps", smoke.check_mesh_graph_steps),
            ("train_rates", lambda p: train_rates(smoke, p)),
            ("engines", lambda p: check_engines(smoke, p)),
            ("mesh_cli", lambda p: check_mesh_cli(smoke, p))):
        try:
            out[name] = check(params)
        except Exception:  # noqa: BLE001 - reported, and fails the run
            out["failed"][name] = traceback.format_exc()
            smoke.log(f"{name} FAILED:\n{out['failed'][name]}")
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(out["device"])
    print(json.dumps({"ok": not out["failed"], "gpus": out["gpus"],
                      "failed": sorted(out["failed"])}))
    return 1 if out["failed"] else 0

if __name__ == "__main__":
    sys.exit(main())
