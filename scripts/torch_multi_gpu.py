"""The port's multi-GPU paths on a machine with two or more CUDA GPUs.

    python3 scripts/torch_multi_gpu.py [--out FILE]

chip_smoke.py runs these only where it sees more than one GPU; this
script runs just them:
- the data-parallel engine (InferenceEngine(devices=...), one replica and
  one set of CUDA graphs per device) over 2 and over all visible GPUs, in
  both numeric modes: its graph replays bit for bit against its eager step
  at 1, 128, 129 and 8,192 specs, and against the one-GPU engine by
  chip_smoke phase 3's bars (bf16 argmax agreement at least 0.99; exact
  argmax equal and softmax within 1e-4), with its launches held to
  launches per batch x batches x devices (chip_smoke.counted); and the
  int8 engine (raster='pallas'), whose replicas take whole batches, bit
  for bit against the one-GPU int8 engine;
- the CLI with --mesh 2 on chip_smoke phase 6's two-chromosome sample,
  its VCF byte-equal to the one-GPU run's;
- chip_smoke.check_dp_tp: the DP x TP training step (model axis 2) in f64
  against the one-device step.
Every check fails the run; the last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

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
                # each device runs its share of a batch, which cuDNN may
                # sum in another order than the whole batch: the bars of
                # chip_smoke phase 3
                op, os_ = one.predict_specs(specs)
                agree = float((gp == op).mean())
                if eng.int8:
                    assert np.array_equal(gp, op) and \
                        np.array_equal(gs, os_), f"{mode} x{nd}: {agree}"
                elif bf16:
                    assert agree >= 0.99, f"{mode} x{nd}: {agree}"
                else:
                    assert agree == 1.0, f"{mode} x{nd}: {agree}"
                    assert np.abs(gs - os_).max() <= 1e-4, f"x{nd}"
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
               gpus=torch.cuda.device_count(),
               engines=check_engines(smoke, params),
               mesh_cli=check_mesh_cli(smoke, params),
               dp_tp=smoke.check_dp_tp(params))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(out["device"])
    print(json.dumps({"ok": True, "gpus": out["gpus"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
