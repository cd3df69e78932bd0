"""The engine's dispatch plan on one CUDA GPU: chunk and tail against
rate, capture time, graph memory and the CLI's wall.

    python3 scripts/torch_chunks.py [--out FILE]

For each (chunk, tail) of CONFIGS and each numeric mode, with seed-0
weights at batch 128: the warm-up's time (the eager sentinel batch and the
captures) and the memory its graphs keep reserved; images/s on
chip_smoke.random_specs at 8,192 specs (chip_smoke phase 3's call) and, in
bf16, at 65,536 (bench.py's 512 batches), the best of 3 calls after one;
and the wall of a CLI run (cli.run_pipeline, warm-up included) on
chip_smoke phase 4's fixture. The CLI takes the plan from the engine's
defaults (infer/engine.py CHUNK and TAIL), which this script sets for each
configuration. The configurations run twice, in order and then in reverse
order, so that a drift over the run (warming caches) does not favour the
later ones.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ((1, "full"), (8, "full"), (32, "full"), (128, "full"),
           (32, "pow2"), (128, "pow2"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("torch_chunks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from svision_tpu_torch import cli
    from svision_tpu_torch.infer import engine
    from svision_tpu_torch.models.alexnet import init_params
    smoke.REPORT["device"] = {"nvidia_smi": smoke.nvidia_smi()}
    params = init_params(0)
    calls = {8192: smoke.random_specs(8192, seed=3),
             65536: smoke.random_specs(65536, seed=6)}
    rows = []
    with tempfile.TemporaryDirectory() as work:
        fx = smoke.make_fixtures(params, work)
        for rnd, (chunk, tail) in enumerate(CONFIGS + CONFIGS[::-1]):
            engine.CHUNK, engine.TAIL = chunk, tail
            for mode, bf16 in (("bf16", True), ("exact", False)):
                eng = engine.InferenceEngine(params, bf16=bf16)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
                t0 = time.perf_counter()
                eng.warmup()
                torch.cuda.synchronize()
                row = dict(chunk=chunk, tail=tail, mode=mode,
                           round=rnd // len(CONFIGS),
                           warmup_s=time.perf_counter() - t0)
                torch.cuda.empty_cache()
                row["graph_reserved_bytes"] = (torch.cuda.memory_reserved()
                                               - reserved)
                for n, specs in calls.items():
                    if n > 8192 and not bf16:
                        continue
                    eng.predict_specs(specs)
                    row[f"images_per_s_{n}"] = smoke.best_rate(eng, specs)
                    row[f"plan_{n}"] = eng.plan(n)
                del eng
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                cli.run_pipeline(cli.parse_arguments(
                    ["-o", os.path.join(work, f"cli_{rnd}_{mode}"),
                     "-b", fx["bam"], "-g", fx["genome"], "-m", fx["weights"],
                     "-n", "synthsample", "-s", "3"]
                    + ([] if bf16 else ["--exact"])))
                row["cli_wall_s"] = time.perf_counter() - t0
                rows.append(row)
                print(json.dumps({k: v for k, v in row.items()
                                  if not k.startswith("plan")}), flush=True)
    result = dict(device=smoke.REPORT["device"]["nvidia_smi"], rows=rows)
    print(result["device"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
