"""The readings that a cell's limits are set from: the numbers `correct`
compares, for sound runs of the program on many seeds and for the cell's
control on the same seeds, all in one process (set-up is paid once for
the kernels and the libraries).

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        [--seconds 2] [--control] [--fault NAME] [--out FILE]

A sound run is the run's own set-up, a short window at the cell's load
and its check. The control is the cell's limits file's "control": 'int8'
runs the program's own int8 engine in its place; 'tf32' puts the
reference, computed with TF32, in the program's place; 'fp8' puts the
reference, its convolutions and matmuls computed through float8, in the
training step's place. The benchmark's own runs never run a control.
--fault reads sound runs with one of faults.py's faults planted instead.
Prints one JSON line a seed and run; --out writes them all as one JSON
object.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != HERE]

PROGRAM_CONTROLS = ("int8",)


def readings(cell_name: str, seed: int, seconds: float, control=None):
    """{name: value} of one run of the cell on seed: the program's, or with
    control the control's."""
    import torch
    from benchmark import spec
    bench = spec.load()
    cell = spec.workload(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    driver = spec.driver(mix["driver"]).Driver(
        cfg, mix, seed, int(cell["chips"]),
        control=control if control in PROGRAM_CONTROLS else None)
    driver.setup()
    driver.window(seconds)
    for d in driver.devices:
        torch.cuda.synchronize(d)
    driver.release()
    if control is None or control in PROGRAM_CONTROLS:
        return driver.check()
    return driver.control_check(control)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true",
                    help="also read the control on every seed")
    ap.add_argument("--fault", default=None,
                    help="read runs with this fault planted (faults.py)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import contextlib
    from benchmark import faults, spec
    control = spec.limits(args.workload)["control"] if args.control else None
    planted = (faults.FAULTS[args.fault] if args.fault
               else contextlib.nullcontext)
    out = {"workload": args.workload, "sound": {}, "control": {},
           "control_kind": control, "fault": args.fault}
    for seed in (int(s) for s in args.seeds.split(",")):
        with planted():
            r = readings(args.workload, seed, args.seconds)
        out["sound"][seed] = r
        print(json.dumps({"seed": seed, "sound": r}), flush=True)
        if control:
            c = readings(args.workload, seed, args.seconds, control)
            out["control"][seed] = c
            print(json.dumps({"seed": seed, "control": c}), flush=True)
    for kind in ("sound", "control"):
        if out[kind]:
            names = next(iter(out[kind].values()))
            summary = {k: {"min": min(r[k] for r in out[kind].values()),
                           "max": max(r[k] for r in out[kind].values())}
                       for k in names}
            print(json.dumps({kind: summary}), flush=True)
            out[f"{kind}_range"] = summary
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
