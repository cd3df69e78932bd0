"""Run one benchmark cell once, on the cards of this machine.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It makes the cell's inputs and weights from
the seed, sets the program up and warms it (set-up), measures a window of
`--seconds` of the cell's traffic, with --trace 1 takes further slices of
the same work (one with the program's span recorder on, when a metric of
the cell reads spans, then one under the profiler), and reads the device
memory peak. Then it frees the program, holds a sample of what the
window produced to the plain reference (benchmark/reference) and prints,
as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 the breakdown, and
last the numbers compared, each beside its limit (also the last lines of
standard error).

It exits non-zero and prints no result when the machine has fewer cards
than the cell asks for, when the program is not in the checkout, or when
JAX or the JAX package has been loaded. Kernel and compiler caches stay
in the checkout's build/ directory.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != HERE]

FORBIDDEN = ("jax", "jaxlib", "flax", "svision_tpu")
PROGRAM = "svision_tpu_torch"
BUILD = os.path.join(ROOT, "build")


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (svision_tpu_torch is not svision_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs() -> None:
    """Compiler and kernel caches at fixed paths inside the checkout. The
    program builds its own kernels into build/kernels there."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(BUILD, sub)


def slices(driver, entries) -> dict:
    """A traced run's further slices of the driver's work, as ctx keys:
    first, where one of `entries` reads the program's spans, a slice with
    its recorder on and the profiler off, so that the spans carry none of
    the profiler's cost; then the profiled slice."""
    from benchmark import devtrace, spans
    got = {}
    if any(m["source"] == "program_span" for m in entries):
        got["spans"] = spans.take(driver)
    got["trace"] = devtrace.profile(driver.slice, driver.devices)
    return got


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    import importlib.util
    from benchmark import spec
    try:
        bench = spec.load()
        cell = spec.workload(bench, args.workload)
        cfg = spec.config(bench, cell["config"])
        mix = spec.traffic(cell["traffic"])
        lim = spec.limits(cell["name"])["limits"]
        driver_mod = spec.driver(mix["driver"])
        entries = spec.reported(bench, cell["name"], bool(args.trace))
        readers = {m["name"]: spec.metric(m["name"]) for m in entries}
    except (OSError, KeyError, ValueError) as e:
        fail(f"cell {args.workload!r}: {e}")
    if importlib.util.find_spec(PROGRAM) is None:
        fail(f"the program ({PROGRAM}) is not in this checkout")

    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"cell {cell['name']} needs {chips} CUDA device(s), this machine "
             f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
             3)
    driver = driver_mod.Driver(cfg, mix, args.seed, chips)
    devices = driver.devices
    driver.setup()
    for d in devices:
        torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - T_START

    window = driver.window(args.seconds)
    traced = slices(driver, entries) if args.trace else {"trace": None}
    trace = traced["trace"]
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
    name = torch.cuda.get_device_name(devices[0])
    ctx = types.SimpleNamespace(
        cell=cell, config=cfg, mix=mix, seed=args.seed, window=window,
        setup_s=setup_s, driver=driver, device_name=name, chips=chips,
        **traced)
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    checks = driver.check()
    missing = sorted(set(lim) - set(checks))
    if missing:
        fail(f"the check gave no {missing}")
    correct = all(math.isfinite(checks[k]) and checks[k] <= lim[k]
                  for k in lim)

    found = forbidden_modules()
    if found:
        fail(f"modules that must not load were loaded: {found}", 4)

    device = {"platform": "gpu", "kind": name, "count": chips,
              "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = {k: {"value": checks[k], "limit": lim[k]} for k in lim}
    print("set-up phases (s from the start of the driver's set-up): "
          + json.dumps(driver.phases), file=sys.stderr)
    for k in lim:
        print(f"check {k} {checks[k]!r} limit {lim[k]!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
