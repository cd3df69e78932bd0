"""BENCHMARK.json and the files it names, found by name.

Whatever belongs to one configuration, traffic mix, driver, metric or
cell's limits sits in a file of its own under this folder, named after it:

    configs/<config file>            (the path BENCHMARK.json gives)
    traffic/<mix>.json               (parameters the generator reads)
    drivers/<driver>.py              (the entry the window drives; the mix
                                      names it)
    metrics/<metric>.py              (read(ctx) -> a number, or None)
    limits/<cell>.json               (the limits `correct` is held to)

so a cell, a configuration, a mix or a metric is added by adding files and
entries, never by editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"the benchmark has no file {path}")
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    """A Python file of this folder, loaded by path (names may hold dots)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"the benchmark has no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one(entries: List[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named {name!r}")
    return found[0]


def workload(bench: dict, name: str) -> dict:
    return _one(bench["workloads"], name, "workloads")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration's file, as it is run."""
    entry = _one(bench["configs"], name, "configs")
    return _json(os.path.join(root, entry["file"]))


def traffic(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "traffic", f"{name}.json"))


def limits(cell: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "limits", f"{cell}.json"))


def driver(name: str, base: str = HERE):
    return _module(os.path.join(base, "drivers", f"{name}.py"),
                   f"bench_driver_{name}")


def metric(name: str, base: str = HERE):
    return _module(os.path.join(base, "metrics", f"{name}.py"),
                   "bench_metric_" + name.replace(".", "_").replace("-", "_"))


def reported(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metric entries a run of `cell` reports: untraced its end-to-end
    metrics (those without a `workloads` key go with every cell), traced
    the per-layer metrics whose `workloads` list it."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]
