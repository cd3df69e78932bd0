"""BENCHMARK.json and the files it names: every cell finds its files by
name, a cell added as files only is picked up, and names, units and
entries keep to the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
END_TO_END_SOURCES = ("host_clock", "device_trace")

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def files(bench, root=spec.ROOT):
    """Every file the cells of `bench` need, by kind, as paths relative to
    root."""
    base = os.path.relpath(spec.HERE, spec.ROOT)
    out = {"configs": [], "traffic": [], "drivers": [], "metrics": [],
           "limits": []}
    for c in bench["configs"]:
        out["configs"].append(c["file"])
    for w in bench["workloads"]:
        out["traffic"].append(f"{base}/traffic/{w['traffic']}.json")
        out["limits"].append(f"{base}/limits/{w['name']}.json")
        mix = spec.traffic(w["traffic"], os.path.join(root, base))
        out["drivers"].append(f"{base}/drivers/{mix['driver']}.py")
    for m in bench["end_to_end"] + bench["per_layer"]:
        out["metrics"].append(f"{base}/metrics/{m['name']}.py")
    return {k: sorted(set(v)) for k, v in out.items()}


KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_entry_keys(group):
    for e in BENCH[group]:
        extra = set(e) - KEYS[group]
        assert KEYS[group] <= set(e), e["name"]
        assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer")
                         else set()), (e["name"], extra)


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in END_TO_END_SOURCES
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in SOURCES
        assert 1 <= len(m["layer"]) <= 200
        # every per-layer metric names the cells that read it
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS), m["name"]


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_every_cell_reports_what_it_must():
    for cell in CELLS:
        e2e = {m["name"] for m in spec.reported(BENCH, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        layer = spec.reported(BENCH, cell, True)
        assert layer, cell
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = spec.workload(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    assert cfg["reduced"] == [c for c in BENCH["configs"]
                              if c["name"] == w["config"]][0]["reduced"]
    mix = spec.traffic(w["traffic"])
    driver = spec.driver(mix["driver"])
    assert hasattr(driver, "Driver")
    lim = spec.limits(cell)
    assert lim["limits"] and lim["control"]
    for m in spec.reported(BENCH, cell, False) + spec.reported(BENCH, cell,
                                                                True):
        assert callable(spec.metric(m["name"]).read)


def test_files_lie_under_paths():
    for kind, paths in files(BENCH).items():
        for p in paths:
            assert p.startswith("benchmark/"), p
            assert os.path.isfile(os.path.join(spec.ROOT, p)), p
            assert set(p) <= set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOP"
                                 "QRSTUVWXYZ0123456789_.-/"), p


def test_new_cell_as_files_only(tmp_path):
    """A cell, its mix, its limits and a metric, added as new files and
    entries beside the others, are found without an edit."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    base = root / "benchmark"
    mix = json.loads((base / "traffic" / "genome.json").read_text())
    mix["calls"] = mix["calls"][:3]
    (base / "traffic" / "three-chroms.json").write_text(json.dumps(mix))
    (base / "limits" / "bf16.three.json").write_text(
        (base / "limits" / "bf16.genome.json").read_text())
    (base / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.window['attempted'] / "
        "ctx.window['seconds']\n")
    bench["workloads"].append({"name": "bf16.three",
                               "config": "svision-alexnet-bf16",
                               "traffic": "three-chroms", "chips": 1,
                               "why": "three chromosomes"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "images_per_s",
                               "workloads": ["bf16.three"]})
    found = files(bench, str(root))
    assert "benchmark/traffic/three-chroms.json" in found["traffic"]
    assert "benchmark/limits/bf16.three.json" in found["limits"]
    assert spec.traffic("three-chroms", str(base))["calls"] == mix["calls"]
    reported = {m["name"] for m in spec.reported(bench, "bf16.three", True)}
    assert "calls_per_s" in reported
    ctx = type("Ctx", (), {"window": {"attempted": 6, "seconds": 2.0}})
    assert spec.metric("calls_per_s", str(base)).read(ctx) == 3.0


def test_missing_file_is_named():
    with pytest.raises(FileNotFoundError, match="no-such-mix"):
        spec.traffic("no-such-mix")
