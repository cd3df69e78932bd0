"""The check that decides `correct`, shown to fail, on the card: each
cell's control (its numbers at a lower precision than the configuration
states) reads past a limit on three seeds, and a run whose timed path is
broken underneath comes out not correct, once for each fault the cell can
have.

    python -m pytest -q -m gpu benchmark/tests/test_bench_gpu.py

Skips without enough CUDA devices.
"""

import json

import pytest
import torch

from benchmark import calibrate, faults, run, spec

pytestmark = pytest.mark.gpu

BENCH = spec.load()
ONE_CHIP = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
SEEDS = (1_000_003, 2_000_029, 3_000_017)
SECONDS = 1.0


def need(chips):
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA device(s)")


def run_cell(capsys, cell, seed):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(SECONDS), "--trace", "0"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def past_a_limit(cell, readings):
    lim = spec.limits(cell)["limits"]
    return [k for k in lim if not readings[k] <= lim[k]]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails(cell):
    need(spec.workload(BENCH, cell)["chips"])
    control = spec.limits(cell)["control"]
    for seed in SEEDS:
        r = calibrate.readings(cell, seed, SECONDS, control)
        assert past_a_limit(cell, r), (cell, seed, r)


CELL_FAULTS = [(w["name"], f) for w in BENCH["workloads"]
               for f in spec.limits(w["name"])["faults"]]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS,
                         ids=[f"{c}-{f}" for c, f in CELL_FAULTS])
def test_broken_timed_path_is_not_correct(cell, fault, capsys):
    need(spec.workload(BENCH, cell)["chips"])
    with faults.FAULTS[fault]():
        result = run_cell(capsys, cell, SEEDS[0])
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_sound_run_is_correct(cell, capsys):
    need(1)
    result = run_cell(capsys, cell, SEEDS[1])
    assert result["correct"] is True, result["checks"]
