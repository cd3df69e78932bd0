"""The operation and byte counts of benchmark/work.py."""

import json
import os

import pytest
import torch

from benchmark import spec, work

MODEL = spec.config(spec.load(), "svision-alexnet-bf16")["model"]


def test_inference_flops():
    assert work.inference_flops(MODEL) == 1_440_662_592


def test_training_flops():
    assert work.layer_macs(MODEL)["conv1"] == 105_415_200
    assert work.training_flops(MODEL) == 4_111_157_376
    assert work.training_flops(MODEL) == (3 * 1_440_662_592
                                          - 2 * 105_415_200)


def test_configs_share_the_network():
    bench = spec.load()
    models = [spec.config(bench, c["name"])["model"]
              for c in bench["configs"]]
    assert all(m == models[0] for m in models)


def test_shapes():
    sh = work.shapes(MODEL)
    assert sh["conv1"] == (55, 55, 96) and sh["conv1_pool"] == (27, 27, 96)
    assert sh["conv2"] == (27, 27, 256) and sh["conv2_pool"] == (13, 13, 256)
    assert sh["conv5_pool"] == (6, 6, 256)


def test_lit_macs_of_a_lit_canvas_are_conv1s():
    """Every pixel lit: the lit count is conv1's dense count; one pixel in
    a corner is under one output window."""
    full = torch.ones(2, 227, 227, 3)
    assert work.conv1_lit_macs(full, MODEL) == 2 * 105_415_200
    one = torch.zeros(1, 227, 227, 3)
    one[0, 0, 0, 0] = 1
    assert work.conv1_lit_macs(one, MODEL) == 96
    mid = torch.zeros(1, 227, 227, 3)
    mid[0, 20, 20, 1] = 1          # rows 12..20 -> outputs 3, 4 and 5 a side
    assert work.conv1_lit_macs(mid, MODEL) == 3 * 3 * 96


def test_kernel_bytes_match_their_stated_bounds():
    """The bytes the kernels' own docstrings give at batch 128."""
    b, _ = work.k2_stage(MODEL, 128, "conv1", "bfloat16")
    assert b == pytest.approx(92.3e6, rel=2e-3)
    b, _ = work.k2_stage(MODEL, 128, "conv2", "bfloat16")
    assert b == pytest.approx(58.9e6, rel=2e-3)
    b, flops = work.k1_stage(MODEL, 128, "float32")
    assert b == pytest.approx(79.1e6, rel=2e-3) and flops == 0
    b, _ = work.k3_stage(MODEL, 128, "bfloat16", 0)
    assert b == pytest.approx(74.3e6, rel=2e-3)
    b, _ = work.k2_backward_stage(MODEL, 64, "conv1", "bfloat16")
    assert b / 3.35e12 * 1e3 == pytest.approx(0.0249, rel=0.01)


def test_least_time_takes_the_larger_bound():
    name = "NVIDIA H100 80GB HBM3"
    assert work.least_s(3.35e12, 0, name, "bfloat16") == pytest.approx(1.0)
    assert work.least_s(0, 989.4e12, name, "bfloat16") == pytest.approx(1.0)
    assert work.least_s(3.35e12, 2 * 67e12, name, "float32") == \
        pytest.approx(2.0)


def test_peaks_table():
    with open(os.path.join(spec.HERE, "peaks.json")) as f:
        table = json.load(f)
    for name, p in table.items():
        assert {"bfloat16_flops", "float32_flops", "hbm_bytes_per_s",
                "source"} <= set(p), name
