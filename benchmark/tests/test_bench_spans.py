"""The span metrics (benchmark/spans.py and the metrics whose source is
program_span): each reader's value on a synthetic record, None untraced
or without the program's recorder, and a record made on the CPU through a
driver's slice."""

import sys
import types

import numpy as np
import pytest
import torch

from benchmark import spans, spec
from svision_tpu_torch import trace

torch.set_num_threads(2)

NAMES = ("dispatch_idle_pct.predict", "call_gap_ms.predict",
         "host_busy_pct.predict", "host_rows_per_s.predict",
         "dispatch_idle_pct.train", "step_device_ms.train")


def S(name, start, end, id=None, parent=None, call=None, device=None,
      **attrs):
    return types.SimpleNamespace(name=name, id=id, parent=parent, call=call,
                                 device=device, start_ns=start, end_ns=end,
                                 attrs=attrs)


def record(spans_, start, end):
    """The program's record holding these spans over [start, end]."""
    rec = trace.Record()
    rec.spans, rec.start_ns, rec.end_ns = spans_, start, end
    return rec


def engine_record():
    """Two calls on two cards over a window of 500 us."""
    us = 1000
    host = [S("engine.call", 0, 220 * us, id=1, call=1, rows=1000),
            S("engine.sync", 150 * us, 220 * us, id=2, parent=1, call=1),
            S("engine.host_rows", 5 * us, 15 * us, id=3, parent=1, call=1,
              rows=1024),
            S("engine.call", 240 * us, 460 * us, id=4, call=4, rows=100),
            S("engine.sync", 400 * us, 460 * us, id=5, parent=4, call=4),
            S("engine.host_rows", 245 * us, 247 * us, id=6, parent=4, call=4,
              rows=128),
            # a sync outside any call is no call's wait
            S("engine.sync", 470 * us, 480 * us, id=7, call=7)]
    dev = [S("engine.dispatch", a * us, b * us, parent=p, call=c, device=d)
           for d, a, b, p, c in (
               (0, 0, 100, 1, 1), (0, 90, 200, 1, 1), (0, 300, 400, 4, 4),
               (1, 50, 250, 1, 1), (1, 260, 450, 4, 4))]
    return record(host + dev, 0, 500 * us)


def train_record():
    ms = 1_000_000
    host = [S("train.step", 0, 1, id=i, call=i, phase=ph) for i, ph in
            enumerate(["eager", "replay", "replay", "replay"], 1)]
    dev = [S("train.step", a, a + int(t * ms), parent=i, call=i, device=0)
           for i, a, t in ((1, 0, 5.0), (2, 6 * ms, 4.1), (3, 11 * ms, 4.3),
                           (4, 16 * ms, 4.2))]
    return record(host + dev, 0, 25 * ms)


def test_idle_pct_takes_the_union_within_the_window():
    """Overlapping device spans count once, and only their part inside the
    window counts."""
    dev = [S("engine.dispatch", a, b, device=0)
           for a, b in ((0, 10), (5, 20), (30, 40), (90, 120), (130, 140))]
    assert spans.idle_pct(record(dev, 0, 100), "engine.dispatch") == 60.0
    assert spans.idle_pct(record(dev, 8, 35), "engine.dispatch") == (
        pytest.approx(100 * (1 - 17 / 27)))
    assert spans.idle_pct(record(dev[3:], 0, 100), "engine.dispatch") == 90.0
    assert spans.idle_pct(record([], 0, 10), "engine.dispatch") is None


def test_readers_on_a_synthetic_record():
    rec = engine_record()
    # card 0 covers 300 of 500 us, card 1 390
    assert spans.idle_pct(rec, "engine.dispatch") == pytest.approx(
        100 * (0.4 + 0.22) / 2)
    # card 0: 200 -> 300 us, card 1: 250 -> 260 us
    assert spans.call_gap_ms(rec, "engine.dispatch") == pytest.approx(0.055)
    # (220 - 70) + (220 - 60) us of 500
    assert spans.host_busy_pct(rec) == pytest.approx(62.0)
    assert spans.host_rows_per_s(rec) == pytest.approx(1152 / 12e-6)
    assert spans.idle_pct(rec, "train.step") is None
    assert spans.step_device_ms(rec) is None
    tr = train_record()
    assert spans.step_device_ms(tr) == pytest.approx(4.2)
    assert spans.step_device_ms(tr, phase="eager") == pytest.approx(5.0)
    assert spans.idle_pct(tr, "train.step") == pytest.approx(
        100 * (1 - 17.6 / 25))
    assert spans.call_gap_ms(tr, "train.step") is not None
    assert spans.host_busy_pct(tr) is None
    assert spans.host_rows_per_s(tr) is None


@pytest.mark.parametrize("name", NAMES)
def test_metric_files(name):
    """Each metric reads the record kept on ctx when traced, and gives
    None untraced."""
    entry = [m for m in spec.load()["per_layer"] if m["name"] == name]
    assert len(entry) == 1 and entry[0]["source"] == "program_span"
    read = spec.metric(name).read
    rec = train_record() if name.endswith(".train") else engine_record()
    ctx = types.SimpleNamespace(trace=object(), spans=rec)
    want = {"dispatch_idle_pct.predict": 31.0, "call_gap_ms.predict": 0.055,
            "host_busy_pct.predict": 62.0,
            "host_rows_per_s.predict": 9.6e7,
            "dispatch_idle_pct.train": 29.6,
            "step_device_ms.train": 4.2}[name]
    assert read(ctx) == pytest.approx(want)
    assert read(types.SimpleNamespace(trace=None)) is None


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    import svision_tpu_torch
    monkeypatch.setitem(sys.modules, "svision_tpu_torch.trace", None)
    monkeypatch.delattr(svision_tpu_torch, "trace", raising=False)
    calls = []
    driver = types.SimpleNamespace(devices=[], slice=lambda: calls.append(1))
    ctx = types.SimpleNamespace(trace=object(), spans=spans.take(driver))
    for name in NAMES:
        assert spec.metric(name).read(ctx) is None
    assert ctx.spans is None and not calls


def test_record_of_a_cpu_slice():
    """take() runs the driver's slice once with the recorder on and gives
    the record: the engine's host spans are there, device spans are not
    (the CPU has none), so the host metrics read and the device ones give
    None."""
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.models.alexnet import init_params
    from svision_tpu_torch.timing import random_specs
    eng = InferenceEngine(init_params(0), batch_size=4, chunk=2,
                          device="cpu")
    calls = [random_specs(n, seed=n) for n in (5, 11)]
    runs = []

    def slice_():
        runs.append(1)
        for specs in calls:
            eng.predict_specs(specs)
    driver = types.SimpleNamespace(devices=[torch.device("cpu")],
                                   slice=slice_)
    ctx = types.SimpleNamespace(trace=object(), spans=spans.take(driver))
    got = {n: spec.metric(n).read(ctx) for n in NAMES}
    assert runs == [1]
    rec = ctx.spans
    assert len([s for s in rec.spans if s.name == "engine.call"]) == 2
    assert got["dispatch_idle_pct.predict"] is None
    assert got["call_gap_ms.predict"] is None
    assert 0 < got["host_busy_pct.predict"] <= 100
    assert got["host_rows_per_s.predict"] > 0
    rows = sum(s.attrs["rows"] for s in rec.spans
               if s.name == "engine.host_rows")
    assert rows == 4 * sum(np.ceil(len(c) / 4) for c in calls)
    assert got["dispatch_idle_pct.train"] is None
    assert got["step_device_ms.train"] is None
