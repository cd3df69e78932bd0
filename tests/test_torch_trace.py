"""The port's spans and counters (svision_tpu_torch/trace.py): how spans
nest, share a call id and give self time; that nothing is recorded, and
one null context comes back, while tracing is off; the engine's and the
training step's spans on the CPU, with outputs bit-equal with recording
on and off; the span names in torch.profiler's trace; the CLI's
--profile writing spans.json.

The `gpu` cases need a card and skip without one. On a machine with a
card:

    python -m pytest --noconftest -m gpu tests/test_torch_trace.py
"""
import json
import time

import numpy as np
import pytest
import torch

from svision_tpu_torch import graphs, trace
from svision_tpu_torch.infer.engine import InferenceEngine
from svision_tpu_torch.models.alexnet import init_params
from svision_tpu_torch.timing import random_specs

torch.set_num_threads(2)

ENGINE_CHILDREN = ("engine.pad", "engine.host_rows", "engine.dispatch",
                   "engine.sync", "engine.unshard")


@pytest.fixture(scope="module")
def params():
    return init_params(0)


def _wait_ns(ns):
    end = time.perf_counter_ns() + ns
    while time.perf_counter_ns() < end:
        pass


def test_spans_nest_share_a_call_and_give_self_time():
    with trace.recording() as rec:
        with trace.span("outer", kind="a") as outer:
            _wait_ns(200_000)
            with trace.span("inner"):
                _wait_ns(300_000)
                with trace.span("leaf"):
                    _wait_ns(100_000)
            with trace.span("inner"):
                _wait_ns(300_000)
            outer.set(rows=5)
            trace.count("things", 2)
            trace.count("things")
        with trace.span("second"):
            pass
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
    (o,), (leaf,), (second,) = by["outer"], by["leaf"], by["second"]
    inner = by["inner"]
    assert o.attrs == {"kind": "a", "rows": 5} and o.parent is None
    assert o.call == o.id and second.call == second.id != o.call
    assert all(s.parent == o.id and s.call == o.call for s in inner)
    assert leaf.parent == inner[0].id and leaf.call == o.call
    assert all(o.start_ns <= s.start_ns < s.end_ns <= o.end_ns
               for s in inner + [leaf])
    assert rec.children(o) == inner
    assert rec.self_ns(o) == o.ns - sum(s.ns for s in inner)
    assert rec.self_ns(inner[0]) == inner[0].ns - leaf.ns
    assert rec.self_ns(o) >= 200_000 and rec.self_ns(leaf) == leaf.ns
    assert dict(rec.counts) == {"things": 3} and rec.dropped == 0
    assert rec.start_ns <= o.start_ns and second.end_ns <= rec.end_ns
    assert {s.thread for s in rec.spans} == {o.thread}


def test_record_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    with trace.recording() as rec:
        for _ in range(5):
            with trace.span("x"):
                pass
    assert len(rec.spans) == 3 and rec.dropped == 2


def test_off_records_nothing_and_returns_one_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("engine.call"), trace.span("other", rows=3)
    assert a is b and not a
    assert trace.device_span("engine.dispatch", "cpu") is a
    with a as sp:
        sp.set(rows=1)
    trace.count("graphs.captures")
    with trace.recording() as rec:
        with trace.span("on"):
            pass
        # a CPU device records no device span
        assert trace.device_span("engine.dispatch", "cpu") is a
    assert [s.name for s in rec.spans] == ["on"] and not rec.counts
    assert trace.span("after") is a


def test_recording_does_not_nest():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already on"):
            with trace.recording():
                pass
    assert trace.span("x") is trace.span("y")


def _engine_record(params, devices, specs):
    eng = InferenceEngine(params, batch_size=4, chunk=2, device="cpu",
                          devices=devices)
    off = eng.predict_specs(specs)
    with trace.recording(devices or ()) as rec:
        on = eng.predict_specs(specs)
    return eng, rec, off, on


# an 11-row call at batch 4, chunk 2, on each engine: its padded rows,
# each dispatch's endpoint rows, and (card, batches, rows) of each
# engine.dispatch span
SPAN_CASES = {
    # a chunk of 2 batches of 4, then a single batch
    "one-device": (None, 12, [8, 4], [(0, 2, 8), (0, 1, 4)]),
    # each replica takes whole batches of 4: rounds of 8, one chunk of 2
    "mesh-of-2": (("cpu", "cpu"), 16, [16], [(0, 2, 8), (1, 2, 8)]),
}


@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_engine_call_spans_on_the_cpu(params, case):
    """An 11-row call at batch 4, chunk 2 (SPAN_CASES). engine.call holds
    its rows, padding, dispatches, its network (AlexNet's weights: no
    tokens), the bf16 network's three split grouped layers and launch
    deltas: no kernel's on the CPU, and K2's calls in a split form, which
    the CPU counts too, two a batch (conv1's tail writes halves, conv2's
    reads them); its children are the
    padding, one endpoint span a dispatch, one dispatch span a dispatch a
    device with the rows that device's launches take, the sync and the
    unshard; the outputs equal those made with recording off, bit for
    bit."""
    devices, padded, host_rows, dispatches = SPAN_CASES[case]
    specs = random_specs(11, seed=4)
    eng, rec, off, on = _engine_record(params, devices, specs)
    for a, b in zip(off, on):
        assert np.array_equal(a, b)
    nd = len(eng.devices)
    (call,) = rec.find("engine.call")
    assert call.attrs == {
        "rows": 11, "padded_rows": padded, "dispatches": len(host_rows),
        "graphed": False, "network": "alexnet", "split_groups": 3,
        "launches": {**{w.__name__: 0 for w in graphs.kernel_wrappers()},
                     "bias_relu_pool_lrn_halves": 2 * padded // 4}}
    kids = rec.children(call)
    assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)] == (
        ["engine.pad"]
        + (["engine.host_rows"] + ["engine.dispatch"] * nd) * len(host_rows)
        + ["engine.sync", "engine.unshard"])
    assert all(s.call == call.id for s in rec.spans)
    assert [s.attrs["rows"] for s in rec.find("engine.host_rows")] == \
        host_rows
    assert [(s.attrs["card"], s.attrs["batches"], s.attrs["rows"])
            for s in rec.find("engine.dispatch")] == dispatches
    # no device spans on the CPU, no capture
    assert not rec.find("engine.dispatch", device=True)
    assert not rec.counts and rec.dropped == 0
    assert rec.self_ns(call) >= 0


# plan(n) of the one-device engine at batch 128, chunk 8, tail 'full'
ONE_DEVICE_PLANS = {1: ([], 1), 128: ([], 1), 129: ([], 2),
                    8192: ([8] * 8, 0)}


@pytest.mark.parametrize("n", list(ONE_DEVICE_PLANS))
def test_one_device_engine_keeps_its_batches(params, n, monkeypatch):
    """With one device, the rule that gives each replica whole batches
    leaves the engine as it was: batch 128, the JAX engine's plan at chunk
    8 and tail 'full', and one engine.dispatch span a dispatch, on card 0,
    whose rows are its batches x 128. The network is stubbed out: only
    the dispatch runs."""
    eng = InferenceEngine(params, device="cpu")
    assert eng.batch_size == 128 and eng.devices == (torch.device("cpu"),)
    assert eng.plan(n) == ONE_DEVICE_PLANS[n]

    def step(model, w_s2d, ep, vis, rev):
        z = torch.zeros(ep.shape[0])
        return z.long(), z
    monkeypatch.setattr(eng, "_step", step)
    with trace.recording() as rec:
        p, _ = eng.predict_specs(random_specs(n, seed=n))
    assert p.shape == (n,)
    chunks, singles = ONE_DEVICE_PLANS[n]
    assert [(s.attrs["card"], s.attrs["batches"], s.attrs["rows"])
            for s in rec.find("engine.dispatch")] == \
        [(0, c, c * 128) for c in chunks + [1] * singles]


def test_train_step_spans_on_the_cpu(params):
    """make_device_step's step: one train.step span a step, phase eager on
    the CPU, each step a call of its own."""
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import AlexNet
    from svision_tpu_torch.ops import rasterize
    n = 8
    seg = [torch.from_numpy(np.ascontiguousarray(a)) for a in
           rasterize.specs_to_endpoints(random_specs(n, seed=2))]
    model = AlexNet.trainable(params, device="cpu")
    _, step = train.make_device_step(
        model, *seg, torch.arange(n) % 5, torch.Generator().manual_seed(0),
        batch_size=4, keep_prob=1.0, augment=False)
    flip = torch.zeros((), dtype=torch.bool)
    with trace.recording() as rec:
        for s in range(2):
            step(torch.arange(4 * s, 4 * s + 4), flip)
    steps = rec.find("train.step")
    assert [s.attrs for s in steps] == [{"phase": "eager"}] * 2
    assert len({s.call for s in steps}) == 2
    assert not rec.find("train.step", device=True)


def test_span_names_in_the_profiler_trace(params):
    """Under torch.profiler the spans are record_function events of the
    same names, whether or not the recorder is on."""
    from torch.profiler import ProfilerActivity, profile
    eng = InferenceEngine(params, batch_size=4, chunk=2, device="cpu")
    specs = random_specs(9, seed=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.predict_specs(specs)
        with trace.span("named.alone") as sp:
            assert not sp
    names = {e.name for e in prof.events()}
    assert {"engine.call", "named.alone", *ENGINE_CHILDREN} <= names
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            trace.recording() as rec:
        eng.predict_specs(specs)
    assert {"engine.call", *ENGINE_CHILDREN} <= {e.name for e in
                                                  prof.events()}
    assert len(rec.find("engine.call")) == 1
    assert trace.span("x") is trace.span("y")


def test_chrome_trace():
    with trace.recording() as rec:
        with trace.span("a", rows=2):
            with trace.span("b"):
                pass
        trace.count("graphs.captures")
    doc = json.loads(json.dumps(rec.chrome_trace()))
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert ev["a"]["ph"] == "X" and ev["a"]["args"]["rows"] == 2
    assert ev["b"]["args"]["parent"] == ev["a"]["args"]["id"]
    assert ev["a"]["ts"] <= ev["b"]["ts"]
    assert ev["a"]["dur"] >= ev["b"]["dur"] >= 0
    assert ev["graphs.captures"] == {**ev["graphs.captures"], "ph": "C",
                                     "args": {"graphs.captures": 1}}


def test_cli_profile_writes_spans(tmp_path):
    """--profile DIR writes torch.profiler's trace.json and the program's
    spans.json beside it; the summary's counters hold no rate."""
    from svision_tpu_torch import cli, sim
    from svision_tpu_torch.models.checkpoint import save_params
    genome = str(tmp_path / "ref.fa")
    seqs = sim.make_genome(genome, {"chr1": 60000}, seed=3)
    bam = str(tmp_path / "s.bam")
    sim.make_sv_bam(bam, seqs, seed=3, support=8,
                    events=[("DEL", "chr1", 20000, 300)])
    weights = str(tmp_path / "w.npz")
    save_params(init_params(0), weights)
    prof = tmp_path / "prof"
    cli.run_pipeline(cli.parse_arguments([
        "-o", str(tmp_path / "out"), "-b", bam, "-g", genome, "-m", weights,
        "-n", "s", "-s", "3", "--batch_size", "8", "--exact",
        "--device", "cpu", "--mesh", "none", "--profile", str(prof)]))
    assert (prof / "trace.json").is_file()
    doc = json.loads((prof / "spans.json").read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"engine.call", "engine.host_rows", "engine.dispatch"} <= names
    assert "images_per_s" not in cli.LAST_METRICS.counters
    assert cli.LAST_METRICS.counters["images"] > 0


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: device spans and kernel launches "
                    "exist only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_device_spans_lie_inside_their_call(cuda, params):
    """Each engine.dispatch device span starts after its host dispatch span
    started and ends before its call's engine.sync ended, on the host span
    clock (within 50 us for the anchors' mapping)."""
    eng = InferenceEngine(params)
    eng.warmup()
    slack = 50_000
    with trace.recording([cuda]) as rec:
        for n in (129, 20 * 128 + 3, 3 * 128):
            eng.predict_specs(random_specs(n, seed=n))
    host = {s.id: s for s in rec.spans if s.device is None}
    syncs = {s.call: s for s in rec.find("engine.sync")}
    dev = rec.find("engine.dispatch", device=True)
    assert len(dev) == len(rec.find("engine.dispatch", device=False)) > 3
    for d in dev:
        h = host[d.parent]
        assert h.name == "engine.dispatch" and d.device == 0
        assert h.start_ns - slack <= d.start_ns < d.end_ns
        assert d.end_ns <= syncs[d.call].end_ns + slack
    assert rec.start_ns <= min(d.start_ns for d in dev)
    assert max(d.end_ns for d in dev) <= rec.end_ns


@pytest.mark.gpu
def test_device_spans_past_the_pool(cuda, monkeypatch):
    """Past the events made as recording starts a device span makes its
    own: every span is kept, each after the one before on the host span
    clock (within 50 us)."""
    monkeypatch.setattr(trace, "POOL", 3)
    with trace.recording([cuda]) as rec:
        for _ in range(4):
            with trace.device_span("work", cuda):
                torch.cuda._sleep(1_000_000)
    dev = sorted(rec.find("work", device=True), key=lambda s: s.start_ns)
    assert len(dev) == 4 and rec.dropped == 0
    assert all(s.ns > 0 for s in dev)
    assert all(a.end_ns <= b.start_ns + 50_000 for a, b in zip(dev, dev[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [True, False])
def test_call_launches_equal_the_plan(cuda, params, bf16):
    """engine.call's launch deltas: K3 once and K2 twice a batch a card
    (the exact engine on the card takes the fused route too), both of the
    bf16 engine's K2 launches in a split form, none of the exact one's,
    and the endpoints kernel once a dispatch a card."""
    eng = InferenceEngine(params, bf16=bf16)
    eng.warmup()
    n = 11 * 128 + 5
    with trace.recording([cuda]) as rec:
        eng.predict_specs(random_specs(n, seed=5))
    (call,) = rec.find("engine.call")
    chunks, singles = eng.plan(n)
    batches = (sum(chunks) + singles) * len(eng.devices)
    want = {w.__name__: 0 for w in graphs.kernel_wrappers()}
    want.update({"conv1_fused_raster": batches,
                 "bias_relu_pool_lrn": 2 * batches,
                 "bias_relu_pool_lrn_halves": 2 * batches if bf16 else 0,
                 "specs_endpoints": (len(chunks) + singles)
                 * len(eng.devices)})
    assert call.attrs["launches"] == want
    assert call.attrs["dispatches"] == len(chunks) + singles


@pytest.mark.gpu
def test_captures_after_warmup(cuda, params):
    """A warmed 'full' engine captures no graph in later calls; a 'pow2'
    engine captures one at a tail shape it has not seen, then none; the
    capture's span names its card, batches and network."""
    full = InferenceEngine(params)
    full.warmup()
    with trace.recording([cuda]) as rec:
        for n in (1, 3 * 128, 20 * 128 + 1):
            full.predict_specs(random_specs(n, seed=n))
    assert not rec.counts.get("graphs.captures")
    assert not rec.find("engine.capture")
    pow2 = InferenceEngine(params, tail="pow2")
    pow2.warmup()
    for expect in (1, 0):
        with trace.recording([cuda]) as rec:
            pow2.predict_specs(random_specs(3 * 128, seed=3))
        assert rec.counts.get("graphs.captures", 0) == expect
        caps = rec.find("engine.capture")
        assert [s.attrs for s in caps] == [
            {"card": 0, "batches": 4, "network": "alexnet"}] * expect


@pytest.mark.gpu
def test_train_step_phases_and_device_spans(cuda, params):
    """make_device_step on the card: WARMUP_STEPS eager steps, a capture,
    then replays, each with its device span inside its host span's
    call."""
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import AlexNet
    from svision_tpu_torch.ops import rasterize
    n, b = 256, 32
    seg = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in
           rasterize.specs_to_endpoints(random_specs(n, seed=2))]
    model = AlexNet.trainable(params, device=cuda)
    _, step = train.make_device_step(
        model, *seg, torch.arange(n, device=cuda) % 5,
        torch.Generator(device=cuda).manual_seed(0), batch_size=b,
        compute_dtype=torch.bfloat16)
    flip = torch.zeros((), dtype=torch.bool, device=cuda)
    steps = graphs.WARMUP_STEPS + 3
    with trace.recording([cuda]) as rec:
        for s in range(steps):
            step(torch.arange(b, device=cuda) + b * s, flip)
    host = rec.find("train.step", device=False)
    assert [s.attrs["phase"] for s in host] == (
        ["eager"] * graphs.WARMUP_STEPS + ["capture", "replay", "replay"])
    dev = rec.find("train.step", device=True)
    by_id = {s.id: s for s in host}
    assert len(dev) == steps
    for d in dev:
        h = by_id[d.parent]
        assert d.call == h.call and h.start_ns - 50_000 <= d.start_ns
        assert d.start_ns < d.end_ns <= rec.end_ns
    assert rec.counts["graphs.captures"] == 1
