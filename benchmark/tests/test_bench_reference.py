"""The reference on the CPU at small sizes: its raster against OpenCV and
the program's plain raster, its network and training step against the
program's plain versions; the readings `correct` compares; the trace's
reduction."""

import json
import types

import numpy as np
import pytest
import torch

from benchmark import devtrace, inputs, spec, traffic
from benchmark.reference import alexnet as ref_alexnet
from benchmark.reference import raster as ref_raster

torch.set_num_threads(4)
BENCH = spec.load()
MODEL = spec.config(BENCH, "svision-alexnet-bf16")["model"]
ENGINE = spec.driver("engine")
TRAIN = spec.driver("train_step")


def specs(n, seed):
    return traffic.random_specs(n, np.random.RandomState(seed))


def test_raster_against_opencv():
    cv2 = pytest.importorskip("cv2")
    rs = np.random.RandomState(4)
    ep = rs.randint(0, 227, (64, 2, 4)).astype(np.int32)
    vis = rs.rand(64, 2) < 0.9
    rev = rs.rand(64, 2) < 0.5
    got = ref_raster.draw(torch.from_numpy(ep), torch.from_numpy(vis),
                          torch.from_numpy(rev)).numpy()
    for i in range(64):
        ch0 = np.zeros((227, 227), np.uint8)
        ch2 = np.zeros((227, 227), np.uint8)
        for s in range(2):
            if vis[i, s]:
                p, q = tuple(map(int, ep[i, s, :2])), tuple(map(int, ep[i, s, 2:]))
                cv2.line(ch0, p, q, 1, 1)
                if rev[i, s]:
                    cv2.line(ch2, p, q, 1, 1)
        ch1 = ch0 * (ch0.sum(axis=0, keepdims=True) >= 2)
        want = np.stack([ch0, ch1, ch2], -1).astype(np.float32)
        assert np.array_equal(got[i], want), i


def test_raster_against_the_programs_plain_raster():
    from svision_tpu_torch.ops import rasterize
    s = specs(96, 11)
    ep, vis, rev = rasterize.specs_to_endpoints(s)
    rep, rvis, rrev = ref_raster.endpoints(s)
    assert np.array_equal(ep, rep) and np.array_equal(vis, rvis)
    assert np.array_equal(rev, rrev)
    want = rasterize.render_images(*(torch.from_numpy(a) for a in
                                     (ep, vis, rev)), dtype=torch.float32)
    assert torch.equal(ref_raster.images(s, "cpu"), want)


def test_network_against_the_programs_f32_network():
    from svision_tpu_torch.models.alexnet import AlexNet
    from svision_tpu_torch.ops import rasterize
    p = inputs.params(MODEL, 3, "cpu")
    s = specs(8, 12)
    x = ref_raster.images(s, "cpu")
    with torch.no_grad():
        ref = ref_alexnet.logits(p, x, MODEL)
        prog = AlexNet.from_params(inputs.host(p), device="cpu")(
            rasterize.render_images(*(torch.from_numpy(a) for a in
                                      rasterize.specs_to_endpoints(s)),
                                    dtype=torch.float32))
    assert torch.allclose(ref, prog, atol=1e-4, rtol=1e-4)


def test_weights_are_the_seeds_and_the_head_spreads():
    a = inputs.params(MODEL, 21, "cpu")
    b = inputs.params(MODEL, 21, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1/weights"],
                           inputs.params(MODEL, 22, "cpu")["conv1/weights"])
    with torch.no_grad():
        lg = ref_alexnet.logits(a, ref_raster.images(specs(128, 5), "cpu"),
                                MODEL)
    counts = torch.bincount(lg.argmax(1), minlength=5)
    assert (counts > 5).all(), counts
    assert 0.4 < float(torch.softmax(lg, 1).amax(1).median()) < 0.95


def test_engine_readings():
    lg = torch.tensor([[2.0, 0.0, 0.0], [0.0, 1.0, 3.0]])
    p = torch.softmax(lg.double(), 1)
    r = ENGINE.readings(lg, np.array([0, 2]),
                        p.max(1).values.float().numpy())
    assert r["argmax_gap"] == 0.0 and r["softmax_err"] < 1e-7
    r = ENGINE.readings(lg, np.array([0, 1]),
                        p.max(1).values.float().numpy())
    assert r["argmax_gap"] == pytest.approx(float(p[1, 2] - p[1, 1]))


def test_train_gap_leaves_out_silent_leaves():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-6}
    assert TRAIN.gap({"a": 1.1, "b": 2.0, "c": 1.0}, ref, ref) == \
        pytest.approx(0.1)
    assert TRAIN.gap({"a": 0.0, "b": 0.0, "c": 0.0}, ref, ref) == 1.0


def _event(name, start_us, end_us, device=None, thread=1,
           annotation=False):
    return types.SimpleNamespace(
        name=name, key=name, time_range=types.SimpleNamespace(
            start=start_us, end=end_us),
        device_type="DeviceType.CUDA" if device is not None else
        "DeviceType.CPU", device_index=device if device is not None else -1,
        thread=thread, is_user_annotation=annotation)


def test_trace_reduction():
    """The slice's host span and its copy on the device track are both
    user annotations, as torch.profiler marks a record_function."""
    ev = [_event(devtrace.SLICE, 2, 98, device=0, annotation=True),
          _event(devtrace.SLICE, 0, 100, annotation=True),
          _event("bench.call", 0, 100),
          _event("cudaStreamSynchronize", 60, 80),
          _event("void pool_lrn_ring<bf16, 96, 8>(Args)", 10, 30, device=0),
          _event("void pool_lrn_backward_ring<bf16, 96>(Args)", 20, 40,
                 device=0),
          _event("gemm", 50, 60, device=0),
          _event("gemm", 10, 90, device=1)]
    tr = devtrace.Trace(ev, [0, 1])
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy[0] == pytest.approx(40e-6)
    assert tr.busy[1] == pytest.approx(80e-6)
    assert tr.idle_pct() == pytest.approx(40.0)
    assert tr.kernel_time(["pool_lrn_ring"]) == (1, pytest.approx(20e-6))
    n, t = tr.kernel_time(["pool_lrn_backward_ring", "pool_lrn_backward_rows"])
    assert n == 1
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "gemm"
    assert bd["device_ops"][0][1] == pytest.approx(45e-6)
    labels = dict(bd["idle_gaps"])
    assert labels["cudaStreamSynchronize"] == pytest.approx(40e-6 / 2)
    assert sum(labels.values()) == pytest.approx(80e-6 / 2)
    json.dumps(bd)


def test_train_layouts_round_trip():
    for shape in ((11, 11, 3, 96), (4096, 5), (96,)):
        w = torch.randn(shape)
        assert np.array_equal(TRAIN._tf_host(TRAIN._torch_layout(w)),
                              w.numpy())


def test_reference_steps_resume_from_their_state():
    """Four reference steps are two, then two more from the weights,
    momentum and generator state the first two left: the replayed check
    starts the reference from the program's state this way."""
    from benchmark.reference import train as ref_train
    rows, batch = 8, 2
    table = specs(rows, 5)
    labels = np.arange(rows) % 5
    p0 = inputs.params(MODEL, 6, torch.device("cpu"))
    gen = torch.Generator().manual_seed(7)
    idx = [torch.randperm(rows, generator=gen)[:batch] for _ in range(4)]
    flip = [torch.tensor(s % 2 == 1) for s in range(4)]
    kw = dict(model=MODEL, learning_rate=0.005, keep_prob=0.5, clip=1.0)
    start = gen.get_state()
    whole = ref_train.steps(p0, table, labels, idx, flip, start, **kw)
    first = ref_train.steps(p0, table, labels, idx[:2], flip[:2], start,
                            **kw)
    rest = ref_train.steps(first["params"], table, labels, idx[2:], flip[2:],
                           first["gen_state"], momentum0=first["momentum"],
                           **kw)
    assert rest["losses"] == pytest.approx(whole["losses"][2:], rel=1e-5)
    for k, w in whole["params"].items():
        torch.testing.assert_close(rest["params"][k], w, rtol=1e-5, atol=1e-7)

