"""Timing helpers of the port's harness and tools: device times with CUDA
events behind a held queue, CUDA-graph replays, torch.profiler device
time, the benchmark's random specs, and the card's nvidia-smi line.

chip_smoke.py, bench_torch.py and the scripts/torch_*.py tools import them
from here, so none of them is a library of another.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np
import torch


def random_specs(n, seed=0):
    """Candidate specs [n,12] with mixed scales and strands (bench.py's
    random_specs)."""
    rng = np.random.RandomState(seed)
    specs = np.zeros((n, 12), dtype=np.int64)
    scale = rng.choice([1, 2, 8, 40], size=n)
    read_len = (227 * scale * rng.uniform(0.5, 1.0, n)).astype(np.int64) + 100
    ref_len = (227 * scale * rng.uniform(0.5, 1.0, n)).astype(np.int64) + 100
    for k, base in ((0, read_len), (5, read_len)):
        specs[:, k] = rng.randint(0, 1000, n) % np.maximum(base // 2, 1)
    for k, base in ((2, ref_len), (7, ref_len)):
        lo = rng.randint(0, 1000, n) % np.maximum(base // 2, 1)
        specs[:, k] = lo
        specs[:, k + 1] = lo + np.maximum(
            (base * rng.uniform(0.2, 0.9, n)).astype(np.int64), 2)
    specs[:, 4] = 1
    specs[:, 9] = rng.randint(0, 2, n)
    specs[:, 10] = read_len
    specs[:, 11] = ref_len
    return specs


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def device_label(device):
    """nvidia-smi's line on the card, "cpu" on the CPU."""
    return "cpu" if device.type == "cpu" else nvidia_smi()


@contextlib.contextmanager
def held_queue(sleep_cycles: int = 500_000_000):
    """Enqueue the block's work behind a device sleep. A kernel shorter
    than the host's time to enqueue it would otherwise find the queue
    empty, and its events would time the host. Fails if the host took
    longer to enqueue than the device slept. Yields a dict that gets
    host_ms, the time the host took to enqueue."""
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(sleep_cycles)
    b.record()
    info = {}
    t0 = time.perf_counter()
    yield info
    info["host_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    slept = a.elapsed_time(b)
    assert info["host_ms"] < slept, (
        f"the host enqueued for {info['host_ms']:.1f} ms, longer than the "
        f"device slept ({slept:.1f} ms): the times would include host gaps")


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() in ms over reps launches run back to back
    (CUDA events, the queue held), after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with held_queue():
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    return start.elapsed_time(end) / reps


def graph_ms(fn, device, reps: int = 20, best_of: int = 3) -> float:
    """Time of fn()'s work in ms: on the card captured once as a CUDA graph
    (after one eager call, which builds and loads what it needs) and timed
    by time_ms over reps replays, the least of best_of such runs; on the
    CPU the least host-clock mean of best_of runs of reps eager calls.
    fn must read its inputs from tensors that outlive the call."""
    if device.type != "cuda":
        fn()
        best = float("inf")
        for _ in range(best_of):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, (time.perf_counter() - t0) / reps * 1e3)
        return best
    from svision_tpu_torch import graphs
    fn()
    torch.cuda.synchronize(device)
    graph = graphs.capture(fn, device)
    with torch.cuda.device(device):
        return min(time_ms(graph.replay, reps) for _ in range(best_of))


def on_device(e) -> bool:
    """A profiler event that is a kernel or copy on the device. A user
    annotation's span on the device track (Optimizer.step#SGD.step) is
    none; a kernel whose name holds a lambda (torch's elementwise and copy
    kernels: "...::{lambda()#1}...") is one."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and ("#" not in e.key or "{lambda(" in e.key))


def device_time(prof, wall_ms: float, what: str):
    """({kernel: device ms}, device busy ms) of a torch.profiler run: busy
    is the union of the traced kernels' and copies' intervals (copies
    overlap kernels, so the sum of their times may exceed the wall)."""
    per_kernel = {}
    for e in prof.key_averages():
        if not on_device(e):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if on_device(e))
    assert spans, f"{what}: no device activity traced"
    busy_us, last = 0.0, float("-inf")
    for start, end in spans:
        if end > last:
            busy_us += end - max(start, last)
            last = end
    busy_ms = busy_us / 1e3
    assert busy_ms <= wall_ms, (
        f"{what}: {busy_ms} ms on the device > {wall_ms} ms wall")
    return per_kernel, busy_ms
