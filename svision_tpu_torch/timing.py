"""Timing helpers of the port's tools: device times with CUDA events
behind a held queue, CUDA-graph replays, the random and densely lit specs
they run on, and the card's nvidia-smi line. How much work a kernel does,
the card's peaks and the device's busy time in a profile are the
benchmark's (benchmark/work.py, benchmark/devtrace.py); the tools read
them there.

chip_smoke.py and the scripts/torch_*.py tools import these from here. torch
is imported where it is used: chip_smoke.py imports this module at its top,
and the spawned collection workers of the CLI runs it makes (-t N) import
chip_smoke.py again as their main module, so they stay light.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np


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


def diagonal_specs(n, seed=0):
    """Densely lit candidate specs [n,12]: both segments long diagonals
    across the canvas, the second on the reverse strand, each image offset
    by a few pixels. Every column then holds two lit rows, so channels 0
    and 1 are lit along both lines and channel 2 along the second: 3-4x
    the lit share of random_specs' s2d raster."""
    rng = np.random.RandomState(seed)
    specs = np.zeros((n, 12), dtype=np.int64)
    o1, o2 = rng.randint(0, 31, n), rng.randint(0, 31, n)
    # segment 1 forward, rows o1..226; segment 2 reverse, rows 226-o2..0
    specs[:, 0], specs[:, 3], specs[:, 4] = o1, 227 - o1, 1
    specs[:, 1] = specs[:, 0] + specs[:, 3]
    specs[:, 5], specs[:, 8], specs[:, 9] = 226 - o2, 227 - o2, 0
    specs[:, 10] = specs[:, 11] = 227
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
    import torch
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
    import torch
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
    import torch
    from svision_tpu_torch import graphs
    fn()
    torch.cuda.synchronize(device)
    graph = graphs.capture(fn, device)
    with torch.cuda.device(device):
        return min(time_ms(graph.replay, reps) for _ in range(best_of))

