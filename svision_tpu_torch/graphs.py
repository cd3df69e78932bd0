"""CUDA graphs for the engine and the trainers: capture, replay, and the
kernels' launch counts.

Counterpart of the JAX package's compiled programs. Its engine dispatches a
lax.scan over `chunk` batches as one program
(svision_tpu/infer/engine.py:_device_step_many) and its trainers jit their
step (svision_tpu/models/train.py). Here a torch.cuda.CUDAGraph holds the
same work, captured once and replayed, so the host enqueues one graph where
it enqueued every kernel.

Launch counts. Each kernel wrapper (ops/raster_kernel.render_raster,
ops/fused_pool_lrn.bias_relu_pool_lrn, ops/fused_conv1.conv1_fused_raster)
ticks its `launches` counter in Python when it enqueues its kernel. A
capture ticks it though nothing runs, and a replay runs the kernels without
a tick. capture() takes back a capture's ticks and keeps how many launches
of each wrapper the graph holds, and Graph.replay() adds them, so every
counter keeps meaning "kernels executed".

Captures use capture_error_mode="thread_local": the engine's warm-up
captures on a thread (warmup_async) while the caller's thread goes on, and
under a global capture a CUDA call of that other thread that is illegal
during a capture (cudaHostAlloc, which pins memory) would fail it. Nothing
here falls back: a capture that fails raises.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from svision_tpu_torch.ops import fused_conv1, fused_pool_lrn, raster_kernel

# eager steps a trainer runs before it captures its step (StepGraph)
WARMUP_STEPS = 3


def kernel_wrappers() -> Tuple[Callable, ...]:
    """The hand-written kernels' wrappers, each with its `launches`."""
    return (raster_kernel.render_raster, fused_pool_lrn.bias_relu_pool_lrn,
            fused_conv1.conv1_fused_raster)


class Graph:
    """A captured CUDA graph, the outputs of its capture (static: every
    replay rewrites them in place) and the launches of each kernel wrapper
    it holds."""

    def __init__(self, graph, outputs, launches):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches

    def replay(self):
        """Run the graph on the current stream; returns its outputs."""
        self.graph.replay()
        for wrapper, k in self.launches:
            wrapper.launches += k
        return self.outputs


def capture(fn: Callable, device: torch.device, *, stream=None,
            generators: Sequence[torch.Generator] = ()) -> Graph:
    """Capture fn()'s CUDA work on device into a Graph; nothing of it runs
    until a replay. fn must read its inputs from tensors that outlive the
    graph (static buffers the caller fills before each replay). Random draws
    from `generators` advance at every replay."""
    wrappers = kernel_wrappers()
    before = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.device(device):
        if stream is None:
            stream = torch.cuda.Stream(device)
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            outputs = fn()
    launches = []
    for wrapper, b in zip(wrappers, before):
        k = wrapper.launches - b
        wrapper.launches -= k
        if k:
            launches.append((wrapper, k))
    return Graph(graph, outputs, tuple(launches))


class StepGraph:
    """A training step as a CUDA graph, by PyTorch's whole-network capture
    recipe. The first WARMUP_STEPS calls run fn eagerly on a side stream: they
    are real steps of the run, and they create the optimizer's momentum
    buffers and settle cuDNN. The next call captures fn on that stream and
    replays it; every later call replays. reset() runs before each eager
    call and once before the capture: zero_grad(set_to_none=True), so the
    capture allocates the gradients in the graph's pool, where they stay.

    fn reads its inputs from static buffers that the caller fills before
    each call, and draws its random numbers from `generator`, which the
    graph advances at every replay. After the capture fn's output is static
    too: the caller copies it before the next call."""

    def __init__(self, fn: Callable, reset: Callable, device: torch.device,
                 generator: torch.Generator):
        self.fn, self.reset, self.device = fn, reset, device
        self.generator = generator
        self.eager_calls = 0
        self.graph = None
        self.stream = torch.cuda.Stream(device)

    def __call__(self):
        if self.graph is None:
            self.reset()
            if self.eager_calls < WARMUP_STEPS:
                self.eager_calls += 1
                current = torch.cuda.current_stream(self.device)
                self.stream.wait_stream(current)
                with torch.cuda.stream(self.stream):
                    out = self.fn()
                current.wait_stream(self.stream)
                return out
            self.graph = capture(self.fn, self.device, stream=self.stream,
                                 generators=(self.generator,))
        return self.graph.replay()
