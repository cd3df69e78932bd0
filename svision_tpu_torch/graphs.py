"""CUDA graphs for the engine and the trainers: capture, replay, and the
kernels' launch counts.

Counterpart of the JAX package's compiled programs. Its engine dispatches a
lax.scan over `chunk` batches as one program
(svision_tpu/infer/engine.py:_device_step_many) and its trainers jit their
step (svision_tpu/models/train.py). Here a torch.cuda.CUDAGraph holds the
same work, captured once and replayed, so the host enqueues one graph where
it enqueued every kernel.

Launch counts. Each kernel wrapper (ops/raster_kernel.render_raster,
ops/fused_pool_lrn.bias_relu_pool_lrn and bias_relu_pool_lrn_backward,
ops/fused_conv1.conv1_fused_raster, ops/endpoints.specs_endpoints, and
ops/moe's moe_route, moe_dispatch, moe_bias_gelu and moe_combine) ticks
its `launches` counter in Python when it enqueues its kernel, and K2's
split forms tick fused_pool_lrn.bias_relu_pool_lrn_halves besides. A
capture ticks it though nothing runs, and a replay runs the kernels without a
tick. capture() takes back a capture's ticks and keeps how many launches
of each wrapper the graph holds, and Graph.replay() adds them, so every
counter keeps meaning "kernels executed". The engine reads them per call
(its span engine.call, trace.py).

Captures use capture_error_mode="thread_local": the engine's warm-up
captures on a thread (warmup_async) while the caller's thread goes on, and
under a global capture a CUDA call of that other thread that is illegal
during a capture (cudaHostAlloc, which pins memory) would fail it. Nothing
here falls back: a capture that fails raises.

A CUDA graph holds the work of one device's stream. A step that spans
devices (the DP x TP trainer's) is cut into pieces that each run on one
device, with the copies between devices left eager between them: Pieces
captures each piece on its own device.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Sequence, Tuple

import torch

from svision_tpu_torch import trace
from svision_tpu_torch.ops import (endpoints, fused_conv1, fused_pool_lrn,
                                   moe, raster_kernel)

# eager steps a trainer runs before it captures its step (Pieces)
WARMUP_STEPS = 3


def kernel_wrappers() -> Tuple[Callable, ...]:
    """The hand-written kernels' wrappers, each with its `launches` and
    `__name__`, and the counter of K2's calls in a split form
    (fused_pool_lrn.bias_relu_pool_lrn_halves)."""
    return (raster_kernel.render_raster, fused_pool_lrn.bias_relu_pool_lrn,
            fused_pool_lrn.bias_relu_pool_lrn_backward,
            fused_conv1.conv1_fused_raster, endpoints.specs_endpoints,
            fused_pool_lrn.bias_relu_pool_lrn_halves, moe.moe_route,
            moe.moe_dispatch, moe.moe_bias_gelu, moe.moe_combine)


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


def capture(fn: Callable, device: torch.device, *, stream=None, pool=None,
            generators: Sequence[torch.Generator] = ()) -> Graph:
    """Capture fn()'s CUDA work on device into a Graph; nothing of it runs
    until a replay. fn must read its inputs from tensors that outlive the
    graph (static buffers the caller fills before each replay). Random draws
    from `generators` (on device) advance at every replay. pool: a memory
    pool shared with graphs captured before (torch.cuda.graph_pool_handle),
    which must then replay in the order they were captured. Counted as
    graphs.captures while trace.py records."""
    trace.count("graphs.captures")
    wrappers = kernel_wrappers()
    before = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        # a generator's first registration allocates its graph-side seed
        # and offset on the current device
        for gen in generators:
            graph.register_generator_state(gen)
        if stream is None:
            stream = torch.cuda.Stream(device)
        with torch.cuda.graph(graph, pool=pool, stream=stream,
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
    recipe: a step of one piece (Pieces). The first WARMUP_STEPS calls run
    fn eagerly on a side stream: they are real steps of the run, and they
    create the optimizer's momentum buffers and settle cuDNN. The next call
    captures fn on that stream and replays it; every later call replays.
    reset() runs before each eager call and once before the capture:
    zero_grad(set_to_none=True), so the capture allocates the gradients in
    the graph's pool, where they stay.

    fn reads its inputs from static buffers that the caller fills before
    each call, and draws its random numbers from `generator`, which the
    graph advances at every replay. After the capture fn's output is static
    too: the caller copies it before the next call."""

    def __init__(self, fn: Callable, reset: Callable, device: torch.device,
                 generator: torch.Generator):
        self.fn, self.reset, self.device = fn, reset, device
        self.generator = generator
        self.pieces = Pieces(graphed=True)

    @property
    def phase(self) -> str:
        """What the next call does: 'eager', 'capture' or 'replay'."""
        steps = self.pieces.steps
        return ("eager" if steps < WARMUP_STEPS else
                "capture" if steps == WARMUP_STEPS else "replay")

    def __call__(self):
        if not self.pieces.replaying:
            self.reset()
        out = self.pieces("step", self.device, self.fn, (self.generator,))
        self.pieces.end_step()
        return out


class Pieces:
    """A step cut into pieces, each a function of one device's tensors,
    called by key in the same order at every step; what moves between
    devices is copied eagerly between the calls, into static buffers.
    A cross-device copy_ runs on the source device's current stream behind
    an event of the destination's, and the destination's current stream
    waits for it, so the pieces and the copies are ordered by CUDA events,
    never by a host sync.

    graphed=False (the CPU, or eager=True on the card) calls every piece
    as it is. graphed=True applies PyTorch's capture recipe to each piece:
    for the first WARMUP_STEPS steps a piece runs eagerly on its device's
    side stream; in the next step it is captured on that stream and
    replayed, and from then on replayed, on its device's current stream.
    The pieces of one device share the side stream and one memory pool, so
    they must replay in the order they were captured, which calling them
    in the same order every step gives. The caller ends each step with
    end_step()."""

    def __init__(self, graphed: bool):
        self.graphed = graphed
        self.steps = 0
        self.graphs: Dict[Hashable, Graph] = {}
        self.streams: Dict[torch.device, torch.cuda.Stream] = {}
        self.pools: Dict[torch.device, tuple] = {}

    @property
    def replaying(self) -> bool:
        """Every piece has been captured: this step replays them all."""
        return self.graphed and self.steps > WARMUP_STEPS

    def __call__(self, key: Hashable, device: torch.device, fn: Callable,
                 generators: Sequence[torch.Generator] = ()):
        """fn()'s outputs (static once captured: the caller copies what it
        keeps). Random draws from `generators` advance at every replay."""
        if not self.graphed:
            return fn()
        graph = self.graphs.get(key)
        if graph is None:
            if device not in self.streams:
                self.streams[device] = torch.cuda.Stream(device)
                with torch.cuda.device(device):
                    self.pools[device] = torch.cuda.graph_pool_handle()
            stream = self.streams[device]
            if self.steps < WARMUP_STEPS:
                current = torch.cuda.current_stream(device)
                stream.wait_stream(current)
                with torch.cuda.device(device), torch.cuda.stream(stream):
                    out = fn()
                current.wait_stream(stream)
                return out
            graph = self.graphs[key] = capture(
                fn, device, stream=stream, pool=self.pools[device],
                generators=generators)
        return graph.replay()

    def end_step(self) -> None:
        self.steps += 1
