"""Device inference: candidate specs -> (argmax, max softmax), in PyTorch.

Counterpart of the JAX package's infer/engine.py. Per fixed-size batch the
device runs raster -> AlexNet -> (argmax, softmax), and only two small
vectors come back to the host. The CLI runs two numeric modes:

  * bf16 fast path (default): the fused raster+conv1 kernel
    (ops/fused_conv1.py) reads the endpoints and the folded conv1 weights
    and writes conv1's pre-activation; the bias/ReLU/pool/LRN kernel
    (ops/fused_pool_lrn.py) follows conv1 and conv2; the rest is torch.
  * exact f32 (bf16=False, the CLI's --exact): on the card the fused
    kernel in f32 writes conv1's pre-activation into the folded network
    (fused_logits); on the CPU the raster kernel's plain version
    (ops/raster_kernel.py) renders the images into the unfolded network
    and conv1 runs through F.conv2d, the JAX package's --exact form. conv2
    runs through F.conv2d; conv1 and conv2 are each followed by the
    bias/ReLU/pool/LRN kernel; TF32 is off.

The JAX engine's other modes are here too, with its rules:
  * raster= picks the fast path's encoder: 's2d' (the fused kernel above,
    the default), or a {0,1} raster in bf16 -- 'compare'
    (rasterize.render_raster), 'einsum' (rasterize.render_raster_einsum)
    or 'pallas' (the raster kernel) -- into the folded network
    (AlexNet.forward_raster). The four rasters are the same bits.
  * int8=True (with bf16 and fast) runs the int8 network
    (models/int8.py) on the raster; 's2d' then becomes 'compare', since
    the fused kernel feeds no int8 network.
  * fast=False (with bf16) renders f32 images with the raster kernel into
    the unfolded network with bf16 weights.

A call is dispatched by the JAX engine's chunked plan (InferenceEngine.plan:
`chunk` batches a dispatch, then a tail by the `tail` policy). On the card
each dispatch shape (c batches, or one) is a CUDA graph per replica
(graphs.py), captured once and replayed; on the CPU the same plan runs
eagerly, batch by batch. A dispatch ships its raw specs: each replica's
step starts with their endpoints (ops/endpoints.py, a kernel on the card),
so the host thread only lays the rows out.

The network is read from the weights: AlexNet's leaves build the routes
above, a ViT's (models/vit.py, whose leaves start with vit/) build a
replica that renders K1's raster in the compute dtype (the kernel on the
card, its plain version on the CPU) into the ViT, in bf16 or, under
bf16=False, in f32 with TF32 off. The other modes are AlexNet's: int8,
fast=False and the rasters other than 's2d' raise for ViT weights. A
V-MoE's leaves (a ViT's with routers) build the same replica with its
sparse layers (ops/moe.py: kernels on the card, in bf16 only, so that
bf16=False raises there; their plain versions on the CPU, in either
precision); each replica keeps a histogram of the rows each expert took,
which expert_rows() reads.

The region aggregation that follows prediction is host code and lives in
infer/aggregate.py, so workers that run it never import torch.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from svision_tpu_torch import graphs, trace
from svision_tpu_torch.device import resolve_device
from svision_tpu_torch.models.alexnet import (AlexNet, cast_params_bf16,
                                              fold_conv1_params,
                                              fold_params_bf16)
from svision_tpu_torch.models.int8 import AlexNetInt8, quantize_params_int8
from svision_tpu_torch.models import vit
from svision_tpu_torch.ops import rasterize
from svision_tpu_torch.ops.endpoints import FIELDS, specs_endpoints
from svision_tpu_torch.ops.fused_conv1 import conv1_fused_raster
from svision_tpu_torch.ops.raster_kernel import render_images
from svision_tpu_torch.ops.raster_kernel import render_raster as render_raster_kernel

__all__ = ["CHUNK", "RASTERS", "TAIL", "InferenceEngine", "exact_f32",
           "fused_logits", "resolve_device"]

# Defaults of the dispatch plan on the card; PERF.md says how they were
# chosen.
CHUNK = 8
TAIL = "full"
# the fast path's raster encoders (raster=)
RASTERS = ("s2d", "compare", "einsum", "pallas")


@contextlib.contextmanager
def exact_f32():
    """f32 convolutions and matmuls without TF32: cuDNN's allow_tf32
    defaults to True, cuBLAS's matmul flag to False; both are pinned off
    here and restored after. (torch.backends.cudnn.flags would also switch
    cuDNN itself off, its `enabled` argument defaulting to False.)"""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fused_logits(model: AlexNet, w_s2d: torch.Tensor, ep: torch.Tensor,
                 vis: torch.Tensor, rev: torch.Tensor) -> torch.Tensor:
    """Logits f32 [N,5] of the folded network (AlexNet with s2d=True)
    straight from the endpoints: the fused raster+conv1 kernel with the
    folded conv1 weights w_s2d [3,3,48,96], then forward_conv1, which adds
    the folded bias. The fast path's step in bf16; in f32, under
    exact_f32(), the exact engine's step on the card. The CPU's exact
    engine keeps the unfolded network instead
    (InferenceEngine._replicas_for). CPU tensors take the kernels' plain
    versions."""
    return model.forward_conv1(conv1_fused_raster(ep, vis, rev, w_s2d))


class InferenceEngine:
    """Batched raster + CNN forward with a fixed batch shape.

    predict_specs(specs[N,12]) -> (int64[N] argmax, f32[N] max softmax).
    A call is dispatched by plan(N), the JAX engine's plan
    (svision_tpu/infer/engine.py:252-353): up to one batch goes out alone;
    more go out as dispatches of `chunk` batches and then a tail, which
    under tail='full' goes out as single batches when it is at most 16
    batches long and is padded to a full chunk otherwise, and under
    tail='pow2' as the smallest covering power of 2 batches.

    On the card each replica keeps one CUDA graph per dispatch shape (c
    batches, or one) that reads a static input buffer of raw specs and
    makes their endpoints first: a dispatch copies its rows from pinned
    host memory into it, replays, and copies the static outputs into the
    call's outputs before the next replay. warmup()
    captures the shapes a 'full' plan uses; a 'pow2' tail shape is
    captured when a plan first needs it. On the CPU the same plan runs
    eagerly, batch by batch. Either way the call synchronizes once per
    device, when the results come back. The eager path on the card
    (_predict(..., graphed=False)) is the reference the graphs are held to;
    nothing selects it.

    devices=(d0, d1, ...) makes the engine data-parallel: one model replica
    per device, each taking whole batches of batch_size rows. The engine's
    batch_size becomes batch_size x devices, so a round of the plan gives
    device d the one-device engine's batches d, d + devices, ..., and the
    rows come back in order. Every replica thus runs the one-device
    engine's batch shape and the same rows in each batch: the output is
    that of one device, bit for bit where the kernels are deterministic
    (an int8 activation's scale, the max over its batch, included), and a
    card keeps its kernels at the batch they are sized for. Without
    devices the engine runs on `device`.

    bf16, fast, raster and int8 select the numeric mode as the JAX engine's
    arguments do (module docstring); int8, fast, raster and compute_dtype
    (torch.int8, bfloat16 or float32) say which one it runs. network
    ('alexnet', 'vit_b16' or 'vmoe_b16') says which network the weights
    hold."""

    _SENTINEL = np.array([[0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2]],
                         dtype=np.int64)   # create_batch.py:55
    # tails up to this many batches go out as single batches under 'full'
    _TAIL_SINGLE_MAX = 16

    def __init__(self, params, batch_size: int = 128, bf16: bool = True,
                 chunk: Optional[int] = None, tail: Optional[str] = None,
                 device=None, devices=None, fast: bool = True,
                 raster: str = "s2d", int8: bool = False):
        if raster not in RASTERS:
            raise ValueError(f"raster {raster!r} is not one of {RASTERS}")
        self.network = ("vmoe_b16" if vit.is_vmoe(params) else
                        "vit_b16" if vit.is_vit(params) else "alexnet")
        if self.network != "alexnet" and (int8 or not fast
                                          or raster != "s2d"):
            raise ValueError(
                "int8, fast=False and raster other than 's2d' are AlexNet's "
                f"modes; these are {self.network} weights (int8={int8}, "
                f"fast={fast}, raster={raster!r})")
        self.devices = tuple(resolve_device(d)
                             for d in (devices if devices else (device,)))
        self.device = self.devices[0]
        nd = len(self.devices)
        self.bf16 = bf16
        self.int8 = int8 and bf16 and fast
        self.fast = fast and bf16
        # the fused kernel feeds no int8 network: the same raster in image
        # layout does, visibly here
        self.raster = "compare" if self.int8 and raster == "s2d" else raster
        self.compute_dtype = (torch.int8 if self.int8 else
                              torch.bfloat16 if bf16 else torch.float32)
        self.batch_size = batch_size * nd   # whole batches a replica
        self.chunk = CHUNK if chunk is None else int(chunk)
        self.tail = TAIL if tail is None else tail
        if self.chunk < 1 or self.tail not in ("full", "pow2"):
            raise ValueError(f"chunk {self.chunk} must be >= 1 and tail "
                             f"{self.tail!r} 'full' or 'pow2'")
        self._replicas = self._replicas_for(params, self.device.type)
        # (replica, batches) -> (static inputs, graphs.Graph)
        self._graphs: Dict[Tuple[int, int], tuple] = {}
        self._warm = False
        # one call at a time (warmup_async); warmup() runs under it too
        self._lock = threading.RLock()

    def _replicas_for(self, params, device_type: str) -> list:
        """One replica per device of the engine, (model, folded conv1
        weights HWIO for the fused kernel, or None), as a device of
        device_type ('cuda', 'cpu') runs the mode. The route is chosen here
        alone: the fused kernel into the folded network (fused_logits) for
        the fast path with raster 's2d', and for the exact engine on the
        card; the exact engine on any other device keeps the unfolded
        network on K1's images, the JAX package's --exact form. ViT
        weights build the ViT with its normalisation folded in
        (vit.fold_params), in the compute dtype, on K1's raster; V-MoE
        weights likewise, but in f32 only off the card: the MoE's kernels
        and the grouped products take bf16."""
        if (self.network == "vmoe_b16" and not self.bf16
                and device_type == "cuda"):
            raise ValueError("V-MoE weights run in bf16 on the card: the "
                             "MoE kernels and torch._grouped_mm take bf16 "
                             "alone, so bf16=False (--exact) runs on the CPU "
                             "only")
        host = {k: np.asarray(v) for k, v in params.items()}
        if self.network != "alexnet":
            host = vit.cast_params(vit.fold_params(host), self.compute_dtype)
            return [(vit.VisionTransformer.from_params(host, device=dev), None)
                    for dev in self.devices]
        fused = (self.raster == "s2d" if self.fast
                 else not self.bf16 and device_type == "cuda")
        if self.int8:
            host = quantize_params_int8(fold_conv1_params(host))
        elif self.fast:
            # fold + pre-cast once on the host: half the transfer, bit-equal
            # weights (fold_params_bf16)
            host = fold_params_bf16(host)
        elif fused:
            host = fold_conv1_params(host)
        elif self.bf16:
            host = cast_params_bf16(host)
        replicas = []
        for dev in self.devices:
            if self.int8:
                model = AlexNetInt8.from_params(host, device=dev)
            else:
                model = AlexNet.from_params(host, s2d=self.fast or fused,
                                            device=dev)
            replicas.append((model, model.conv1_weight_hwio()
                             if fused else None))
        return replicas

    def plan(self, n: int) -> Tuple[List[int], int]:
        """(chunk sizes, single batches): the dispatches of a call of n
        specs, in order, the chunks first. The same as the JAX engine's for
        the same batch size, chunk and tail."""
        bs = self.batch_size
        if n == 0:
            return [], 0
        if n <= bs:
            return [], 1
        chunks: List[int] = []
        remaining = -(-n // bs)            # batches needed
        while remaining >= self.chunk:
            chunks.append(self.chunk)
            remaining -= self.chunk
        singles = 0
        if remaining:
            if self.tail == "full":
                if remaining <= self._TAIL_SINGLE_MAX:
                    singles = remaining
                else:
                    chunks.append(self.chunk)
            else:
                c = 1
                while c < remaining:
                    c *= 2
                chunks.append(min(c, self.chunk))
        return chunks, singles

    @torch.inference_mode()
    def warmup(self) -> None:
        """Ready the engine for the first real call. One eager sentinel
        batch builds the kernels, sets K2's shared-memory attribute (which
        must not first happen inside a capture) and settles cuDNN. On the
        card the single-batch graph is then captured and replayed once, and
        under tail='full' the full-chunk graph too."""
        with self._lock:
            self._predict(self._SENTINEL, graphed=False)
            if self.device.type != "cuda":
                return
            self._warm = True
            self._predict(self._SENTINEL, graphed=True)
            if self.tail == "full" and self.chunk > 1:
                self._predict(np.repeat(self._SENTINEL,
                                        self.batch_size * self.chunk, 0),
                              graphed=True)

    def warmup_async(self) -> threading.Thread:
        """Start warmup() on a daemon thread; returns the thread (join it
        before the first real predict call)."""
        t = threading.Thread(target=self.warmup, name="engine-warmup",
                             daemon=True)
        t.start()
        return t

    def _logits(self, model, w_s2d, ep, vis, rev) -> torch.Tensor:
        """One replica's logits of a batch's endpoints. A replica that keeps
        w_s2d (_replicas_for) runs the fused route; a ViT or V-MoE replica
        reads K1's raster."""
        if self.network != "alexnet":
            return model(render_raster_kernel(ep, vis, rev,
                                              dtype=model.compute_dtype))
        if w_s2d is not None:
            return fused_logits(model, w_s2d, ep, vis, rev)
        if not self.fast:
            return model(render_images(ep, vis, rev, dtype=torch.float32))
        if self.raster == "pallas":
            raster = render_raster_kernel(ep, vis, rev, dtype=torch.bfloat16)
        elif self.raster == "einsum":
            raster = rasterize.render_raster_einsum(ep, vis, rev)
        else:
            raster = rasterize.render_raster(ep, vis, rev)
        return model.forward_raster(raster)

    def _step(self, model, w_s2d, ep, vis, rev
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One replica's batch (batch_size // devices rows) on its device ->
        (argmax, max softmax)."""
        logits = self._logits(model, w_s2d, ep, vis, rev)
        # soft[argmax] == max(soft): softmax is monotone
        return logits.argmax(dim=1), torch.softmax(logits, dim=1).amax(dim=1)

    def _run(self, d: int, specs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Replica d's step over each of its batches in the rows of specs
        (int64 [rows,12] on its device), eagerly (or under a capture): the
        rows' endpoints in one launch, then _step a batch -> (argmax, max
        softmax) over all rows."""
        model, w_s2d = self._replicas[d]
        sub = self.batch_size // len(self.devices)
        ep, vis, rev = specs_endpoints(specs)
        preds, softs = [], []
        for i in range(0, ep.shape[0], sub):
            p, s = self._step(model, w_s2d, ep[i:i + sub], vis[i:i + sub],
                              rev[i:i + sub])
            preds.append(p)
            softs.append(s.float())
        return torch.cat(preds), torch.cat(softs)

    def _graph(self, d: int, batches: int):
        """Replica d's graph of `batches` batches and its static input (the
        raw specs), captured at first need."""
        key = (d, batches)
        if key not in self._graphs:
            dev = self.devices[d]
            rows = batches * (self.batch_size // len(self.devices))
            with trace.span("engine.capture") as sp:
                sp.set(card=d, batches=batches, network=self.network)
                inputs = (torch.zeros((rows, FIELDS), dtype=torch.int64,
                                      device=dev),)
                self._graphs[key] = (inputs, graphs.capture(
                    lambda: self._run(d, *inputs), dev))
        return self._graphs[key]

    @torch.inference_mode()
    def predict_specs(self, specs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """specs [N,12] -> (pred_ids int64 [N], softmax_sel f32 [N])."""
        graphed = self.device.type == "cuda"
        with self._lock:
            if graphed and not self._warm:
                self.warmup()
            return self._predict(np.asarray(specs), graphed)

    def expert_rows(self) -> Optional[np.ndarray]:
        """A V-MoE's rows each expert took in each sparse layer since the
        last call (every batch's, the sentinel padding and warm-up's
        included), int64 [sparse layers, experts] summed over the replicas,
        then zeroed; counted, while trace.py records, as the counters
        moe.expert_rows/<layer>/<expert> (the network's layer index). None
        for another network. It waits for the cards: call it between
        calls, never inside one."""
        if self.network != "vmoe_b16":
            return None
        with self._lock:
            out = 0
            for model, _ in self._replicas:
                out = out + model.expert_rows.cpu().numpy()
                model.expert_rows.zero_()
        layers = self._replicas[0][0].widths.moe_layers
        for layer, row in zip(layers, out):
            for e, n in enumerate(row.tolist()):
                trace.count(f"moe.expert_rows/{layer}/{e}", n)
        return out

    @torch.inference_mode()
    def expert_choices(self, specs: np.ndarray) -> Optional[List[np.ndarray]]:
        """A V-MoE's routing of specs [N,12]: for each sparse layer, int32
        [N, tokens, k], the experts each token of each image takes, from an
        eager pass of the first replica's network over specs in its batches
        (an image's routing does not depend on its batchmates; the graphs
        give the eager step's bits). The pass runs the network's logits
        alone (_logits), not the step that answers a call, so that it
        reads the routing of a step that answers wrongly too. None for
        another network, or when the network routed another number of
        tokens than the specs hold."""
        if self.network != "vmoe_b16":
            return None
        n = specs.shape[0]
        sub = self.batch_size // len(self.devices)
        model = self._replicas[0][0]
        padded = np.concatenate([np.asarray(specs, np.int64), np.repeat(
            self._SENTINEL, -n % sub, 0)])
        kept = []
        with self._lock:
            model.keep_routing(kept)
            try:
                for i in range(0, len(padded), sub):
                    self._logits(model, None, *specs_endpoints(
                        torch.from_numpy(padded[i:i + sub]).to(self.device)))
            finally:
                model.keep_routing(None)
        w = model.widths
        layers = len(w.moe_layers)
        out = [torch.cat(kept[j::layers]).cpu().numpy()
               for j in range(layers)]
        if any(r.shape != (len(padded) * w.tokens, w.top_k) for r in out):
            return None
        return [r.reshape(len(padded), w.tokens, w.top_k)[:n] for r in out]

    def _host_rows(self, specs: np.ndarray, batches: int) -> List[torch.Tensor]:
        """One dispatch's raw specs, int64 [devices, batches x rows a
        replica, 12], device d's batch of every round contiguous in [d];
        pinned for the card. A list of the tensors a dispatch copies."""
        nd = len(self.devices)
        sub = self.batch_size // nd
        rows = np.asarray(specs, np.int64).reshape(
            batches, nd, sub, FIELDS).swapaxes(0, 1)
        # one numpy copy, straight into the pinned buffer: torch's copy
        # (Tensor.pin_memory) splits one of more than 32,768 values over
        # its thread pool, which took milliseconds a dispatch on a busy host
        host = torch.empty((nd, batches * sub, FIELDS), dtype=torch.int64,
                           pin_memory=self.device.type == "cuda")
        host.numpy().reshape(rows.shape)[...] = rows
        return [host]

    def _predict(self, specs: np.ndarray, graphed: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """specs through plan(N): replays of each replica's graphs when
        graphed, else the eager step. Each dispatch's specs are laid out
        and pinned on the host while the device runs the one before; their
        endpoints are made on the device, at the head of its step. Traced
        as the span engine.call (trace.py), with the rows, the padded rows,
        the dispatches, the network, a ViT's tokens (padded rows x tokens
        an image), a V-MoE's experts, top_k, moe_layers and routed_rows
        (padded rows x tokens x k x sparse layers), the grouped layers the
        network runs split (AlexNet.split_groups; none in a ViT) and each
        kernel wrapper's launches during the call."""
        n = specs.shape[0]
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        with trace.span("engine.call") as call:
            wrappers = graphs.kernel_wrappers()
            before = [w.launches for w in wrappers]
            chunks, singles = self.plan(n)
            sizes = chunks + [1] * singles
            out = self._dispatch(specs, sizes, graphed)
            if call:
                total = sum(sizes) * self.batch_size
                model = self._replicas[0][0]
                if self.network != "alexnet":
                    call.set(tokens=total * model.tokens)
                if self.network == "vmoe_b16":
                    w = model.widths
                    call.set(experts=w.experts, top_k=w.top_k,
                             moe_layers=list(w.moe_layers),
                             routed_rows=total * model.tokens * w.top_k
                             * len(w.moe_layers))
                call.set(rows=n, padded_rows=total, dispatches=len(sizes),
                         graphed=graphed, network=self.network,
                         split_groups=model.split_groups,
                         launches={
                             w.__name__: w.launches - b
                             for w, b in zip(wrappers, before)})
        return out

    def _dispatch(self, specs: np.ndarray, sizes: List[int], graphed: bool
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """_predict's work: the specs padded to sum(sizes) batches, one
        dispatch of c batches per c in sizes, then the results gathered
        back in the specs' order."""
        n = specs.shape[0]
        bs, nd, total = self.batch_size, len(self.devices), sum(sizes)
        sub = bs // nd                       # a replica's batch
        with trace.span("engine.pad"):
            specs = np.concatenate(
                [specs, np.repeat(self._SENTINEL, total * bs - n, 0)], 0)
        with (exact_f32() if not self.bf16 else contextlib.nullcontext()):
            # device d holds rows [i*bs + d*sub, i*bs + (d+1)*sub) of each
            # round i: the one-device engine's batch i*nd + d
            outs = [(torch.empty(total * sub, dtype=torch.int64, device=dev),
                     torch.empty(total * sub, dtype=torch.float32, device=dev))
                    for dev in self.devices]
            b = 0
            for c in sizes:
                with trace.span("engine.host_rows") as sp:
                    host = self._host_rows(specs[b * bs:(b + c) * bs], c)
                    sp.set(rows=c * bs)
                rows = slice(b * sub, (b + c) * sub)
                for d, dev in enumerate(self.devices):
                    with trace.span("engine.dispatch") as sp, \
                            trace.device_span("engine.dispatch", dev):
                        sp.set(card=d, batches=c, rows=c * sub)
                        if graphed:
                            inputs, graph = self._graph(d, c)
                            for buf, x in zip(inputs, host):
                                buf.copy_(x[d], non_blocking=True)
                            p, s = graph.replay()
                        else:
                            p, s = self._run(d, *(x[d].to(dev,
                                                          non_blocking=True)
                                                  for x in host))
                        outs[d][0][rows].copy_(p)
                        outs[d][1][rows].copy_(s)
                b += c
            # the call's one synchronization per device
            with trace.span("engine.sync"):
                outs = [(p.cpu(), s.cpu()) for p, s in outs]
        # [device, round, row] -> [round, device, row]: the specs' order
        with trace.span("engine.unshard"):
            preds, softs = (torch.stack(o).reshape(nd, -1, sub)
                            .transpose(0, 1).reshape(-1) for o in zip(*outs))
            return preds.numpy()[:n], softs.numpy()[:n]
