"""Device inference: candidate specs -> (argmax, max softmax), in PyTorch.

Counterpart of the JAX package's infer/engine.py. Per fixed-size batch the
device runs raster -> AlexNet -> (argmax, softmax), and only two small
vectors come back to the host. Two numeric modes:

  * bf16 fast path (default): the fused raster+conv1 kernel
    (ops/fused_conv1.py) reads the endpoints and the folded conv1 weights
    and writes conv1's pre-activation; the bias/ReLU/pool/LRN kernel
    (ops/fused_pool_lrn.py) follows conv1 and conv2; the rest is torch.
  * exact f32 (bf16=False, the CLI's --exact): the raster kernel
    (ops/raster_kernel.py) renders the images, conv1 and conv2 run through
    F.conv2d, each followed by the bias/ReLU/pool/LRN kernel; TF32 is off.

The region aggregation that follows prediction is host code and lives in
infer/aggregate.py, so workers that run it never import torch.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from svision_tpu_torch.models.alexnet import AlexNet, fold_params_bf16
from svision_tpu_torch.ops import rasterize
from svision_tpu_torch.ops.fused_conv1 import conv1_fused_raster
from svision_tpu_torch.ops.raster_kernel import render_images


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA device. Raises when CUDA is asked for (or
    implied) and no GPU is present: the port never carries on on the CPU
    unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


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


class InferenceEngine:
    """Batched raster + CNN forward with a fixed batch shape.

    predict_specs(specs[N,12]) -> (int64[N] argmax, f32[N] max softmax).
    Every batch of a call is queued on each device's current stream from
    pinned host memory, and the call synchronizes once per device, when the
    results come back.

    devices=(d0, d1, ...) makes the engine data-parallel, as a mesh does the
    JAX package's: one model replica per device, each batch's rows split
    evenly across the devices (the batch size rounds up to a multiple of
    their count), and the rows come back in order. Without it the engine
    runs on `device`."""

    _SENTINEL = np.array([[0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2]],
                         dtype=np.int64)   # create_batch.py:55

    def __init__(self, params, batch_size: int = 128, bf16: bool = True,
                 device=None, devices=None):
        self.devices = tuple(resolve_device(d)
                             for d in (devices if devices else (device,)))
        self.device = self.devices[0]
        nd = len(self.devices)
        self.batch_size = -(-batch_size // nd) * nd   # equal shards
        self.bf16 = bf16
        host = {k: np.asarray(v) for k, v in params.items()}
        if bf16:
            # fold + pre-cast once on the host: half the transfer, bit-equal
            # weights (fold_params_bf16)
            host = fold_params_bf16(host)
        # one replica per device: (model, conv1 weights for the fused kernel)
        self._replicas = []
        for dev in self.devices:
            model = AlexNet.from_params(host, s2d=bf16, device=dev)
            self._replicas.append(
                (model, model.conv1_weight_hwio() if bf16 else None))
        self._lock = threading.Lock()   # one predict at a time (warmup_async)

    def _pad(self, specs: np.ndarray, multiple: int) -> np.ndarray:
        pad = (-specs.shape[0]) % multiple
        if pad:
            specs = np.concatenate(
                [specs, np.repeat(self._SENTINEL, pad, 0)], 0)
        return specs

    def warmup(self) -> None:
        """Build the kernels and run one sentinel batch, so the first real
        call pays no build or cuDNN set-up."""
        self.predict_specs(np.repeat(self._SENTINEL, 1, 0))

    def warmup_async(self) -> threading.Thread:
        """Start warmup() on a daemon thread; returns the thread (join it
        before the first real predict call)."""
        t = threading.Thread(target=self.warmup, name="engine-warmup",
                             daemon=True)
        t.start()
        return t

    def _step(self, model, w_s2d, ep, vis, rev
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One batch (or one device's share of it) on the device ->
        (argmax, max softmax)."""
        if self.bf16:
            pre = conv1_fused_raster(ep, vis, rev, w_s2d)
            logits = model.forward_conv1(pre)
        else:
            logits = model(render_images(ep, vis, rev, dtype=torch.float32))
        # soft[argmax] == max(soft): softmax is monotone
        return logits.argmax(dim=1), torch.softmax(logits, dim=1).amax(dim=1)

    @torch.inference_mode()
    def predict_specs(self, specs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """specs [N,12] -> (pred_ids int64 [N], softmax_sel f32 [N])."""
        n = specs.shape[0]
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        bs, nd = self.batch_size, len(self.devices)
        sub = bs // nd                       # each device's rows of a batch
        specs = self._pad(np.asarray(specs), bs)
        ep, vis, rev = rasterize.specs_to_endpoints(specs)
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ep, vis, rev)]
        if self.device.type == "cuda":
            host = [t.pin_memory() for t in host]
        total = specs.shape[0]
        with self._lock, (exact_f32() if not self.bf16
                          else contextlib.nullcontext()):
            # device d holds rows [i + d*sub, i + (d+1)*sub) of each batch i
            outs = [(torch.empty(total // nd, dtype=torch.int64, device=dev),
                     torch.empty(total // nd, dtype=torch.float32, device=dev))
                    for dev in self.devices]
            for i in range(0, total, bs):
                for d, dev in enumerate(self.devices):
                    lo = i + d * sub
                    batch = [t[lo:lo + sub].to(dev, non_blocking=True)
                             for t in host]
                    p, s = self._step(*self._replicas[d], *batch)
                    preds, softs = outs[d]
                    preds[i // nd:i // nd + sub] = p
                    softs[i // nd:i // nd + sub] = s.float()
            # the call's one synchronization per device
            outs = [(p.cpu(), s.cpu()) for p, s in outs]
        # [device, batch, row] -> [batch, device, row]: the specs' order
        preds, softs = (torch.stack(o).reshape(nd, -1, sub).transpose(0, 1)
                        .reshape(-1) for o in zip(*outs))
        return preds.numpy()[:n], softs.numpy()[:n]
