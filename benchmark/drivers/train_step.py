"""Driver: the training step, make_device_step's step over a 'table' mix,
driven as fit_device drives it: the endpoint table, labels, weights and
optimizer state on the card; each epoch a device randperm of the table
and a flip a step from the run's generator, then a step a batch, the
loss read once an epoch.

set-up   the table and the weights from the seed, the step built once,
         then its first steps through its own call: the first three
         (eager, the step's warm-up) are recorded for the check; the
         fourth captures the CUDA graph and replays it.
window   whole steps from there on, a synchronize at each end; then,
         outside the timing, the program's state (weights, momentum,
         generator, the next rows and flips) is copied to the host and
         three more steps, graph replays as in the window, are recorded.
slice    the mix's `trace_steps` further steps, for the profiler.
check    both runs of three steps against the reference: the eager ones
         from the seed's weights, the replayed ones from the state copied
         after the window (the reference follows the program from there);
         each step's loss, the first step's clipped gradient as the
         optimizer gets it (from its momentum before and after the step),
         and the weights' change after three steps, leaf by leaf. The
         replayed run's numbers carry the suffix ".replay".
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import inputs, traffic
from benchmark.reference import alexnet as ref_alexnet
from benchmark.reference import train as ref_train

CHECKED_STEPS = 3
# a leaf whose reference gradient is under this share of the median
# leaf's is rounding only, and is not compared
SILENT_LEAF = 1e-3


def _tf_name(torch_name: str) -> str:
    layer, kind = torch_name.split(".")
    return f"{layer}/{'weights' if kind == 'weight' else 'biases'}"


def _torch_layout(w: torch.Tensor) -> torch.Tensor:
    """A TF-layout leaf in AlexNet's: conv HWIO -> OIHW, fc [in,out] ->
    [out,in], a bias as it is."""
    return (w.permute(3, 2, 0, 1) if w.dim() == 4 else
            w.t() if w.dim() == 2 else w)


def _tf_host(w: torch.Tensor) -> np.ndarray:
    """An AlexNet-layout leaf on the host in TF's layout, float32: the
    inverse of _torch_layout."""
    w = w.detach()
    w = (w.permute(2, 3, 1, 0) if w.dim() == 4 else
         w.t() if w.dim() == 2 else w)
    return w.float().contiguous().cpu().numpy()


def _norms(leaves: Dict[str, np.ndarray]) -> Dict[str, float]:
    return {k: float(np.linalg.norm(v.astype(np.float64).ravel()))
            for k, v in leaves.items()}


def gap(prog: Dict[str, float], ref: Dict[str, float],
        silent: Dict[str, float]) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf; leaves whose reference gradient is silent are left
    out."""
    median = float(np.median(list(ref.values())))
    quiet = SILENT_LEAF * float(np.median(list(silent.values())))
    return max(abs(prog[k] - ref[k]) / max(ref[k], median)
               for k in ref if silent[k] >= quiet)


def readings(losses, grad1, delta, ref: dict,
             suffix: str = "") -> Dict[str, float]:
    return {
        "loss_gap" + suffix: max(abs(a - b) / abs(b)
                                 for a, b in zip(losses, ref["losses"])),
        "grad_norm_gap" + suffix: gap(grad1, ref["grad1"], ref["grad1"]),
        "update_norm_gap" + suffix: gap(delta, ref["delta"], ref["grad1"]),
    }


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, chips: int,
                 control: Optional[str] = None):
        """control: the program's own lower-precision path; the training
        step has none (its control is control_check's)."""
        if control is not None:
            raise ValueError(f"the training step has no {control!r} path")
        if chips != 1:
            raise ValueError("the training step runs on one card")
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.model = cfg["model"]
        self.train_cfg = cfg["train"]
        self.devices = [torch.device("cuda", 0)]
        # seconds from the start of set-up to the end of each of its phases
        self.phases: Dict[str, float] = {}

    @property
    def rows_per_launch(self) -> int:
        return int(self.mix["batch"])

    def setup(self) -> None:
        from svision_tpu_torch.models.alexnet import AlexNet
        from svision_tpu_torch.models.train import make_device_step
        from svision_tpu_torch.ops.rasterize import specs_to_endpoints
        dev = self.devices[0]
        mix = self.mix
        t = time.perf_counter()
        self.specs, self.labels = traffic.table(mix, self.seed)
        ep, vis, rev = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in specs_to_endpoints(self.specs))
        labels = torch.from_numpy(self.labels).to(dev)
        self.phases["table"] = time.perf_counter() - t
        # made once; the program and the reference get the same arrays
        self.params = inputs.host(inputs.params(self.model, self.seed, dev))
        params0 = inputs.device(self.params, dev)
        self.phases["weights"] = time.perf_counter() - t
        self.model_obj = AlexNet.trainable(self.params, device=dev)
        self.phases["model"] = time.perf_counter() - t
        self.gen = torch.Generator(device=dev).manual_seed(
            traffic.torch_seed(self.seed, "train"))
        dtype = getattr(torch, self.train_cfg["precision"])
        self.opt, self.step_fn = make_device_step(
            self.model_obj, ep, vis, rev, labels, self.gen,
            batch_size=int(mix["batch"]),
            learning_rate=float(mix["learning_rate"]),
            keep_prob=float(mix["keep_prob"]), compute_dtype=dtype,
            augment=bool(mix["augment"]), s2d=bool(self.train_cfg["s2d"]))
        self.rows = len(self.labels)
        self.per_epoch = self.rows // int(mix["batch"])
        self.phases["step_built"] = time.perf_counter() - t
        self._epoch()
        self.first = {"idx": [self.idxs[s].clone()
                              for s in range(CHECKED_STEPS)],
                      "flip": [self.flips[s].clone()
                               for s in range(CHECKED_STEPS)],
                      "gen_state": self.gen.get_state(),
                      "params": self.params}
        named = dict(self.model_obj.named_parameters())
        losses = []
        for s in range(CHECKED_STEPS):
            losses.append(self._step())
            if s == 0:
                self.grad1 = {
                    _tf_name(k): float(torch.linalg.vector_norm(
                        self.opt.state[p]["momentum_buffer"],
                        dtype=torch.float64)) for k, p in named.items()}
        self.losses = [float(x) for x in losses]
        self.delta = {
            _tf_name(k): float(torch.linalg.vector_norm(
                p.detach() - _torch_layout(params0[_tf_name(k)]),
                dtype=torch.float64)) for k, p in named.items()}
        del params0
        self.phases["eager_steps"] = time.perf_counter() - t
        # the fourth step captures the graph and replays it; the fifth
        # replays
        self._step()
        self._step()
        torch.cuda.synchronize(dev)
        self.phases["graph"] = time.perf_counter() - t

    def _epoch(self) -> None:
        """fit_device's per-epoch draws: the order and the flips."""
        dev = self.devices[0]
        b = int(self.mix["batch"])
        self.idxs = torch.randperm(self.rows, generator=self.gen, device=dev)[
            :self.per_epoch * b].view(self.per_epoch, b)
        self.flips = (torch.rand(self.per_epoch, generator=self.gen,
                                 device=dev) < 0.5
                      if self.mix["augment"] else
                      torch.zeros(self.per_epoch, dtype=torch.bool,
                                  device=dev))
        self.at = 0
        self.epoch_losses = []

    def _step(self) -> torch.Tensor:
        if self.at == self.per_epoch:
            # the loss is read once an epoch
            torch.stack(self.epoch_losses).mean().item()
            self._epoch()
        loss = self.step_fn(self.idxs[self.at], self.flips[self.at])
        self.epoch_losses.append(loss)
        self.at += 1
        return loss

    def window(self, seconds: float) -> dict:
        dev = self.devices[0]
        torch.cuda.synchronize(dev)
        steps = 0
        t0 = time.perf_counter()
        while True:
            self._step()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        self._record_replays()
        return {"seconds": elapsed, "images": steps * int(self.mix["batch"]),
                "steps": steps, "attempted": steps, "failed": 0}

    def _record_replays(self) -> None:
        """The program's state on the host, then three replayed steps: the
        losses, the first step's clipped gradient (the momentum after it
        less 0.9 times the momentum before) and the weights' change."""
        if self.at + CHECKED_STEPS > self.per_epoch:
            torch.stack(self.epoch_losses).mean().item()
            self._epoch()
        named = dict(self.model_obj.named_parameters())

        def state(kind):
            return {_tf_name(k): _tf_host(
                p if kind == "params" else
                self.opt.state[p]["momentum_buffer"])
                for k, p in named.items()}
        r = {"params": state("params"), "momentum": state("momentum"),
             "idx": [self.idxs[self.at + s].clone()
                     for s in range(CHECKED_STEPS)],
             "flip": [self.flips[self.at + s].clone()
                      for s in range(CHECKED_STEPS)],
             "gen_state": self.gen.get_state()}
        losses = []
        for s in range(CHECKED_STEPS):
            losses.append(self._step())
            if s == 0:
                m1 = state("momentum")
                r["grad1"] = _norms({k: m1[k].astype(np.float64)
                                     - 0.9 * r["momentum"][k]
                                     for k in m1})
        p3 = state("params")
        r["delta"] = _norms({k: p3[k].astype(np.float64) - r["params"][k]
                             for k in p3})
        r["losses"] = [float(x) for x in losses]
        self.replays = r

    def slice(self) -> None:
        from torch.profiler import record_function
        for _ in range(int(self.mix["trace_steps"])):
            with record_function("bench.step"):
                self._step()

    def release(self) -> None:
        self.opt = self.step_fn = self.model_obj = None
        self.idxs = self.flips = self.epoch_losses = None
        gc.collect()
        torch.cuda.empty_cache()

    def reference(self, replayed: bool, quant=None) -> dict:
        """The reference's three steps from the seed's weights, or with
        replayed from the state copied after the window."""
        mix, dev = self.mix, self.devices[0]
        start = self.replays if replayed else self.first
        return ref_train.steps(
            inputs.device(start["params"], dev), self.specs, self.labels,
            start["idx"], start["flip"], start["gen_state"], model=self.model,
            learning_rate=float(mix["learning_rate"]),
            keep_prob=float(mix["keep_prob"]), clip=float(self.train_cfg["clip"]),
            augment=bool(mix["augment"]), quant=quant,
            momentum0=(inputs.device(start["momentum"], dev) if replayed
                       else None))

    def check(self) -> Dict[str, float]:
        r = self.replays
        return {**readings(self.losses, self.grad1, self.delta,
                           self.reference(False)),
                **readings(r["losses"], r["grad1"], r["delta"],
                           self.reference(True), ".replay")}

    def control_check(self, control: str) -> Dict[str, float]:
        """The readings of the reference in the program's place, computed
        through float8 ('fp8'), against the float32 reference."""
        if control != "fp8":
            raise ValueError(f"no reference control {control!r}")
        out = {}
        for replayed, suffix in ((False, ""), (True, ".replay")):
            low = self.reference(replayed, quant=ref_alexnet.fp8)
            out.update(readings(low["losses"], low["grad1"], low["delta"],
                                self.reference(replayed), suffix))
        return out
