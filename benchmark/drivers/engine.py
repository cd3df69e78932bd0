"""Driver: the inference engine, InferenceEngine.predict_specs, over a
'calls' mix, as cli.run_pipeline drives it: one caller, one call a
chromosome, in order, each call's specs laid out and pinned on the host
and their endpoints made on the cards in the timed path.

set-up   the specs, the weights from the seed, the engine as the
         configuration builds it (one replica a card), its warm-up (the
         kernels, cuDNN, the CUDA graph of each dispatch shape), and one
         call of the largest size, so that every allocation is made.
window   whole calls from the first chromosome on, round the genome,
         until the first call that ends after `seconds`.
slice    the mix's first `trace_calls` calls, for the span recorder
         and for the profiler.
check    a sample of the window's answers, drawn from the seed, against
         the reference (readings()).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import inputs, traffic, work
from benchmark.reference import alexnet as ref_alexnet
from benchmark.reference import raster as ref_raster

REF_BLOCK = 1024


def readings(ref_logits: torch.Tensor, preds: np.ndarray,
             softs: np.ndarray) -> Dict[str, float]:
    """The numbers `correct` compares, from the reference's logits of the
    sampled rows and the program's answers for them: the widest gap by
    which the class the program chose lies below the reference's best in
    the reference's softmax; the widest and the mean gap between the
    program's max softmax and the reference's."""
    p = torch.softmax(ref_logits.double(), dim=1).cpu()
    top = p.max(dim=1).values
    chosen = p[torch.arange(len(preds)), torch.from_numpy(preds).long()]
    err = (torch.from_numpy(softs).double() - top).abs()
    return {"argmax_gap": float((top - chosen).max()),
            "softmax_err": float(err.max()),
            "softmax_err_mean": float(err.mean())}


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, chips: int,
                 control: Optional[str] = None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.model = cfg["model"]
        self.engine_cfg = cfg["engine"]
        if self.engine_cfg["devices"] != chips:
            raise ValueError(f"{cfg['name']} runs on "
                             f"{self.engine_cfg['devices']} cards, the cell "
                             f"asks for {chips}")
        self.devices = [torch.device("cuda", i) for i in range(chips)]
        # control 'int8': the program's own int8 path in its place
        self.control = control
        self.engine = None
        self.answers: List[tuple] = []
        self.slice_calls: List[np.ndarray] = []
        # seconds from the start of set-up to the end of each of its phases
        self.phases: Dict[str, float] = {}

    @property
    def rows_per_launch(self) -> int:
        """Rows each card's kernels take a launch: the engine's own batch
        over its replicas (whole batches a replica on a mesh)."""
        return self.engine.batch_size // len(self.engine.devices)

    def setup(self) -> None:
        from svision_tpu_torch.infer.engine import InferenceEngine
        t = time.perf_counter()
        self.calls = traffic.calls(self.mix, self.seed)
        self.phases["traffic"] = time.perf_counter() - t
        # made once; the program and the reference get the same arrays
        self.params = inputs.host(inputs.params(self.model, self.seed,
                                                self.devices[0]))
        self.phases["weights"] = time.perf_counter() - t
        e = self.engine_cfg
        self.engine = InferenceEngine(
            self.params, batch_size=e["batch_size"],
            bf16=e["precision"] == "bfloat16", chunk=e["chunk"],
            tail=e["tail"], raster=e["raster"], device=self.devices[0],
            devices=self.devices if len(self.devices) > 1 else None,
            int8=self.control == "int8")
        self.phases["engine"] = time.perf_counter() - t
        self.engine.warmup()
        self.phases["warmup"] = time.perf_counter() - t
        largest = max(self.calls, key=lambda c: len(c[1]))[1]
        self.engine.predict_specs(largest)
        self.phases["largest_call"] = time.perf_counter() - t

    def window(self, seconds: float) -> dict:
        answers = []
        images = i = 0
        t0 = time.perf_counter()
        while True:
            k = i % len(self.calls)
            specs = self.calls[k][1]
            preds, softs = self.engine.predict_specs(specs)
            answers.append((k, preds, softs))
            images += len(specs)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.answers = answers
        return {"seconds": elapsed, "images": images, "attempted": i,
                "failed": 0}

    def slice(self) -> None:
        from torch.profiler import record_function
        self.slice_calls = []
        for _, specs in self.calls[:self.mix["trace_calls"]]:
            with record_function("bench.call"):
                self.engine.predict_specs(specs)
            self.slice_calls.append(specs)
        self.pad_spec = np.asarray(self.engine._SENTINEL)
        self.pad_rows = sum(self._padded(len(s)) - len(s)
                            for s in self.slice_calls)

    def _padded(self, n: int) -> int:
        chunks, singles = self.engine.plan(n)
        return (sum(chunks) + singles) * self.engine.batch_size

    def slice_lit_macs(self) -> int:
        """conv1's multiply-accumulates over the lit pixels of every image
        the slice's batches carried, its sentinel padding included."""
        dev = self.devices[0]
        total = 0
        for specs in self.slice_calls + [self.pad_spec]:
            for i in range(0, len(specs), 4 * REF_BLOCK):
                ep, vis, rev = (torch.from_numpy(np.ascontiguousarray(a))
                                .to(dev) for a in
                                ref_raster.endpoints(specs[i:i + 4 * REF_BLOCK]))
                macs = work.conv1_lit_macs(ref_raster.draw(ep, vis, rev),
                                           self.model)
                total += macs * (self.pad_rows if specs is self.pad_spec
                                 else 1)
        return total

    def release(self) -> None:
        self.engine = None
        gc.collect()
        for d in self.devices:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()

    def sample(self):
        """(specs, preds, softs) of the rows the check compares: drawn from
        the seed out of every answer the window gave."""
        sizes = [len(p) for _, p, _ in self.answers]
        total = sum(sizes)
        m = min(int(self.mix["check_rows"]), total)
        pick = np.sort(traffic.rng(self.seed, "check").choice(
            total, m, replace=False))
        starts = np.cumsum([0] + sizes)
        call = np.searchsorted(starts, pick, side="right") - 1
        row = pick - starts[call]
        specs = np.stack([self.calls[self.answers[c][0]][1][r]
                          for c, r in zip(call, row)])
        preds = np.array([self.answers[c][1][r] for c, r in zip(call, row)])
        softs = np.array([self.answers[c][2][r] for c, r in zip(call, row)],
                         dtype=np.float32)
        return specs, preds, softs

    def reference_logits(self, specs: np.ndarray,
                         tf32: bool = False) -> torch.Tensor:
        """The reference's f32 logits of specs (TF32 only for a control)."""
        dev = self.devices[0]
        p = inputs.device(self.params, dev)
        out = []
        with torch.no_grad(), ref_alexnet.f32_exact(tf32):
            for i in range(0, len(specs), REF_BLOCK):
                x = ref_raster.images(specs[i:i + REF_BLOCK], dev)
                out.append(ref_alexnet.logits(p, x, self.model))
        return torch.cat(out)

    def check(self) -> Dict[str, float]:
        specs, preds, softs = self.sample()
        return readings(self.reference_logits(specs), preds, softs)

    def control_check(self, control: str) -> Dict[str, float]:
        """The readings of a control that puts the reference in the
        program's place at a lower precision ('tf32'), on the rows the
        window's sample draws."""
        specs, _, _ = self.sample()
        if control != "tf32":
            raise ValueError(f"no reference control {control!r}")
        lg = self.reference_logits(specs, tf32=True)
        p = torch.softmax(lg, dim=1)
        return readings(self.reference_logits(specs),
                        p.argmax(1).cpu().numpy(),
                        p.max(1).values.float().cpu().numpy())
