"""Faults planted underneath the timed path, to show that the check that
decides `correct` catches them (tests/test_bench_gpu.py, and
calibrate.py --fault for their readings). Each is a context manager that
patches the program for its duration:

  answer_altered     the engine's class answer of the first row of every
                     batch share moved to the next class, where it is
                     produced (inside the captured step)
  half_batch         the engine computes the first half of every batch
                     share and returns its answers for the second half too
  exchange_left_out  every card of a data-parallel engine gets the first
                     card's rows, so the others' never reach a card
  state_unchanged    the optimizer's step computes its update and then
                     puts the weights back
  half_batch_loss    the training loss is the mean over the first half of
                     the batch only
  replay_stale_rows  the training step's CUDA graph, once captured, reads
                     the rows it was captured with at every replay: the
                     static row buffer goes stale; the eager steps before
                     the capture are sound
"""

from __future__ import annotations

import contextlib
import inspect

import torch


@contextlib.contextmanager
def _patched(owner, name, replacement):
    saved = getattr(owner, name)
    setattr(owner, name, replacement(saved))
    try:
        yield
    finally:
        setattr(owner, name, saved)


def answer_altered():
    from svision_tpu_torch.infer.engine import InferenceEngine

    def make(step):
        def altered(self, *a):
            p, s = step(self, *a)
            p = p.clone()
            p[0] = (p[0] + 1) % 5
            return p, s
        return altered
    return _patched(InferenceEngine, "_step", make)


def half_batch():
    from svision_tpu_torch.infer.engine import InferenceEngine

    def make(step):
        def half(self, model, w, ep, vis, rev):
            h = ep.shape[0] // 2
            p, s = step(self, model, w, ep[:h], vis[:h], rev[:h])
            return torch.cat([p, p]), torch.cat([s, s])
        return half
    return _patched(InferenceEngine, "_step", make)


def exchange_left_out():
    from svision_tpu_torch.infer.engine import InferenceEngine

    def make(rows):
        def first_card_only(self, specs, batches):
            return [t[:1].expand_as(t).contiguous()
                    for t in rows(self, specs, batches)]
        return first_card_only
    return _patched(InferenceEngine, "_host_rows", make)


def state_unchanged():
    def make(step):
        def unchanged(self, closure=None):
            params = [p for g in self.param_groups for p in g["params"]]
            kept = [p.detach().clone() for p in params]
            out = step(self, closure)
            with torch.no_grad():
                for p, k in zip(params, kept):
                    p.copy_(k)
            return out
        return unchanged
    return _patched(torch.optim.SGD, "step", make)


def half_batch_loss():
    from svision_tpu_torch.models import train

    def make(loss_fn):
        def half(p, images, labels, generator, *a, **k):
            h = images.shape[0] // 2
            return loss_fn(p, images[:h], labels[:h], generator, *a, **k)
        return half
    return _patched(train, "loss_fn", make)


def replay_stale_rows():
    from svision_tpu_torch import graphs

    def make(call):
        def stale(self):
            rows = inspect.getclosurevars(self.fn).nonlocals["idx_s"]
            if self.pieces.steps == graphs.WARMUP_STEPS:
                # the capturing call
                self.stale_rows = rows.clone()
            elif self.pieces.replaying:
                rows.copy_(self.stale_rows)
            return call(self)
        return stale
    return _patched(graphs.StepGraph, "__call__", make)


FAULTS = {f.__name__: f for f in (answer_altered, half_batch,
                                  exchange_left_out, state_unchanged,
                                  half_batch_loss, replay_stale_rows)}
