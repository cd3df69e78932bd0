"""Training of the similarity-image CNN, in PyTorch.

Counterpart of the JAX package's models/train.py: softmax cross-entropy
over the 5 SV classes with dropout after fc6 and fc7 (the reference's
placement, alexnet.py:51-55), SGD with momentum 0.9 behind a global-norm
clip, and the training pipeline from labeled candidate specs to a
TF1-named checkpoint that both packages read.

The differentiable forward composes torch ops (cuDNN/cuBLAS convolutions
and GEMMs, ReLU and the conv5 pool), as the JAX trainer composes XLA ops,
except for the bias/ReLU/pool/LRN tails after conv1 and conv2: those run
through fused_pool_lrn.BiasReluPoolLRN, K2 forward and a hand-written
backward kernel on the card, their plain versions on the CPU. The
kernels' inference wrappers are not differentiable and refuse inputs
that require grad; K1 renders the image path's batches, which need no
gradient, and K1 + K2 run evaluate's inference forward.

Randomness comes from explicit torch.Generators (dropout, fit_device's
shuffle and augmentation) and, in fit, from the JAX loop's
np.random.RandomState call order, so fit is step-for-step reproducible
against the JAX package at keep_prob=1.

On the card a step is a CUDA graph after its first eager steps
(graphs.StepGraph), as the JAX trainers jit theirs: make_train_step's
forward, backward, clip and SGD for fit, and for fit_device the whole step,
from the gather of a batch's endpoints to the update (make_device_step).
The DP x TP step (make_mesh_train_step, fit(mesh=...)) spans devices, so
it is cut into pieces of one device each, every piece its own graph
(graphs.Pieces). eager=True on make_train_step, make_device_step and
make_mesh_train_step keeps the card's step eager, the reference the graphs
are held to. On the CPU every step is eager.

f32 training runs under training_precision (TF32 off, and oneDNN off on
the CPU), so the card's step matches the CPU's; bf16 compute is the fast
mode, with f32 master weights and f32 logits.

    python -m svision_tpu_torch.models.train --data d.npz -o w.npz
        [--init w0.npz] [--epochs 10] [--batch-size 64] [--lr 1e-3]
        [--seed 0] [--bf16] [--device cuda|cpu]
"""

from __future__ import annotations

import contextlib
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from svision_tpu_torch import graphs, trace
from svision_tpu_torch.device import resolve_device
from svision_tpu_torch.infer.engine import exact_f32
from svision_tpu_torch.models import alexnet
from svision_tpu_torch.models.alexnet import (AlexNet, fold_conv1_math,
                                              params_to_numpy)
from svision_tpu_torch.ops import rasterize
from svision_tpu_torch.ops.fused_pool_lrn import BiasReluPoolLRN
from svision_tpu_torch.ops.raster_kernel import render_images
from svision_tpu_torch.ops.rasterize import CANVAS

# AlexNet parameter names (conv1.weight, ...) -> tensors, reference space
Params = Mapping[str, torch.Tensor]


@contextlib.contextmanager
def training_precision(compute_dtype):
    """f32 trains with TF32 off (exact_f32), so the card computes what the
    CPU does, and without oneDNN on the CPU: its f32 convolutions round
    identical input patches differently at different positions, so the
    blank regions of a raster stop tying where XLA's and cuDNN's tie, and
    max-pool sends the gradient elsewhere (conv weight gradients then
    differ from the JAX package's by 1e-3 of their largest). bf16 runs
    as it is."""
    if compute_dtype != torch.float32:
        yield
        return
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        with exact_f32():
            yield
    finally:
        torch.backends.mkldnn.enabled = saved


def _features(p: Params, h: torch.Tensor, cd, s2d: bool) -> torch.Tensor:
    """The conv stack on NCHW input in cd -> [N,9216] in cd, flattened in
    NHWC order (the TF reshape, alexnet.py:49). Every intermediate is in
    cd, as the JAX trainer's `inter` dtype is. s2d=True folds conv1 inside
    the graph (fold_conv1_math): the input is the {0,1} s2d raster, and
    the gradient reaches the reference-space [96,3,11,11] weights."""
    for name, kh, _, _, stride, padding, groups in alexnet._CONV_SPECS:
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        pad = 0 if padding == "VALID" else kh // 2
        if s2d and name == "conv1":
            w_s2d, b = fold_conv1_math(w.permute(2, 3, 1, 0), b)
            w, stride, pad = w_s2d.permute(3, 2, 0, 1), 1, 0
        h = F.conv2d(h, w.to(cd), None, stride, pad, 1, groups)
        if name in ("conv1", "conv2"):
            h = bias_relu_pool_lrn_autograd(h.permute(0, 2, 3, 1),
                                            b.to(cd)).permute(0, 3, 1, 2)
        else:
            h = torch.relu(h + b.to(cd)[:, None, None])
            if name == "conv5":
                h = F.max_pool2d(h, 3, 2)
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def bias_relu_pool_lrn_autograd(h: torch.Tensor, b: torch.Tensor):
    """K2's function, differentiable, on NHWC h [N,H,W,C] (the NHWC view
    of a channels-last conv output is contiguous): relu(h + b) -> 3x3
    stride-2 max-pool -> TF LRN -> [N,Ho,Wo,C] in h's dtype, through
    BiasReluPoolLRN (K2 and its backward kernel on the card)."""
    return BiasReluPoolLRN.apply(h, b)


def _dense_relu(h, w, b, cd):
    return torch.relu(F.linear(h, w.to(cd), b.to(cd)))


def _dropout(h, keep_prob: float, generator: torch.Generator):
    """Inverted dropout, the mask drawn from generator (on h's device)."""
    keep = torch.rand(h.shape, generator=generator, device=h.device) < keep_prob
    return torch.where(keep, h / keep_prob, 0.0)


def _head(p: Params, h, generator, keep_prob: float, cd):
    for name in ("fc6", "fc7"):
        h = _dense_relu(h, p[f"{name}.weight"], p[f"{name}.bias"], cd)
        h = _dropout(h, keep_prob, generator)
    # fc8 in f32: f32 logits for the loss
    return F.linear(h.float(), p["fc8.weight"].float(), p["fc8.bias"].float())


def forward_train(p: Params, x: torch.Tensor, generator: torch.Generator,
                  keep_prob: float = 0.5, compute_dtype=torch.float32):
    """Logits f32 [N,5] from NHWC [N,227,227,3] mean-subtracted images,
    with dropout after fc6 and fc7. Weights are cast to compute_dtype
    inside (f32 master weights)."""
    h = x.to(compute_dtype).permute(0, 3, 1, 2)
    return _head(p, _features(p, h, compute_dtype, s2d=False), generator,
                 keep_prob, compute_dtype)


def forward_train_s2d(p: Params, raster_s2d: torch.Tensor,
                      generator: torch.Generator, keep_prob: float = 0.5,
                      compute_dtype=torch.float32):
    """Logits f32 [N,5] from the {0,1} raster in conv1's space-to-depth
    layout, NHWC [N,57,57,48] (rasterize.render_raster_s2d), through the
    in-graph conv1 fold: same parameters and checkpoints as
    forward_train, no [N,227,227,3] image and no 11x11 stride-4 conv."""
    h = raster_s2d.to(compute_dtype).permute(0, 3, 1, 2)
    return _head(p, _features(p, h, compute_dtype, s2d=True), generator,
                 keep_prob, compute_dtype)


def loss_fn(p: Params, images, labels, generator, keep_prob: float = 0.5,
            compute_dtype=torch.float32, s2d: bool = False) -> torch.Tensor:
    """Mean softmax cross-entropy."""
    fwd = forward_train_s2d if s2d else forward_train
    logits = fwd(p, images, generator, keep_prob, compute_dtype)
    return F.cross_entropy(logits, labels.long())


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale grads in place by min(1, max_norm / global norm), optax's
    clip_by_global_norm (torch's clip_grad_norm_ divides by norm + 1e-6).
    No host sync; the grads may lie on several devices. The norm is summed
    in f64: an f32 norm over fc6's 37.7 M entries was off by 5e-4 on the
    CPU. Returns the norm."""
    dev = grads[0].device
    norm, scale = _clip_scale(
        [torch.linalg.vector_norm(g, dtype=torch.float64).to(dev)
         for g in grads], max_norm)
    for g in grads:
        g.mul_(scale.to(g.device))
    return norm


def _clip_scale(norms: Sequence[torch.Tensor], max_norm: float):
    """(global norm, f32 scale min(1, max_norm / global norm)) from each
    tensor's f64 norm, in order (0-d tensors on one device)."""
    norm = torch.linalg.vector_norm(torch.stack(list(norms)))
    return norm, torch.clamp(max_norm / norm, max=1.0).float()


def _sgd_step(model: AlexNet, learning_rate: float, clip_norm: Optional[float],
              keep_prob: float, compute_dtype, s2d: bool):
    """(optimizer, step, reset): step(images, labels, generator) runs the
    forward, the backward, the clip and the SGD update into fresh or
    existing gradients and returns the loss; reset() clears the gradients
    (set to None)."""
    params = dict(model.named_parameters())
    opt = torch.optim.SGD(params.values(), lr=learning_rate, momentum=0.9)

    def step(images, labels, generator):
        with training_precision(compute_dtype):
            loss = loss_fn(params, images, labels, generator, keep_prob,
                           compute_dtype, s2d)
            loss.backward()
        if clip_norm is not None:
            clip_by_global_norm_([q.grad for q in params.values()], clip_norm)
        opt.step()
        return loss.detach()

    def reset():
        opt.zero_grad(set_to_none=True)

    return opt, step, reset


def make_train_step(model: AlexNet, *, learning_rate: float = 1e-3,
                    clip_norm: Optional[float] = None, keep_prob: float = 0.5,
                    compute_dtype=torch.float32, s2d: bool = False,
                    eager: bool = False):
    """Returns (optimizer, train_step). The JAX package's make_train_step
    with optax.sgd(learning_rate, momentum=0.9), chained after
    clip_by_global_norm(clip_norm) when clip_norm is given: torch's SGD
    without dampening keeps the same trace (g + 0.9 t) and update (-lr t).

    train_step(images, labels, generator) updates model's parameters in
    place and returns the loss as a device tensor (no host sync). s2d=True:
    images is the {0,1} s2d raster [N,57,57,48].

    On the card, unless eager, the step is a CUDA graph after its first
    graphs.WARMUP_STEPS eager steps: every call copies images and labels
    into static buffers, so they keep the first call's shapes and dtypes,
    and takes the first call's generator, which the graph advances."""
    opt, step, reset = _sgd_step(model, learning_rate, clip_norm, keep_prob,
                                 compute_dtype, s2d)
    dev = next(model.parameters()).device
    if eager or dev.type != "cuda":
        def train_step(images, labels, generator):
            reset()
            return step(images, labels, generator)
        return opt, train_step

    static = {}

    def train_step(images, labels, generator):
        if not static:
            static.update(x=torch.empty_like(images),
                          y=torch.empty_like(labels, device=dev),
                          gen=generator)
            static["graph"] = graphs.StepGraph(
                lambda: step(static["x"], static["y"], static["gen"]), reset,
                dev, generator)
        elif (images.shape != static["x"].shape
              or images.dtype != static["x"].dtype
              or labels.shape != static["y"].shape
              or generator is not static["gen"]):
            raise ValueError("a graphed train_step takes the first call's "
                             "shapes, dtypes and generator on every call")
        static["x"].copy_(images)
        static["y"].copy_(labels)
        return static["graph"]().clone()

    return opt, train_step


# ---------------------------------------------------------------------------
# DP x TP: a grid of devices, batch rows on 'data', fc6/fc7 split on 'model'
# ---------------------------------------------------------------------------

def make_mesh_train_step(cells, *, learning_rate: float = 1e-3,
                         clip_norm: Optional[float] = None,
                         keep_prob: float = 0.5, compute_dtype=torch.float32,
                         eager: bool = False):
    """The train step over parallel.mesh placements (shard_params_tp or
    replicate_params): cells[d][m] holds the parameters of the device at
    data row d, model column m. Each data row takes an equal share of the
    batch's rows; each cell runs the conv stack and its fc6 columns, and
    fc7's partial products are summed over the model axis on the row's
    first device, which runs the rest. Gradients are summed over every
    cell that holds a copy of the same tensor (the data axis, and the
    model axis for replicated ones) before the clip, and every copy then
    takes the same update: the JAX package's jitted mesh step, where GSPMD
    inserts the same sums.

    Returns (optimizers, train_step): optimizers maps each cell (d, m) to
    the torch.optim.SGD (momentum 0.9) over its parameters, and
    train_step(images, labels, generators) takes a {device:
    torch.Generator} map for dropout and returns the loss as a device
    tensor on cells[0][0]'s device. Every call copies images and labels
    into static buffers, so it takes the first call's shapes, dtypes and
    generators; the batch must split evenly over the data rows.

    The step is cut into pieces at its cross-device points (_MeshStep).
    On the card, unless eager, each piece is a CUDA graph on its own
    device after graphs.WARMUP_STEPS eager steps (graphs.Pieces); on the
    CPU, or eager, the same pieces run eagerly."""
    step = _MeshStep(cells, learning_rate, clip_norm, keep_prob,
                     compute_dtype, eager)
    return step.optimizers, step


# what a row's head differentiates, on the row's first cell; every cell
# differentiates the rest, its trunk (the conv stack, fc6, its fc7 rows)
_HEAD = ("fc7.bias", "fc8.weight", "fc8.bias")


def _views(buf: torch.Tensor, shapes) -> List[torch.Tensor]:
    """Consecutive views of the flat buffer buf, one of each shape."""
    out, at = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(buf[at:at + n].view(shape))
        at += n
    return out


class _MeshStep:
    """make_mesh_train_step's train_step. The step is cut where it crosses
    cells into pieces that each run on one cell's device (graphs.Pieces),
    with copies between cells, even on one device, between them. For each
    data row d, in order:
      fwd (d, m)  on every cell of the row: from its static rows of the
                  batch, the conv stack, fc6, dropout and its fc7 partial
                  product; its autograd graph is kept for bwd;
      head d      on cell (d, 0): the partials summed in column order,
                  fc7's bias and ReLU, dropout, fc8, the row's loss, and
                  its backward to the head's parameters and d(sum);
      bwd (d, m)  on every cell of the row: its backward from d(sum), then
                  its gradients packed, one flat buffer per owner they go
                  to.
    Then, over the grid:
      reduce o    on each owner o (the cell of a tensor's first copy in
                  holders() order): each owned tensor's gradients summed
                  in holders() order, from zeros, with their f64 norms;
                  the sums packed for the other cells that hold them; on
                  cell (0, 0) also the loss, the mean of the rows' losses;
      update c    on every cell: its tensors take their summed gradients
                  (its own or received), scaled by the clip that every
                  cell computes alike from every owner's norms, then its
                  SGD.
    Every copy takes the same update from the same numbers, and on one
    device the arithmetic is the composite step's: the same sums in the
    same order, the same norms, one SGD per cell in place of one over the
    grid. Dropout draws from the cell device's generator in the
    composite's order (row by row, a row's cells before its head)."""

    def __init__(self, cells, learning_rate, clip_norm, keep_prob, cd,
                 eager):
        from svision_tpu_torch.parallel.mesh import holders
        self.cells, self.clip_norm = cells, clip_norm
        self.keep_prob, self.cd = keep_prob, cd
        self.nd, self.nm = len(cells), len(cells[0])
        self.grid = [(d, m) for d in range(self.nd) for m in range(self.nm)]
        self.dev = {c: self.p(c)["fc8.weight"].device for c in self.grid}
        self.pieces = graphs.Pieces(graphed=not eager and all(
            v.type == "cuda" for v in self.dev.values()))
        self.optimizers = {c: torch.optim.SGD(self.p(c).values(),
                                              lr=learning_rate, momentum=0.9)
                           for c in self.grid}
        groups = holders(cells)
        self.group_of = {key: gi for gi, g in enumerate(groups) for key in g}
        self.owner = [g[0][0] for g in groups]
        self.owned = {}
        for gi, o in enumerate(self.owner):
            self.owned.setdefault(o, []).append(gi)
        self.sources = [[(c, k) for c, k in g if k not in _HEAD or c[1] == 0]
                        for g in groups]
        # gradients from a cell to an owner, sums from an owner to a cell
        # holding a copy: (src, dst) -> [(group, name)], in group order
        to_owner, to_holder = {}, {}
        for gi, g in enumerate(groups):
            o = self.owner[gi]
            for c, k in self.sources[gi]:
                if c != o:
                    to_owner.setdefault((c, o), []).append((gi, k))
            for c, k in g:
                if c != o:
                    to_holder.setdefault((o, c), []).append((gi, k))
        self.grads_out, self.grads_in = self._links(to_owner)
        self.sums_out, self.sums_in = self._links(to_holder)
        self.norms_in = {}
        if clip_norm is not None:
            self.norms_in = {(o, c): torch.empty(
                len(gis), dtype=torch.float64, device=self.dev[c])
                for o, gis in self.owned.items() for c in self.grid if c != o}
        self.x = None                 # static inputs, made by the first call
        self.autograd = {}            # fwd's partial products, for bwd
        self.out = {}                 # each piece's outputs this step

    def p(self, c):
        return self.cells[c[0]][c[1]]

    def _links(self, plan):
        """For each (src, dst) of plan: (items, the flat send buffer on
        src's device, the receive buffer on dst's), and dst's view of
        each item's tensor in it, by (src, dst, group)."""
        links, views = {}, {}
        for (src, dst), items in plan.items():
            shapes = [self.p(src)[k].shape for _, k in items]
            n = sum(int(np.prod(sh)) for sh in shapes)
            dtype = self.p(src)[items[0][1]].dtype
            send = torch.empty(n, dtype=dtype, device=self.dev[src])
            recv = torch.empty(n, dtype=dtype, device=self.dev[dst])
            links[(src, dst)] = (items, send, recv)
            for (gi, _), v in zip(items, _views(recv, shapes)):
                views[(src, dst, gi)] = v
        return links, views

    def _bind(self, images, labels, generators):
        """Static inputs from the first call; later calls must match it."""
        gens = {v: generators[v] for v in set(self.dev.values())}
        if self.x is not None:
            if (images.shape != self.shape[0] or labels.shape != self.shape[1]
                    or images.dtype != self.x[(0, 0)].dtype
                    or labels.dtype != self.y[0].dtype
                    or any(gens[v] is not g for v, g in self.gens.items())):
                raise ValueError("the DP x TP train_step takes the first "
                                 "call's shapes, dtypes and generators on "
                                 "every call")
            return
        if images.shape[0] % self.nd:
            raise ValueError(f"a batch of {images.shape[0]} does not split "
                             f"evenly over {self.nd} data rows")
        self.rows = rows = images.shape[0] // self.nd
        self.shape, self.gens = (images.shape, labels.shape), gens
        self.x = {c: torch.empty((rows,) + images.shape[1:],
                                 dtype=images.dtype, device=self.dev[c])
                  for c in self.grid}
        self.y = [torch.empty((rows,) + labels.shape[1:], dtype=labels.dtype,
                              device=self.dev[(d, 0)]) for d in range(self.nd)]
        width = self.p((0, 0))["fc7.weight"].shape[0]
        # fc7 partials at their row's head, d(sum) at the cells
        self.part_in = {c: torch.empty((rows, width), dtype=self.cd,
                                       device=self.dev[(c[0], 0)])
                        for c in self.grid if c[1]}
        self.dsum_in = {c: torch.empty((rows, width), dtype=self.cd,
                                       device=self.dev[c])
                        for c in self.grid if c[1]}
        self.loss_in = {d: torch.empty((), dtype=torch.float32,
                                       device=self.dev[(0, 0)])
                        for d in range(1, self.nd)}

    def _fwd(self, c):
        p, cd = self.p(c), self.cd
        with training_precision(cd):
            h = _features(p, self.x[c].to(cd).permute(0, 3, 1, 2), cd,
                          s2d=False)
            h = _dense_relu(h, p["fc6.weight"], p["fc6.bias"], cd)
            h = _dropout(h, self.keep_prob, self.gens[self.dev[c]])
            part = F.linear(h, p["fc7.weight"].to(cd))
        self.autograd[c] = part
        return part.detach()

    def _head(self, d):
        c0 = (d, 0)
        p, cd = self.p(c0), self.cd
        with training_precision(cd):
            s = self.out["fwd", c0]
            for m in range(1, self.nm):
                s = s + self.part_in[(d, m)]
            s = s.detach().requires_grad_()
            h = torch.relu(s + p["fc7.bias"].to(cd))
            h = _dropout(h, self.keep_prob, self.gens[self.dev[c0]])
            logits = F.linear(h.float(), p["fc8.weight"].float(),
                              p["fc8.bias"].float())
            loss = F.cross_entropy(logits, self.y[d].long())
            # the grid's loss is the mean of its rows'
            (loss / self.nd).backward()
        return loss.detach(), s.grad

    def _bwd(self, c):
        p = self.p(c)
        dsum = self.out["head", c[0]][1] if c[1] == 0 else self.dsum_in[c]
        with training_precision(self.cd):
            self.autograd.pop(c).backward(dsum)
        for (src, _), (items, send, _) in self.grads_out.items():
            if src == c:
                torch.cat([p[k].grad.reshape(-1) for _, k in items], out=send)
        # the raw gradients stay referenced while the graphs replay
        return [t.grad for t in p.values() if t.grad is not None]

    def _reduce(self, o):
        p = self.p(o)
        sums = {}
        for gi in self.owned[o]:
            g = torch.zeros_like(p[self.sources[gi][0][1]])
            for c, k in self.sources[gi]:
                g += p[k].grad if c == o else self.grads_in[(c, o, gi)]
            sums[gi] = g
        for (src, _), (items, send, _) in self.sums_out.items():
            if src == o:
                torch.cat([sums[gi].reshape(-1) for gi, _ in items], out=send)
        norms = loss = None
        if self.clip_norm is not None:
            norms = torch.stack([torch.linalg.vector_norm(
                sums[gi], dtype=torch.float64) for gi in self.owned[o]])
        if o == (0, 0):
            loss = torch.stack([self.out["head", 0][0]] + [
                self.loss_in[d] for d in range(1, self.nd)]).mean()
        return sums, norms, loss

    def _update(self, c):
        p = self.p(c)
        for k, t in p.items():
            gi = self.group_of[(c, k)]
            o = self.owner[gi]
            t.grad = (self.out["reduce", c][0][gi] if o == c
                      else self.sums_in[(o, c, gi)])
        if self.clip_norm is not None:
            norms = []
            for gi, o in enumerate(self.owner):
                mine = (self.out["reduce", c][1] if o == c
                        else self.norms_in[(o, c)])
                norms.append(mine[self.owned[o].index(gi)])
            _, scale = _clip_scale(norms, self.clip_norm)
            for t in p.values():
                t.grad.mul_(scale)
        self.optimizers[c].step()

    def __call__(self, images, labels, generators):
        self._bind(images, labels, generators)
        run, out, rows = self.pieces, self.out, self.rows
        if not run.replaying:
            for opt in self.optimizers.values():
                opt.zero_grad(set_to_none=True)
        for c in self.grid:
            self.x[c].copy_(images[c[0] * rows:(c[0] + 1) * rows])
        for d in range(self.nd):
            self.y[d].copy_(labels[d * rows:(d + 1) * rows])
        for d in range(self.nd):
            row = [(d, m) for m in range(self.nm)]
            for c in row:
                out["fwd", c] = run(("fwd", c), self.dev[c],
                                    lambda c=c: self._fwd(c),
                                    (self.gens[self.dev[c]],))
            for c in row[1:]:
                self.part_in[c].copy_(out["fwd", c])
            out["head", d] = run(("head", d), self.dev[row[0]],
                                 lambda d=d: self._head(d),
                                 (self.gens[self.dev[row[0]]],))
            for c in row[1:]:
                self.dsum_in[c].copy_(out["head", d][1])
            for c in row:
                run(("bwd", c), self.dev[c], lambda c=c: self._bwd(c))
        # a copy's source stream waits for all the destination's current
        # stream holds: copied earlier, a row's loss would hold its
        # backward until row 0's had run
        for d, recv in self.loss_in.items():
            recv.copy_(out["head", d][0])
        for _, send, recv in self.grads_out.values():
            recv.copy_(send)
        for o in self.owned:
            out["reduce", o] = run(("reduce", o), self.dev[o],
                                   lambda o=o: self._reduce(o))
        for _, send, recv in self.sums_out.values():
            recv.copy_(send)
        for (o, _), recv in self.norms_in.items():
            recv.copy_(out["reduce", o][1])
        for c in self.grid:
            run(("update", c), self.dev[c], lambda c=c: self._update(c))
        run.end_step()
        return out["reduce", (0, 0)][2].clone()


# ---------------------------------------------------------------------------
# Training pipeline: labeled candidate specs -> trained checkpoint
# ---------------------------------------------------------------------------

def specs_to_images(specs, flip: bool = False, jitter_rng=None,
                    max_shift: int = 10, max_jitter: int = 2,
                    device=None) -> torch.Tensor:
    """[N,12] specs -> [N,227,227,3] mean-subtracted f32 images on device
    (K1 and normalize_raster on the card, their plain versions on the CPU).

    flip=True mirrors the image left-right, the reference training recipe's
    cv2.flip (a mirror of the ref axis keeps the SV class). jitter_rng (an
    np.random.RandomState) shifts each image by up to +-max_shift px and
    each endpoint by up to +-max_jitter px (jitter_endpoints_np)."""
    dev = resolve_device(device)
    ep, vis, rev = rasterize.specs_to_endpoints(specs)
    if jitter_rng is not None:
        ep = jitter_endpoints_np(ep, jitter_rng, max_shift, max_jitter)
    seg = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (ep, vis, rev)]
    images = render_images(*seg, dtype=torch.float32)
    if flip:
        images = torch.flip(images, dims=[2])
    return images


def jitter_endpoints_np(ep, rng, max_shift: int = 10, max_jitter: int = 2):
    """Host endpoint augmentation: per-image (dc, dr) translation +
    per-endpoint jitter, clamped to the canvas. ep int32 [N, S, 4]
    (col0,row0,col1,row1)."""
    n, s, _ = ep.shape
    shift = rng.randint(-max_shift, max_shift + 1, (n, 1, 2))
    jit = rng.randint(-max_jitter, max_jitter + 1, (n, s, 4))
    out = ep.astype(np.int64)
    out[..., 0::2] += shift[..., 0:1] + jit[..., 0::2]   # cols
    out[..., 1::2] += shift[..., 1:2] + jit[..., 1::2]   # rows
    return np.clip(out, 0, CANVAS - 1).astype(ep.dtype)


def jitter_endpoints_torch(ep: torch.Tensor, generator: torch.Generator,
                           max_shift: int = 10, max_jitter: int = 2):
    """Device twin of jitter_endpoints_np (fit_device's augmentation)."""
    n, s, _ = ep.shape
    shift = torch.randint(-max_shift, max_shift + 1, (n, 1, 2),
                          generator=generator, device=ep.device,
                          dtype=ep.dtype)
    jit = torch.randint(-max_jitter, max_jitter + 1, (n, s, 4),
                        generator=generator, device=ep.device, dtype=ep.dtype)
    # (dc, dr, dc, dr) over (col0, row0, col1, row1)
    return torch.clamp(ep + shift.repeat(1, 1, 2) + jit, 0,
                       CANVAS - 1).to(ep.dtype)


def fragment_endpoints_torch(ep, vis, rev, generator: torch.Generator,
                             split_prob: float = 0.3, gap_max: int = 3):
    """Raster-noise augmentation: split segments into two colinear
    sub-segments with a small pixel gap, the fragmented-diagonal look of
    hashplot-realigned noisy sequence. ep [N,S,4] -> [N,2S,4] (vis/rev
    widen to match); un-split segments keep their line with an invisible
    padding slot.

    As in the JAX package, the s2d raster draws segment slots 0 and 1
    only, so there a split segment keeps its first sub-segment and loses
    the second; the image path's raster (K1 on the card) draws all four."""
    c0, r0, c1, r1 = ep.unbind(-1)
    dc, dr = c1 - c0, r1 - r0
    major = torch.maximum(dc.abs(), dr.abs())
    dev = ep.device
    f = 0.35 + 0.3 * torch.rand(major.shape, generator=generator, device=dev)
    g = torch.randint(1, gap_max + 1, major.shape, generator=generator,
                      device=dev, dtype=major.dtype)
    gfrac = g / torch.clamp(major, min=1)
    f1, f2 = f - gfrac, f + gfrac
    m1 = torch.stack([c0 + torch.round(dc * f1), r0 + torch.round(dr * f1)],
                     -1).to(ep.dtype)
    m2 = torch.stack([c0 + torch.round(dc * f2), r0 + torch.round(dr * f2)],
                     -1).to(ep.dtype)
    do = ((torch.rand(major.shape, generator=generator, device=dev)
           < split_prob) & (major >= 4 * gap_max) & vis)
    sub1 = torch.where(do[..., None], torch.cat([ep[..., :2], m1], -1), ep)
    sub2 = torch.cat([m2, ep[..., 2:]], -1)
    return (torch.cat([sub1, sub2], 1), torch.cat([vis, do], 1),
            torch.cat([rev, rev], 1))


def fit(params, specs, labels, *, epochs: int = 3, batch_size: int = 32,
        seed: int = 0, learning_rate: float = 1e-3, keep_prob: float = 0.5,
        compute_dtype=torch.float32, augment: bool = True, mesh=None,
        device=None, log=None):
    """Train the CNN on labeled candidate specs, a host loop of one step
    per batch; returns (params, history): TF-named numpy arrays and the
    per-epoch mean loss.

    Order, flip and jitter come from np.random.RandomState(seed) in the
    JAX loop's call order (permutation, then per batch flip, then jitter),
    so at keep_prob=1 the run follows the JAX package's step for step.
    With mesh (a parallel.mesh.make_train_mesh grid) the batch is split
    over its data rows, with fc6/fc7 tensor-parallel when it has more
    than one model column (shard_params_tp), by make_mesh_train_step's
    step; one device otherwise. Either step is graphed on the card."""
    n = len(labels)
    if n < batch_size:
        raise ValueError(f"need at least batch_size={batch_size} examples, "
                         f"got {n}: zero steps would silently return the "
                         "initial params")
    if mesh is None:
        dev = resolve_device(device)
        model = AlexNet.trainable(params, device=dev)
        _, step = make_train_step(model, learning_rate=learning_rate,
                                  clip_norm=1.0, keep_prob=keep_prob,
                                  compute_dtype=compute_dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def result():
            return params_to_numpy(dict(model.named_parameters()))
    else:
        from svision_tpu_torch.parallel import mesh as M
        place = (M.shard_params_tp if len(mesh[0]) > 1
                 else M.replicate_params)
        cells = place(params, mesh)
        dev = mesh[0][0]
        _, step = make_mesh_train_step(cells, learning_rate=learning_rate,
                                       clip_norm=1.0, keep_prob=keep_prob,
                                       compute_dtype=compute_dtype)
        gen = {d: torch.Generator(device=d).manual_seed(seed)
               for row in mesh for d in row}

        def result():
            return M.gather_params(cells)

    nprng = np.random.RandomState(seed)
    specs = np.asarray(specs)
    labels = torch.from_numpy(np.asarray(labels, np.int64))
    history: List[float] = []
    for epoch in range(epochs):
        order = nprng.permutation(n)
        losses = []
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            flip = augment and bool(nprng.randint(2))
            images = specs_to_images(specs[idx], flip=flip,
                                     jitter_rng=nprng if augment else None,
                                     device=dev)
            losses.append(step(images, labels[idx].to(dev), gen))
        history.append(torch.stack(losses).mean().item())
        if log:
            log(f"epoch {epoch}: mean loss {history[-1]:.4f}")
    return result(), history


def make_device_step(model: AlexNet, ep_d, vis_d, rev_d, labels_d,
                     generator: torch.Generator, *, batch_size: int,
                     learning_rate: float = 5e-3, keep_prob: float = 0.5,
                     compute_dtype=torch.float32, augment: bool = True,
                     s2d: bool = True, noise_aug: bool = False,
                     pixel_drop: float = 0.02, split_prob: float = 0.3,
                     eager: bool = False):
    """fit_device's step over a device-resident endpoint table (ep_d,
    vis_d, rev_d from specs_to_endpoints, labels_d): returns (optimizer,
    step), where step(idx, flip) trains on the rows idx (int64 [batch_size]
    on the device) and returns the loss. It gathers the rows, jitters them, fragments them, flips them (flip, a
    bool scalar tensor), rasterizes and drops pixels, as the JAX scan body
    does (svision_tpu/models/train.py:368-404), then takes the train step
    (clip 1, SGD momentum 0.9), every draw from generator.

    s2d=True renders the {0,1} raster straight into conv1's space-to-depth
    layout (the plain render_raster_s2d: no kernel) and trains through the
    in-graph fold (forward_train_s2d); the flip is an endpoint mirror
    (c -> 226 - c), which can differ from the image flip on Bresenham tie
    pixels. s2d=False renders mean-subtracted images with K1, fragmented
    segments included, and flips them; pixel drop is the s2d path's alone,
    as in JAX.

    On the card, unless eager, one CUDA graph holds the whole step after
    its first graphs.WARMUP_STEPS eager steps: the host copies idx and flip
    into static buffers and replays. Each step is traced (trace.py) as the
    span train.step, its phase 'eager', 'capture' or 'replay', with a
    device span of the same name around its work on the card."""
    dev = ep_d.device
    opt, train, reset = _sgd_step(model, learning_rate, 1.0, keep_prob,
                                  compute_dtype, s2d)
    raster_dtype = (torch.bfloat16 if compute_dtype == torch.bfloat16
                    else torch.float32)
    idx_s = torch.zeros(batch_size, dtype=torch.int64, device=dev)
    flip_s = torch.zeros((), dtype=torch.bool, device=dev)

    def body():
        ep_b, vis_b, rev_b = ep_d[idx_s], vis_d[idx_s], rev_d[idx_s]
        if augment:
            ep_b = jitter_endpoints_torch(ep_b, generator)
        if noise_aug:
            ep_b, vis_b, rev_b = fragment_endpoints_torch(
                ep_b, vis_b, rev_b, generator, split_prob=split_prob)
        if s2d:
            mirrored = ep_b.clone()
            mirrored[..., 0::2] = CANVAS - 1 - ep_b[..., 0::2]
            ep_b = torch.where(flip_s, mirrored, ep_b)
            images = rasterize.render_raster_s2d(ep_b, vis_b, rev_b,
                                                 dtype=raster_dtype)
            if noise_aug and pixel_drop > 0:
                keep = torch.rand(images.shape, generator=generator,
                                  device=dev) < 1.0 - pixel_drop
                images = images * keep.to(images.dtype)
        else:
            images = render_images(ep_b, vis_b, rev_b, dtype=torch.float32)
            images = torch.where(flip_s, images.flip(2), images)
        return train(images, labels_d[idx_s], generator)

    if eager or dev.type != "cuda":
        def run():
            reset()
            return body()
    else:
        run = graphs.StepGraph(body, reset, dev, generator)

    def step(idx, flip):
        with trace.span("train.step") as sp, \
                trace.device_span("train.step", dev):
            if sp:
                sp.set(phase=run.phase if isinstance(run, graphs.StepGraph)
                       else "eager")
            idx_s.copy_(idx)
            flip_s.copy_(flip)
            return run().clone()

    return opt, step


def fit_device(params, specs, labels, *, epochs: int = 16,
               batch_size: int = 32, seed: int = 0,
               learning_rate: float = 5e-3, keep_prob: float = 0.5,
               compute_dtype=torch.float32, augment: bool = True,
               s2d: bool = True, noise_aug: bool = False,
               pixel_drop: float = 0.02, split_prob: float = 0.3,
               device=None, log=None):
    """Device-resident training: the endpoint table, labels, parameters
    and optimizer state stay on the device, and shuffle, jitter,
    fragmentation, the flip, the raster, pixel drop and the step all run
    there from one device generator, with no host sync per step; the
    loss is read once per epoch. The step is make_device_step's (a CUDA
    graph on the card); the per-epoch shuffle and flips stay outside it.

    Returns (params, history) like fit()."""
    dev = resolve_device(device)
    specs = np.asarray(specs)
    labels_np = np.asarray(labels, np.int64)
    n = len(labels_np)
    steps = n // batch_size
    if steps == 0:
        raise ValueError(f"need >= {batch_size} examples, have {n}")
    ep_d, vis_d, rev_d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in rasterize.specs_to_endpoints(specs))
    labels_d = torch.from_numpy(labels_np).to(dev)
    model = AlexNet.trainable(params, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    _, step = make_device_step(
        model, ep_d, vis_d, rev_d, labels_d, gen, batch_size=batch_size,
        learning_rate=learning_rate, keep_prob=keep_prob,
        compute_dtype=compute_dtype, augment=augment, s2d=s2d,
        noise_aug=noise_aug, pixel_drop=pixel_drop, split_prob=split_prob)
    epoch_means = []
    for epoch in range(epochs):
        idxs = torch.randperm(n, generator=gen, device=dev)[
            :steps * batch_size].view(steps, batch_size)
        flips = (torch.rand(steps, generator=gen, device=dev) < 0.5
                 if augment else torch.zeros(steps, dtype=torch.bool,
                                             device=dev))
        losses = [step(idxs[s], flips[s]) for s in range(steps)]
        epoch_means.append(torch.stack(losses).mean())
        if log:
            log(f"epoch {epoch}: mean loss {epoch_means[-1].item():.4f}")
    history = torch.stack(epoch_means).tolist()
    return params_to_numpy(dict(model.named_parameters())), history


def evaluate(params, specs, labels, batch_size: int = 64,
             device=None) -> float:
    """Argmax accuracy on labeled specs through the f32 inference forward
    (K1 renders each batch, K2 follows conv1 and conv2 on the card)."""
    dev = resolve_device(device)
    model = AlexNet.from_params(
        {k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()},
        device=dev)
    labels = np.asarray(labels)
    specs = np.asarray(specs)
    n = len(labels)
    correct = 0
    with torch.inference_mode(), exact_f32():
        for i in range(0, n, batch_size):
            logits = model(specs_to_images(specs[i:i + batch_size], device=dev))
            correct += int((logits.argmax(1).cpu().numpy()
                            == labels[i:i + batch_size]).sum())
    return correct / n


def main(argv=None):
    """CLI: train from an .npz with `specs` [N,12] and `labels` [N]
    (class ids 0=DEL 1=INS 2=INV 3=DUP 4=tDUP, predict.py:133-142)."""
    import argparse
    from svision_tpu_torch.models.checkpoint import load_params, save_params

    ap = argparse.ArgumentParser(description="svision-tpu CNN trainer (torch)")
    ap.add_argument("--data", required=True, help=".npz with specs + labels")
    ap.add_argument("-o", dest="out", required=True, help="output .npz weights")
    ap.add_argument("--init", default=None, help="warm-start weights")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (f32 master weights, logits and loss)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ns = ap.parse_args(argv)

    dev = resolve_device(ns.device)
    with np.load(ns.data) as z:
        specs, labels = z["specs"], z["labels"]
    params = (load_params(ns.init) if ns.init
              else alexnet.init_params(ns.seed))
    params, history = fit(params, specs, labels, epochs=ns.epochs,
                          batch_size=ns.batch_size, seed=ns.seed,
                          learning_rate=ns.lr, log=print, device=dev,
                          compute_dtype=torch.bfloat16 if ns.bf16
                          else torch.float32)
    save_params(params, ns.out)
    print(f"saved {ns.out}; final loss {history[-1]:.4f}")


if __name__ == "__main__":
    main()
