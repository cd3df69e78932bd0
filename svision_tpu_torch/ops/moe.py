"""The sparse layer of a V-MoE on the card: routing, dispatch, the experts'
bias and GELU, and the combine as hand-written CUDA kernels around two
grouped matrix products, with no host synchronisation and fixed shapes, so
that the engine's CUDA graph of a replica's step (graphs.py) holds it.

Replaces no TPU kernel: the JAX package runs no mixture of experts. The
layer (Riquelme et al., "Scaling Vision with Sparse Mixture of Experts",
NeurIPS 2021), for a sparse layer's residual input y [T,D] and its
LayerNorm u = LN2(y), with E experts of width M and k experts a token:

  logits = u W_r                       f32 [T,E], W_r [D,E] kept in f32
  g = TOP_k(softmax(logits))           all but the k largest zeroed, the
                                       rest not renormalised
  out = y + sum_e g_e (W2_e GELU(W1_e u + b1_e) + b2_e)

Every token reaches its k experts (no capacity): the T*k rows are a fixed
shape, and only their order depends on the data. The steps (moe_mlp):

  moe_route      the top-k experts and gates of each token, each pair's
                 rank in its block of ROUTE_TOKENS tokens, each block's
                 first slot of each expert, the experts' cumulative ends
                 (offsets), and each expert's rows added into the
                 replica's histogram
  moe_dispatch   u's rows gathered into expert order [T*k, D], and each
                 pair's slot
  expert_mm      a grouped product: rows offsets[e-1]:offsets[e] times
                 expert e's matrix (torch._grouped_mm on the card, which
                 reads the offsets on the device)
  moe_bias_gelu  in place: each row's expert's bias, then the exact GELU
  moe_combine    y + sum_j g_j (h[slot_j] + b2[e_j]) in token order

Slots follow (expert, token, j) order. The kernels are csrc/moe.cu; each
wrapper takes its plain version (the *_plain functions) for CPU tensors,
and for CUDA tensors launches its kernel or raises. The kernels take bf16
activations: f32 runs only where the plain versions do.

Bound on an H100, at the engine's batch of 128 images (T = 25,216 tokens,
k = 2, D = 768, M = 3,072): the grouped products by operations (238 GFLOP
each); dispatch, bias-GELU and combine by bytes (117, 620 and 156 MB);
the route by latency (3.9 MB).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from svision_tpu_torch.ops import _kernels

# tokens a route block: kRouteTokens in csrc/moe.cu; the route's ranks and
# bases are per block of these
ROUTE_TOKENS = 128
MAX_EXPERTS = 128
MAX_K = 8


def _blocks(tokens: int) -> int:
    return -(-tokens // ROUTE_TOKENS)


def moe_route_plain(logits: torch.Tensor, k: int,
                    rows: Optional[torch.Tensor] = None):
    """Plain PyTorch version of moe_route: the same outputs bit for bit but
    the gates, which round exp and the softmax's sum otherwise (within f32
    rounding)."""
    t, e = logits.shape
    dev = logits.device
    x = logits.float()
    # a stable sort of descending logits: the lower index first on ties
    top = torch.sort(x, dim=1, descending=True, stable=True)[1][:, :k]
    gates = torch.softmax(x, dim=1).gather(1, top)
    flat = top.reshape(-1)
    # each pair's slot: its place in (expert, token, j) order
    order = torch.sort(flat, stable=True)[1]
    slot = torch.empty_like(order)
    slot[order] = torch.arange(flat.numel(), device=dev)
    block = torch.arange(t, device=dev).repeat_interleave(k) // ROUTE_TOKENS
    nb = _blocks(t)
    counts = torch.zeros(nb * e, dtype=torch.int64, device=dev)
    counts.index_add_(0, block * e + flat, torch.ones_like(flat))
    counts = counts.view(nb, e)
    total = counts.sum(0)
    offsets = total.cumsum(0)
    bases = (offsets - total)[None, :] + counts.cumsum(0) - counts
    ranks = slot - bases[block, flat]
    if rows is not None:
        rows += total.to(rows.dtype)
    i32 = torch.int32
    return (top.to(i32), gates, ranks.view(t, k).to(i32), bases.to(i32),
            offsets.to(i32))


def moe_route(logits: torch.Tensor, k: int,
              rows: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, ...]:
    """Router logits f32 [T,E] -> (top int32 [T,k], the experts of each
    token, largest logit first and the lower index on ties; gates f32
    [T,k], softmax(logits) at them; ranks int32 [T,k], each pair's place
    among the pairs of its block of ROUTE_TOKENS tokens that chose its
    expert; bases int32 [blocks,E], each block's first slot of each
    expert; offsets int32 [E], the experts' cumulative ends). rows int64
    [E], if given, gains each expert's rows in place."""
    if logits.device.type == "cpu":
        return moe_route_plain(logits, k, rows)
    _kernels.check_cuda(logits, *(() if rows is None else (rows,)))
    t, e = logits.shape if logits.dim() == 2 else (0, 0)
    if (logits.dtype != torch.float32 or not logits.is_contiguous() or t < 1
            or not 1 <= k <= min(e, MAX_K) or e > MAX_EXPERTS):
        raise ValueError(f"moe_route: expected contiguous f32 [T,E] logits, "
                         f"E <= {MAX_EXPERTS}, 1 <= k <= min(E, {MAX_K}); "
                         f"got {logits.dtype} {tuple(logits.shape)}, k={k}")
    if rows is not None and (rows.dtype != torch.int64
                             or tuple(rows.shape) != (e,)
                             or not rows.is_contiguous()):
        raise ValueError(f"moe_route: rows must be contiguous int64 [{e}], "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    dev = logits.device
    i32 = dict(dtype=torch.int32, device=dev)
    top = torch.empty((t, k), **i32)
    gates = torch.empty((t, k), dtype=torch.float32, device=dev)
    ranks = torch.empty((t, k), **i32)
    bases = torch.empty((_blocks(t), e), **i32)
    offsets = torch.empty(e, **i32)
    ticket = torch.zeros(1, **i32)
    with torch.cuda.device(dev):
        _kernels.launch("svt_moe_route", logits.data_ptr(), top.data_ptr(),
                        gates.data_ptr(), ranks.data_ptr(), bases.data_ptr(),
                        offsets.data_ptr(),
                        None if rows is None else rows.data_ptr(),
                        ticket.data_ptr(), t, e, k,
                        _kernels.stream_of(logits))
    moe_route.launches += 1
    return top, gates, ranks, bases, offsets


moe_route.launches = 0


def moe_dispatch_plain(u, top, ranks, bases):
    """Plain PyTorch version of moe_dispatch, bit for bit."""
    t, k = top.shape
    block = torch.arange(t, device=u.device)[:, None] // ROUTE_TOKENS
    slots = bases.long()[block, top.long()] + ranks.long()
    xs = torch.empty((t * k, u.shape[1]), dtype=u.dtype, device=u.device)
    xs[slots.reshape(-1)] = u.repeat_interleave(k, dim=0)
    return xs, slots.to(torch.int32)


def _check_rows(name: str, dim: int, *tensors) -> None:
    """bf16 activations, contiguous, of a width of whole 16-byte vectors, on
    16-byte-aligned addresses: the kernels read and write them as such."""
    for x in tensors:
        if (x.dtype != torch.bfloat16 or not x.is_contiguous()
                or x.shape[-1] != dim or dim % 8 or x.data_ptr() % 16):
            raise ValueError(f"{name}: expected contiguous 16-byte-aligned "
                             f"bf16 rows of a width divisible by 8, got "
                             f"{x.dtype} {tuple(x.shape)}")


def _check_pairs(name: str, t: int, k: int, *tensors) -> None:
    for x in tensors:
        if (tuple(x.shape) != (t, k) or not x.is_contiguous()
                or x.dtype not in (torch.int32, torch.float32)):
            raise ValueError(f"{name}: expected contiguous [{t},{k}] int32 or "
                             f"f32 pairs, got {x.dtype} {tuple(x.shape)}")


def moe_dispatch(u: torch.Tensor, top: torch.Tensor, ranks: torch.Tensor,
                 bases: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u [T,D] and moe_route's top, ranks and bases -> (xs [T*k, D], u's
    rows in expert order, row t at each of its slots; slots int32 [T,k])."""
    if u.device.type == "cpu":
        return moe_dispatch_plain(u, top, ranks, bases)
    _kernels.check_cuda(u, top, ranks, bases)
    t, d = u.shape
    k = top.shape[1] if top.dim() == 2 else 0
    _check_rows("moe_dispatch", d, u)
    _check_pairs("moe_dispatch", t, k, top, ranks)
    if not 1 <= k <= MAX_K or bases.shape[0] != _blocks(t):
        raise ValueError(f"moe_dispatch: k={k} and bases "
                         f"{tuple(bases.shape)} do not fit {t} tokens")
    xs = torch.empty((t * k, d), dtype=u.dtype, device=u.device)
    slots = torch.empty((t, k), dtype=torch.int32, device=u.device)
    with torch.cuda.device(u.device):
        _kernels.launch("svt_moe_dispatch", u.data_ptr(), top.data_ptr(),
                        ranks.data_ptr(), bases.data_ptr(), slots.data_ptr(),
                        xs.data_ptr(), t, d, bases.shape[1], k,
                        _kernels.stream_of(u))
    moe_dispatch.launches += 1
    return xs, slots


moe_dispatch.launches = 0


def expert_mm_plain(x: torch.Tensor, w: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of expert_mm: one product an expert over its rows."""
    out = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    start = 0
    for e, end in enumerate(offsets.tolist()):
        out[start:end] = x[start:end] @ w[e]
        start = end
    return out


def expert_mm(x: torch.Tensor, w: torch.Tensor,
              offsets: torch.Tensor) -> torch.Tensor:
    """Rows in expert order x [R,K] times each expert's matrix w [E,K,N]:
    rows offsets[e-1]:offsets[e] (offsets int32 [E], cumulative ends) by
    w[e] -> [R,N]. On the card one torch._grouped_mm, which reads the
    offsets on the device, so it needs no host synchronisation."""
    if x.device.type == "cpu":
        return expert_mm_plain(x, w, offsets)
    return torch._grouped_mm(x, w, offs=offsets)


def moe_bias_gelu_plain(h: torch.Tensor, bias: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of moe_bias_gelu, in place: the same arithmetic in f32
    (erf rounds otherwise on the card's cores, within f32 rounding)."""
    row = torch.arange(h.shape[0], device=h.device)
    expert = torch.searchsorted(offsets.long(), row, right=True)
    v = h.float() + bias[expert].float()
    h.copy_(v * 0.5 * (1.0 + torch.erf(v * 0.7071067811865476)))
    return h


def moe_bias_gelu(h: torch.Tensor, bias: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """In place over the rows in expert order h [R,M]: GELU(h + bias[e])
    with e each row's expert (from offsets), the exact (erf) GELU in f32,
    rounded once. Returns h."""
    if h.device.type == "cpu":
        return moe_bias_gelu_plain(h, bias, offsets)
    _kernels.check_cuda(h, bias, offsets)
    r, m = h.shape
    _check_rows("moe_bias_gelu", m, h, bias)
    if (offsets.dtype != torch.int32 or offsets.shape != (bias.shape[0],)
            or r < 1):
        raise ValueError(f"moe_bias_gelu: offsets must be int32 "
                         f"[{bias.shape[0]}] over at least one row, got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    with torch.cuda.device(h.device):
        _kernels.launch("svt_moe_bias_gelu", h.data_ptr(), bias.data_ptr(),
                        offsets.data_ptr(), r, m, bias.shape[0],
                        _kernels.stream_of(h))
    moe_bias_gelu.launches += 1
    return h


moe_bias_gelu.launches = 0


def moe_combine_plain(y, h, bias, top, gates, slots):
    """Plain version of moe_combine, bit for bit: the same f32 operations
    in the same order."""
    acc = y.float()
    for j in range(top.shape[1]):
        acc = acc + gates[:, j:j + 1] * (h[slots[:, j].long()].float()
                                         + bias[top[:, j].long()].float())
    return acc.to(y.dtype)


def moe_combine(y: torch.Tensor, h: torch.Tensor, bias: torch.Tensor,
                top: torch.Tensor, gates: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
    """y [T,D] + sum_j gates[:, j] (h[slots[:, j]] + bias[top[:, j]]), in
    f32, rounded once to y's dtype: the experts' outputs h [T*k, D] in
    expert order brought back to token order with the residual."""
    if y.device.type == "cpu":
        return moe_combine_plain(y, h, bias, top, gates, slots)
    _kernels.check_cuda(y, h, bias, top, gates, slots)
    t, d = y.shape
    k = top.shape[1] if top.dim() == 2 else 0
    _check_rows("moe_combine", d, y, h, bias)
    _check_pairs("moe_combine", t, k, top, gates, slots)
    if (h.shape[0] != t * k or not 1 <= k <= MAX_K
            or gates.dtype != torch.float32):
        raise ValueError(f"moe_combine: h {tuple(h.shape)} and f32 gates "
                         f"must hold {t} tokens x k={k}")
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        _kernels.launch("svt_moe_combine", y.data_ptr(), h.data_ptr(),
                        bias.data_ptr(), top.data_ptr(), gates.data_ptr(),
                        slots.data_ptr(), out.data_ptr(), t, d, k,
                        _kernels.stream_of(y))
    moe_combine.launches += 1
    return out


moe_combine.launches = 0


def moe_mlp(y: torch.Tensor, u: torch.Tensor, router: torch.Tensor,
            w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor, k: int, rows: Optional[torch.Tensor] = None,
            routing: Optional[list] = None) -> torch.Tensor:
    """A sparse layer's y + MoE(u) (the module docstring's equations) over
    tokens y, u [T,D]: router [D,E] f32, w1 [E,D,M], b1 [E,M], w2 [E,M,D],
    b2 [E,D] in u's dtype. rows int64 [E], if given, gains each expert's
    rows; routing, if given, gains the experts of each token (moe_route's
    top)."""
    top, gates, ranks, bases, offsets = moe_route(u.float() @ router, k, rows)
    if routing is not None:
        routing.append(top)
    xs, slots = moe_dispatch(u, top, ranks, bases)
    h = moe_bias_gelu(expert_mm(xs, w1, offsets), b1, offsets)
    return moe_combine(y, expert_mm(h, w2, offsets), b2, top, gates, slots)
