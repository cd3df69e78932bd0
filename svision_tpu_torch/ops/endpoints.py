"""A dispatch's endpoints on the card: candidate specs -> clipped pixel
endpoints, as a hand-written CUDA kernel.

Replaces no TPU kernel: the JAX package makes the endpoints on the host
(svision_tpu/ops/rasterize.py:specs_to_endpoints, numpy), and so does the
port's rasterize.specs_to_endpoints, which the trainers still call once in
their set-up. The engine ships each dispatch's raw specs instead and calls
specs_endpoints at the head of each replica's step (infer/engine.py), so
the host thread does no per-row arithmetic. The kernel is
csrc/specs_endpoints.cu; its plain version is specs_endpoints_plain below,
which a CPU tensor goes to. A CUDA tensor launches the kernel or raises.

Bound on an H100: latency. A row reads 96 bytes and writes 36: a chunk of
1,024 rows moves 135 KB, 40 ns at 3.35 TB/s.
"""

from __future__ import annotations

from typing import Tuple

import torch

from svision_tpu_torch.ops import _kernels
from svision_tpu_torch.ops.rasterize import CANVAS, SEGS

FIELDS = 12   # bed columns 1-12 of a candidate spec


def _tdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Truncating int64 division; a zero divisor gives the dividend
    (bresenham.clip_lines_batch's guarded divide)."""
    return torch.div(a, torch.where(b == 0, torch.ones_like(b), b),
                     rounding_mode="trunc")


def _clip(x1, y1, x2, y2) -> Tuple[torch.Tensor, torch.Tensor]:
    """bresenham.clip_lines_batch on int64 tensors: cv::clipLine's fixed
    two-phase clip to the canvas -> ([..., 4] int32, visible)."""
    right = bottom = CANVAS - 1

    def code(x, y):
        return ((x < 0).long() + (x > right) * 2 + (y < 0) * 4
                + (y > bottom) * 8)

    c1, c2 = code(x1, y1), code(x2, y2)
    work = ((c1 & c2) == 0) & ((c1 | c2) != 0)

    fix = work & ((c1 & 12) != 0)
    a = torch.where(c1 < 8, 0, bottom)
    x1 = torch.where(fix, x1 + _tdiv((a - y1) * (x2 - x1), y2 - y1), x1)
    y1 = torch.where(fix, a, y1)
    c1 = torch.where(work, code(x1, y1) & 3, c1)

    fix = work & ((c2 & 12) != 0)
    a = torch.where(c2 < 8, 0, bottom)
    x2 = torch.where(fix, x2 + _tdiv((a - y2) * (x2 - x1), y2 - y1), x2)
    y2 = torch.where(fix, a, y2)
    c2 = torch.where(work, code(x2, y2) & 3, c2)

    work2 = work & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    fix = work2 & (c1 != 0)
    a = torch.where(c1 == 1, 0, right)
    y1 = torch.where(fix, y1 + _tdiv((a - x1) * (y2 - y1), x2 - x1), y1)
    x1 = torch.where(fix, a, x1)
    c1 = torch.where(fix, 0, c1)
    fix = work2 & (c2 != 0)
    a = torch.where(c2 == 1, 0, right)
    y2 = torch.where(fix, y2 + _tdiv((a - x2) * (y2 - y1), x2 - x1), y2)
    x2 = torch.where(fix, a, x2)
    c2 = torch.where(fix, 0, c2)

    alive = (c1 | c2) == 0
    return torch.stack([x1, y1, x2, y2], dim=-1).to(torch.int32), alive


def specs_endpoints_plain(specs: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: rasterize.specs_to_endpoints' arithmetic in
    int64 and float64 tensor ops, bit for bit. specs [N,12] (integer, or
    float truncated toward zero as np.asarray(specs, np.int64) does) ->
    (endpoints int32 [N,2,4], visible bool [N,2], reverse bool [N,2])."""
    s = specs.to(torch.int64).reshape(-1, FIELDS)
    # views, no index tensor: a CUDA graph may capture this version too
    seg = s[:, :5 * SEGS].reshape(-1, SEGS, 5)
    xs, ys, ye_orig = seg[..., 0], seg[..., 2], seg[..., 3]
    fwd = seg[..., 4] != 0
    # segment rebuild (create_batch.py:118,132)
    length = ye_orig - ys
    xe = torch.where(fwd, xs + (length - 1), xs - (length - 1))
    ye = ys + (length - 1)
    # ratio clamp (plot_segment.py:12-15), float64, truncated toward 0;
    # every divisor a tensor: torch on the card multiplies by the
    # reciprocal of a scalar divisor, which is not the IEEE quotient
    longest = torch.maximum(s[:, 10], s[:, 11]).double()
    ratio = torch.clamp(longest / torch.full_like(longest, 227.0),
                        min=1.0)[:, None]

    def scale(v):
        return torch.trunc(v.double() / ratio).long()

    clipped, visible = _clip(scale(ys), scale(xs), scale(ye), scale(xe))
    return clipped, visible, ~fwd


def specs_endpoints(specs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate specs int64 [N,12] -> (endpoints int32 [N,2,4] clipped to
    the canvas, visible bool [N,2], reverse bool [N,2]), the arrays
    rasterize.specs_to_endpoints makes on the host, bit for bit."""
    if specs.device.type == "cpu":
        return specs_endpoints_plain(specs)
    _kernels.check_cuda(specs)
    if (specs.dtype != torch.int64 or specs.dim() != 2
            or specs.shape[1] != FIELDS or not specs.is_contiguous()):
        raise ValueError(f"specs_endpoints: expected contiguous int64 "
                         f"[N,{FIELDS}], got {specs.dtype} "
                         f"{tuple(specs.shape)}")
    n = specs.shape[0]
    ep = torch.empty((n, SEGS, 4), dtype=torch.int32, device=specs.device)
    vis = torch.empty((n, SEGS), dtype=torch.bool, device=specs.device)
    rev = torch.empty((n, SEGS), dtype=torch.bool, device=specs.device)
    if n:
        with torch.cuda.device(specs.device):
            _kernels.launch("svt_specs_endpoints", specs.data_ptr(),
                            ep.data_ptr(), vis.data_ptr(), rev.data_ptr(), n,
                            _kernels.stream_of(specs))
        specs_endpoints.launches += 1
    return ep, vis, rev


specs_endpoints.launches = 0
