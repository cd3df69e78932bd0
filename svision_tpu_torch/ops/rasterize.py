"""Similarity-image encoder in plain PyTorch: segment pairs -> {0,1} rasters.

Counterpart of the JAX package's ops/rasterize.py. These are the plain
versions of the port's raster kernels (ops/raster_kernel.py and
ops/fused_conv1.py): tensor code that runs on any device, bit-exact against
the JAX functions, and the reference the CUDA kernels are held against.
render_raster and render_raster_einsum are also two of the engine's raster
encoders on the card ('compare' and 'einsum', infer/engine.py).

Semantics replicated bit-for-bit from the reference (create_batch.py:101-152,
plot_segment.py:33-73):
  * segment rebuild from bed fields and the ratio clamp are host numpy
    (specs_to_endpoints), computed in float64 like Python's int()
  * image row = read coordinate (x), column = ref coordinate (y)
  * channel 0 = all segments; channel 2 = reverse segments only; channel 1 =
    columns of ch0 with >=2 lit rows keep those rows
  * values {0,255}, then float32 minus mean [104,117,124]

Pixel membership is the closed form of cv.line's 8-connected Bresenham walk
with k(i) = max(0, ceil((2*minor*i - major)/(2*major))). `num` is negative at
i = 0, so every division here is an explicit floor division.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from svision_tpu_torch.ops import bresenham
from svision_tpu_torch.models.alexnet import image_mean

CANVAS = 227
SEGS = 2          # candidate records carry exactly two segments
MAX_STEPS = 227   # a clipped line has at most CANVAS pixels
_S2D_F = 4        # space-to-depth factor (== alexnet._S2D)
S2D_BLOCKS = (CANVAS + _S2D_F - 1) // _S2D_F     # 57


def specs_to_endpoints(specs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host preprocessing: candidate specs -> clipped pixel endpoints.

    specs: int64/float [N, 12] with columns
        xs1, xe1, ys1, ye1, fwd1, xs2, xe2, ys2, ye2, fwd2, read_len, ref_len
    (bed columns 1-12; x = read axis, y = ref axis).

    Returns (endpoints int32 [N, SEGS, 4] as (col0,row0,col1,row1) clipped to
    the canvas, visible bool [N, SEGS], reverse bool [N, SEGS]).
    """
    s = np.asarray(specs, dtype=np.int64).reshape(-1, 12)

    xs = np.stack([s[:, 0], s[:, 5]], axis=1)
    ys = np.stack([s[:, 2], s[:, 7]], axis=1)
    ye_orig = np.stack([s[:, 3], s[:, 8]], axis=1)
    fwd = np.stack([s[:, 4], s[:, 9]], axis=1) != 0

    # Segment rebuild (create_batch.py:118,132): length = ye - ys;
    # xe = xs +/- (length-1); ye = ys + (length-1).
    length = ye_orig - ys
    xe = np.where(fwd, xs + (length - 1), xs - (length - 1))
    ye = ys + (length - 1)

    # ratio clamp (plot_segment.py:12-15); float64 division + trunc toward 0
    # to match Python's int() exactly.
    ratio = np.maximum(s[:, 10], s[:, 11]).astype(np.float64) / 227.0
    ratio = np.maximum(ratio, 1.0)[:, None]

    col0 = np.trunc(ys / ratio).astype(np.int64)   # cv point x = ref axis
    row0 = np.trunc(xs / ratio).astype(np.int64)   # cv point y = read axis
    col1 = np.trunc(ye / ratio).astype(np.int64)
    row1 = np.trunc(xe / ratio).astype(np.int64)

    pts = np.stack([col0, row0, col1, row1], axis=-1)
    clipped, visible = bresenham.clip_lines_batch(pts, CANVAS, CANVAS)
    return clipped.astype(np.int32), visible, ~fwd


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _segments(endpoints: torch.Tensor):
    """Left-to-right normalized line parameters, each int32 [N,S]."""
    ep = endpoints.to(torch.int32)
    c0, r0, c1, r1 = (ep[..., i] for i in range(4))
    swap = c1 < c0
    c0n = torch.where(swap, c1, c0)
    r0n = torch.where(swap, r1, r0)
    r1n = torch.where(swap, r0, r1)
    dx = torch.where(swap, c0, c1) - c0n                       # >= 0
    dy = r1n - r0n
    sy = torch.where(dy >= 0, 1, -1).to(torch.int32)
    ady = dy.abs()
    xmajor = dx >= ady
    major = torch.maximum(dx, ady)
    minor = torch.minimum(dx, ady)
    return c0n, r0n, sy, xmajor, major, minor


def _k_of(i, minorb, majorb):
    """Bresenham minor-axis offset k(i) (closed form)."""
    num = 2 * minorb * i - majorb
    k = torch.clamp(-_floordiv(-num, torch.clamp(2 * majorb, min=1)), min=0)
    return torch.where(majorb == 0, 0, k)


def _k_runs(j, majorb, minorb):
    """Inverse Bresenham: the run [ilo, ihi] of major-axis indices i with
    k(i) == j (minor == 0 means the whole line is one run)."""
    den = torch.clamp(2 * minorb, min=1)
    ilo = torch.clamp(_floordiv(majorb * (2 * j - 1), den) + 1, min=0)
    ihi = torch.minimum(majorb, _floordiv(majorb * (2 * j + 1), den))
    ilo = torch.where(minorb == 0, 0, ilo)
    ihi = torch.where(minorb == 0, majorb, ihi)
    return ilo, ihi


def _line_walk(endpoints: torch.Tensor):
    """Per-line pixel walk, closed form. endpoints int32 [..., 4]
    (c0,r0,c1,r1) -> (cols, rows, valid), each [..., MAX_STEPS], int32 /
    bool: step i of a line lies at (rows[i], cols[i]) while valid[i]."""
    c0n, r0n, sy, xmajor, major, minor = _segments(endpoints)
    i = torch.arange(MAX_STEPS, dtype=torch.int32, device=endpoints.device)
    majorb = major[..., None]
    minorb = minor[..., None]
    valid = i <= majorb
    k = _k_of(i, minorb, majorb)
    xm = xmajor[..., None]
    cols = torch.where(xm, c0n[..., None] + i, c0n[..., None] + k)
    rows = torch.where(xm, r0n[..., None] + sy[..., None] * k,
                       r0n[..., None] + sy[..., None] * i)
    return cols, rows, valid


def render_raster(endpoints: torch.Tensor, visible: torch.Tensor,
                  reverse: torch.Tensor, *, dtype=torch.bfloat16) -> torch.Tensor:
    """[N,SEGS,4] clipped endpoints -> {0,1} raster [N,227,227,3] (NHWC).

    Comparison formulation: pixel (r,c) is lit iff
      x-major:  c in [c0,c0+major]  and  r == r0 + sy*k(c-c0)
      y-major:  sy*(r-r0) in [0,major] and c == c0 + k(sy*(r-r0))
    """
    c0n, r0n, sy, xmajor, major, minor = _segments(endpoints)
    t = torch.arange(CANVAS, dtype=torch.int32, device=endpoints.device)
    t = t.reshape(1, 1, CANVAS)                                # [1,1,T]

    majorb = major[..., None]
    minorb = minor[..., None]
    seg_on = visible.bool()[..., None]

    # x-major: index along columns
    ix = t - c0n[..., None]                                    # [N,S,C]
    row_at_c = r0n[..., None] + sy[..., None] * _k_of(ix, minorb, majorb)
    valid_x = xmajor[..., None] & (ix >= 0) & (ix <= majorb) & seg_on
    # y-major: index along rows
    iy = sy[..., None] * (t - r0n[..., None])                  # [N,S,R]
    col_at_r = c0n[..., None] + _k_of(iy, minorb, majorb)
    valid_y = ~xmajor[..., None] & (iy >= 0) & (iy <= majorb) & seg_on

    # plane[n,s,r,c] = lit pixel of segment s
    plane = ((valid_x[..., None, :] & (t[..., None] == row_at_c[..., None, :]))
             | (valid_y[..., None] & (t[..., None, :] == col_at_r[..., None])))

    ch0 = plane.any(dim=1)                                     # [N,R,C]
    ch2 = (plane & reverse.bool()[..., None, None]).any(dim=1)
    # duplication channel: columns (ref axis) with >=2 lit rows
    # (plot_segment.py:59-65)
    col_rows = ch0.to(torch.int32).sum(dim=1, keepdim=True)
    ch1 = ch0 & (col_rows >= 2)
    return torch.stack([ch0, ch1, ch2], dim=-1).to(dtype)


def raster_tables(endpoints: torch.Tensor, visible: torch.Tensor):
    """The tables K1 (csrc/raster.cu) builds in shared memory, in plain
    tensor code: [N,S,4] clipped endpoints + visible [N,S] ->
      runs int32 [N,S,227,2]: the column run [clo, chi] segment s lights in
        each image row, (228, -1) where it lights none (row_run);
      col_rows int32 [N,227]: the lit rows of channel 0 in each column, the
        size of the union of the segments' row runs there (col_rows_n).
    raster_from_tables expands them into render_raster's raster. Nothing on
    the main path calls these two: they are the plain twin of the kernel's
    tables, held against the JAX package in the tests."""
    c0n, r0n, sy, xmajor, major, minor = _segments(endpoints)
    t = torch.arange(CANVAS, dtype=torch.int32, device=endpoints.device)

    def e(v):                       # [N,S] -> [N,S,1]
        return v[..., None]
    majorb, minorb, xm, seen = e(major), e(minor), e(xmajor), e(visible.bool())

    # row runs: row r is minor step j of an x-major line, major step j of a
    # y-major one
    j = e(sy) * (t - e(r0n))
    ilo, ihi = _k_runs(j, majorb, minorb)
    kj = _k_of(j, minorb, majorb)
    ok = seen & (j >= 0) & (j <= torch.where(xm, minorb, majorb))
    clo = torch.where(ok, e(c0n) + torch.where(xm, ilo, kj), CANVAS + 1)
    chi = torch.where(ok, e(c0n) + torch.where(xm, ihi, kj), -1)
    runs = torch.stack([clo, chi], dim=-1).to(torch.int32)

    # column runs of rows, then the size of their union per column: sorted
    # by start, each run adds its rows past the furthest end before it
    i = t - e(c0n)
    jlo, jhi = _k_runs(i, majorb, minorb)
    kx = _k_of(i, minorb, majorb)
    okc = seen & (i >= 0) & (i <= torch.where(xm, majorb, minorb))
    ra = e(r0n) + e(sy) * torch.where(xm, kx, jlo)
    rb = e(r0n) + e(sy) * torch.where(xm, kx, jhi)
    big = torch.iinfo(torch.int32).max
    rlo = torch.where(okc, torch.minimum(ra, rb), big)   # empty runs last
    rhi = torch.where(okc, torch.maximum(ra, rb), -1)
    rlo, order = torch.sort(rlo, dim=1, stable=True)
    rhi = torch.gather(rhi, 1, order)
    end = torch.cummax(rhi, dim=1).values
    before = torch.cat([torch.full_like(end[:, :1], -1), end[:, :-1]], dim=1)
    added = torch.clamp(rhi - torch.maximum(rlo, before + 1) + 1, min=0)
    col_rows = added.sum(dim=1).to(torch.int32)
    return runs, col_rows


def raster_from_tables(runs: torch.Tensor, col_rows: torch.Tensor,
                       reverse: torch.Tensor, *,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """raster_tables' runs [N,S,227,2] and col_rows [N,227] + reverse [N,S]
    -> {0,1} raster [N,227,227,3] (NHWC), as K1 expands them: a pixel is
    lit in channel 0 where a segment's run holds its column, in channel 2
    where a reverse segment's does, and in channel 1 where channel 0 is
    and its column has at least two lit rows."""
    c = torch.arange(CANVAS, dtype=torch.int32, device=runs.device)
    plane = (c >= runs[..., 0:1]) & (c <= runs[..., 1:2])    # [N,S,R,C]
    ch0 = plane.any(dim=1)
    ch2 = (plane & reverse.bool()[..., None, None]).any(dim=1)
    ch1 = ch0 & (col_rows[:, None, :] >= 2)
    return torch.stack([ch0, ch1, ch2], dim=-1).to(dtype)


def render_raster_s2d(endpoints: torch.Tensor, visible: torch.Tensor,
                      reverse: torch.Tensor, *, dtype=torch.bfloat16) -> torch.Tensor:
    """The raster emitted directly in conv1's space-to-depth layout:
    NHWC [N,57,57,48] with channel = ch*16 + p*4 + q for pixel (4R+p, 4C+q).

    "Runs" formulation: every line's row r holds a column run
    [clo(r), chi(r)] (inverse Bresenham for x-major lines, the single column
    k(j) for y-major ones), and the duplication channel's per-column lit-row
    counts are the union size of the two segments' row runs
    (inclusion-exclusion). Row/column 227, the s2d pad line, stays dark:
    clipped endpoints are <= 226."""
    c0n, r0n, sy, xmajor, major, minor = _segments(endpoints)
    visible = visible.bool()
    reverse = reverse.bool()

    dev = endpoints.device
    bc = torch.arange(S2D_BLOCKS, dtype=torch.int32, device=dev)
    sub = torch.arange(_S2D_F, dtype=torch.int32, device=dev)
    grid = _S2D_F * bc[:, None] + sub[None, :]                 # [57,4] coords

    def e(v):                       # [N,S] -> [N,S,1,1]
        return v[..., None, None]
    majorb, minorb, xm = e(major), e(minor), e(xmajor)

    # per-row column bounds [N,S,R,p]
    j = e(sy) * (grid[None, None] - e(r0n))
    ilo, ihi = _k_runs(j, majorb, minorb)
    kj = _k_of(j, minorb, majorb)
    ok = (torch.where(xm, (j >= 0) & (j <= minorb), (j >= 0) & (j <= majorb))
          & e(visible))
    clo = torch.where(ok, e(c0n) + torch.where(xm, ilo, kj), CANVAS + 1)
    chi = torch.where(ok, e(c0n) + torch.where(xm, ihi, kj), -1)

    # lit plane [N,S,R,C,p,q]: two compares against the per-row bounds
    cc = grid.reshape(1, 1, 1, S2D_BLOCKS, 1, _S2D_F)          # 4C+q
    lo = clo[:, :, :, None, :, None]
    hi = chi[:, :, :, None, :, None]
    plane = (cc >= lo) & (cc <= hi)
    rev6 = reverse[:, :, None, None, None, None]
    ch0 = plane[:, 0] | plane[:, 1]
    ch2 = (plane[:, 0] & rev6[:, 0]) | (plane[:, 1] & rev6[:, 1])

    # duplication channel: per-column lit-row counts [N,S,C,q]
    i_c = grid[None, None] - e(c0n)
    kx = _k_of(i_c, minorb, majorb)
    jlo, jhi = _k_runs(i_c, majorb, minorb)
    okc = (torch.where(xm, (i_c >= 0) & (i_c <= majorb),
                       (i_c >= 0) & (i_c <= minorb)) & e(visible))
    lo_j = torch.where(xm, kx, jlo)
    hi_j = torch.where(xm, kx, jhi)
    ra = e(r0n) + e(sy) * lo_j
    rb = e(r0n) + e(sy) * hi_j
    rlo = torch.where(okc, torch.minimum(ra, rb), 1)           # empty run
    rhi = torch.where(okc, torch.maximum(ra, rb), 0)
    cnt = torch.clamp(rhi - rlo + 1, min=0)
    inter = torch.clamp(torch.minimum(rhi[:, 0], rhi[:, 1])
                        - torch.maximum(rlo[:, 0], rlo[:, 1]) + 1, min=0)
    col_rows = cnt[:, 0] + cnt[:, 1] - inter                   # [N,C,q]
    ch1 = ch0 & (col_rows[:, None, :, None, :] >= 2)

    n = ch0.shape[0]
    out = torch.stack([ch0, ch1, ch2], dim=3)                  # [N,R,C,3,p,q]
    return out.reshape(n, S2D_BLOCKS, S2D_BLOCKS,
                       3 * _S2D_F * _S2D_F).to(dtype)


def render_raster_einsum(endpoints: torch.Tensor, visible: torch.Tensor,
                         reverse: torch.Tensor, *,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """[N,SEGS,4] clipped endpoints -> {0,1} raster [N,227,227,3] (NHWC),
    as a one-hot contraction: each line's walk becomes one-hot row and
    column vectors in bf16, and a pixel is lit iff the batched product of
    the two over every step of every segment is positive (a sum of {0,1}
    products, so its bf16 rounding keeps the sign)."""
    n = endpoints.shape[0]
    cols, rows, valid = _line_walk(endpoints)                  # [N,S,T]
    valid = valid & visible.bool()[..., None]
    t = torch.arange(CANVAS, dtype=torch.int32, device=endpoints.device)
    onehot_r = ((rows[..., None] == t) & valid[..., None]).to(torch.bfloat16)
    onehot_c = (cols[..., None] == t).to(torch.bfloat16)       # [N,S,T,227]
    k = endpoints.shape[1] * MAX_STEPS
    c_all = onehot_c.reshape(n, k, CANVAS)
    ch0 = torch.einsum("nkr,nkc->nrc", onehot_r.reshape(n, k, CANVAS),
                       c_all) > 0                               # [N,row,col]
    rev = reverse.bool()[..., None, None].to(torch.bfloat16)    # [N,S,1,1]
    ch2 = torch.einsum("nkr,nkc->nrc", (onehot_r * rev).reshape(n, k, CANVAS),
                       c_all) > 0
    # duplication channel: columns (ref axis) with >=2 lit rows
    # (plot_segment.py:59-65)
    col_rows = ch0.to(torch.int32).sum(dim=1, keepdim=True)
    ch1 = ch0 & (col_rows >= 2)
    return torch.stack([ch0, ch1, ch2], dim=-1).to(dtype)


def normalize_raster(raster: torch.Tensor) -> torch.Tensor:
    """{0,1} raster -> the reference's mean-subtracted tensor
    (create_batch.py:146-150): raster*255 - IMAGE_MEAN in raster's dtype."""
    return raster * 255.0 - image_mean(raster.dtype, raster.device)


def render_images(endpoints: torch.Tensor, visible: torch.Tensor,
                  reverse: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """[N,SEGS,4] clipped endpoints -> [N,227,227,3] mean-subtracted images."""
    return normalize_raster(render_raster(endpoints, visible, reverse,
                                          dtype=dtype))
