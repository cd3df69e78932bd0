"""Candidate specs -> similarity images, plainly.

The reference's raster is SVision's (create_batch.py:101-152,
plot_segment.py:12-73): each of a candidate's two segments is rebuilt
from its bed fields, scaled by the ratio clamp, clipped by OpenCV's
clipLine and drawn by OpenCV's LINE_8 iterator, left to right; channel 0
holds every segment, channel 2 the reverse ones, channel 1 the pixels of
channel 0 in columns with two lit rows or more; the image is the raster
x 255 minus the channel means.

endpoints() is a frozen numpy copy of the host preprocessing
(specs_to_endpoints and the batched clipLine); draw() walks each line
with the iterator's running error term, one step a loop turn for all
lines at once, which is not the closed form the program's kernels use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

CANVAS = 227
IMAGE_MEAN = (104.0, 117.0, 124.0)


def _clip(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's clipLine over [..., 4] (x1, y1, x2, y2): the fixed two-phase
    update, int64 division truncated toward zero. -> (clipped int32,
    visible bool)."""
    p = np.asarray(pts, dtype=np.int64)
    x1, y1, x2, y2 = (p[..., i].copy() for i in range(4))
    right = bottom = CANVAS - 1

    def code(x, y):
        return ((x < 0).astype(np.int64) + (x > right) * 2
                + (y < 0) * 4 + (y > bottom) * 8)

    def tdiv(a, b):
        bs = np.where(b == 0, 1, b)
        q = np.abs(a) // np.abs(bs)
        return np.where((a >= 0) == (bs > 0), q, -q)

    c1, c2 = code(x1, y1), code(x2, y2)
    work = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    fix = work & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(fix, x1 + tdiv((a - y1) * (x2 - x1), y2 - y1), x1)
    y1 = np.where(fix, a, y1)
    c1 = np.where(work, code(x1, y1) & 3, c1)
    fix = work & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(fix, x2 + tdiv((a - y2) * (x2 - x1), y2 - y1), x2)
    y2 = np.where(fix, a, y2)
    c2 = np.where(work, code(x2, y2) & 3, c2)
    work2 = work & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    fix = work2 & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(fix, y1 + tdiv((a - x1) * (y2 - y1), x2 - x1), y1)
    x1 = np.where(fix, a, x1)
    c1 = np.where(fix, 0, c1)
    fix = work2 & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(fix, y2 + tdiv((a - x2) * (y2 - y1), x2 - x1), y2)
    x2 = np.where(fix, a, x2)
    c2 = np.where(fix, 0, c2)
    return (np.stack([x1, y1, x2, y2], axis=-1).astype(np.int32),
            (c1 | c2) == 0)


def endpoints(specs: np.ndarray):
    """specs [N,12] -> (endpoints int32 [N,2,4] as (col0, row0, col1,
    row1), visible bool [N,2], reverse bool [N,2])."""
    s = np.asarray(specs, dtype=np.int64).reshape(-1, 12)
    xs = np.stack([s[:, 0], s[:, 5]], axis=1)
    ys = np.stack([s[:, 2], s[:, 7]], axis=1)
    fwd = np.stack([s[:, 4], s[:, 9]], axis=1) != 0
    length = np.stack([s[:, 3], s[:, 8]], axis=1) - ys
    xe = np.where(fwd, xs + (length - 1), xs - (length - 1))
    ye = ys + (length - 1)
    ratio = np.maximum(np.maximum(s[:, 10], s[:, 11]).astype(np.float64)
                       / 227.0, 1.0)[:, None]
    pts = np.stack([np.trunc(ys / ratio), np.trunc(xs / ratio),
                    np.trunc(ye / ratio), np.trunc(xe / ratio)],
                   axis=-1).astype(np.int64)
    clipped, visible = _clip(pts)
    return clipped, visible, ~fwd


def draw(ep: torch.Tensor, vis: torch.Tensor, rev: torch.Tensor
         ) -> torch.Tensor:
    """In-canvas endpoints [N,S,4] (col0, row0, col1, row1) + visible and
    reverse [N,S] -> the {0,1} raster f32 [N,227,227,3] (NHWC), on ep's
    device. A line is drawn left to right; along its major axis every
    step lights one pixel, and the minor coordinate steps when the running
    error goes negative (OpenCV's LineIterator, connectivity 8)."""
    n, s, _ = ep.shape
    dev = ep.device
    e = ep.to(torch.int64).reshape(n * s, 4)
    c0, r0, c1, r1 = e.unbind(1)
    swap = c1 < c0
    c0, r0, c1, r1 = (torch.where(swap, c1, c0), torch.where(swap, r1, r0),
                      torch.where(swap, c0, c1), torch.where(swap, r0, r1))
    dx, dy = c1 - c0, r1 - r0
    sy = torch.where(dy >= 0, 1, -1)
    ady = dy.abs()
    xmajor = dx >= ady
    major = torch.where(xmajor, dx, ady)
    minor = torch.where(xmajor, ady, dx)
    err = major - 2 * minor
    k = torch.zeros_like(major)                    # minor steps so far
    on = vis.reshape(-1).to(torch.bool)
    back = rev.reshape(-1).to(torch.bool)
    image = torch.arange(n * s, device=dev) // s
    # pixels of lines that are off land in image n, which is dropped
    lit0 = torch.zeros((n + 1, CANVAS, CANVAS), dtype=torch.bool, device=dev)
    lit2 = torch.zeros_like(lit0)
    true = torch.ones((), dtype=torch.bool, device=dev)
    for i in range(CANVAS):
        live = on & (i <= major)
        col = torch.where(live, torch.where(xmajor, c0 + i, c0 + k), 0)
        row = torch.where(live, torch.where(xmajor, r0 + sy * k, r0 + sy * i),
                          0)
        lit0.index_put_((torch.where(live, image, n), row, col), true)
        lit2.index_put_((torch.where(live & back, image, n), row, col), true)
        step = err < 0
        k = torch.where(step, k + 1, k)
        err = torch.where(step, err + 2 * major, err) - 2 * minor
    lit0, lit2 = lit0[:n], lit2[:n]
    rows_in_col = lit0.sum(dim=1, keepdim=True)
    lit1 = lit0 & (rows_in_col >= 2)
    return torch.stack([lit0, lit1, lit2], dim=-1).to(torch.float32)


def images(specs: np.ndarray, device) -> torch.Tensor:
    """specs [N,12] -> mean-subtracted f32 images [N,227,227,3] (NHWC)."""
    ep, vis, rev = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in endpoints(specs))
    return normalize(draw(ep, vis, rev))


def normalize(raster: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=raster.device)
    return raster * 255.0 - mean
