"""The plain twin of K1's shared-memory tables against the JAX package.

ops/rasterize.py:raster_tables builds what the kernel (csrc/raster.cu)
builds: each segment's column run in every row and each column's lit-row
count. raster_from_tables expands them as the kernel does. The expansion
must be bit-equal to JAX's render_raster_pallas run in interpret mode (as
the JAX package's own tests run it) at two segments, and to JAX's
render_raster at one, three and four, on seeded random specs and on
degenerate and clipped lines; the tables must say what the raster shows.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svision_tpu.ops import pallas_raster as jpr
from svision_tpu.ops import rasterize as jr
from svision_tpu_torch.ops import rasterize as tr
from tests.test_torch_rasterize import DEGENERATE, SENTINEL, _random_specs

torch.set_num_threads(2)

# lines beyond the specs' reach: a point at each corner, full diagonals,
# a full row and a full column, a steep and a shallow line
LINES = np.array([[0, 0, 0, 0], [226, 226, 226, 226], [0, 0, 226, 226],
                  [226, 0, 0, 226], [0, 113, 226, 113], [113, 0, 113, 226],
                  [10, 0, 20, 226], [0, 10, 226, 20]], np.int32)


def _inputs(kind: str, segs: int):
    """(endpoints int32 [N,segs,4], visible, reverse) as numpy: 'random'
    from seeded candidate specs, 'degenerate' from DEGENERATE (points,
    a vertical and a horizontal line, diagonals, clipped lines) and the
    sentinel. At S = 1 their first segment; at S = 3-4 more segments:
    seeded random lines, every other image's inside a 24-pixel corner so
    that the runs overlap ('random'), or the LINES ('degenerate')."""
    rng = np.random.RandomState(31 * segs)
    if kind == "random":
        specs = _random_specs(np.random.RandomState(11), 24)
    else:
        specs = np.array(DEGENERATE + [SENTINEL] * 4, np.int64)
    ep, vis, rev = tr.specs_to_endpoints(specs)
    n = ep.shape[0]
    if segs > 2:
        if kind == "random":
            hi = np.where(np.arange(n) % 2 == 0, 24, tr.CANVAS)[:, None, None]
            extra = (rng.randint(0, 1 << 20, (n, segs - 2, 4)) % hi)
        else:
            extra = LINES[(np.arange(n)[:, None] * (segs - 2)
                           + np.arange(segs - 2)) % len(LINES)]
        ep = np.concatenate([ep, extra.astype(np.int32)], axis=1)
        vis = np.concatenate([vis, rng.rand(n, segs - 2) < 0.8], axis=1)
        rev = np.concatenate([rev, rng.rand(n, segs - 2) < 0.5], axis=1)
    return tuple(np.ascontiguousarray(a[:, :segs]) for a in (ep, vis, rev))


def _expanded(ep, vis, rev, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in (ep, vis, rev)]
    runs, col_rows = tr.raster_tables(t[0], t[1])
    return tr.raster_from_tables(runs, col_rows, t[2], dtype=dtype)


@pytest.mark.parametrize("kind", ["random", "degenerate"])
def test_tables_expand_to_the_pallas_raster(kind):
    ep, vis, rev = _inputs(kind, 2)
    want = np.asarray(jpr.render_raster_pallas(
        jnp.asarray(ep), jnp.asarray(vis), jnp.asarray(rev),
        dtype=jnp.float32, interpret=True, block=1))
    got = _expanded(ep, vis, rev).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[..., 1].any() and want[..., 2].any()


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("kind", ["random", "degenerate"])
@pytest.mark.parametrize("segs", [1, 3, 4])
def test_tables_expand_to_the_jax_raster(segs, kind, dtype, jdtype):
    ep, vis, rev = _inputs(kind, segs)
    want = np.asarray(jr.render_raster(jnp.asarray(ep), jnp.asarray(vis),
                                       jnp.asarray(rev), dtype=jdtype),
                      np.float32)
    got = _expanded(ep, vis, rev, dtype)
    assert got.shape == (ep.shape[0], 227, 227, 3) and got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert want[..., 0].any()


@pytest.mark.parametrize("segs", [1, 2, 3, 4])
def test_tables_say_what_the_raster_shows(segs):
    """Each segment's run in a row is the span of the columns it lights
    there alone (JAX's raster of that segment), every column between lit;
    a row it does not reach holds the empty run (228, -1); a column's
    count is the lit rows of channel 0 there."""
    ep, vis, rev = _inputs("random", segs)
    runs, col_rows = tr.raster_tables(torch.from_numpy(ep),
                                      torch.from_numpy(vis))
    runs, col_rows = runs.numpy(), col_rows.numpy()
    assert runs.shape == ep.shape[:2] + (227, 2) and runs.dtype == np.int32
    cols = np.arange(227)
    for s in range(segs):
        alone = vis & (np.arange(segs) == s)
        lit = np.asarray(jr.render_raster(
            jnp.asarray(ep), jnp.asarray(alone), jnp.asarray(rev),
            dtype=jnp.float32))[..., 0] > 0                 # [N,R,C]
        lo, hi = runs[:, s, :, 0:1], runs[:, s, :, 1:2]
        np.testing.assert_array_equal(lit, (cols >= lo) & (cols <= hi))
        dark = ~lit.any(axis=2)
        assert (runs[:, s][dark] == [228, -1]).all()
    ch0 = np.asarray(jr.render_raster(jnp.asarray(ep), jnp.asarray(vis),
                                      jnp.asarray(rev), dtype=jnp.float32))
    np.testing.assert_array_equal(col_rows, (ch0[..., 0] > 0).sum(axis=1))
