"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so every test here needs a GPU: they carry
the `gpu` marker and skip without one. On a machine with a card:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

(chip_smoke.py runs the same comparisons at the engine's batch of 128.)
"""
import numpy as np
import pytest
import torch

from svision_tpu_torch.models.alexnet import fold_conv1_params, init_params
from svision_tpu_torch.ops import (endpoints, fused_conv1, fused_pool_lrn,
                                   raster_kernel)
from svision_tpu_torch.ops import rasterize

pytestmark = pytest.mark.gpu

torch.set_num_threads(2)

SPECS = np.array([
    [0, 0, 5, 6, 1, 10, 10, 10, 11, 1, 227, 227],
    [3, 3, 0, 227, 1, 0, 200, 7, 8, 1, 227, 227],
    [0, 226, 0, 227, 1, 226, 0, 0, 227, 0, 227, 227],
    [0, 300, 200, 500, 1, 0, 5, 0, 6, 1, 300, 500],
    [120, 0, 40, 900, 1, 700, 0, 300, 1200, 0, 1500, 1400],
    [0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2],
], dtype=np.int64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _segments(dev):
    return [torch.from_numpy(a).to(dev)
            for a in rasterize.specs_to_endpoints(SPECS)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raster_kernel_bit_exact(cuda, dtype):
    seg = _segments(cuda)
    before = raster_kernel.render_raster.launches
    got = raster_kernel.render_raster(*seg, dtype=dtype)
    assert raster_kernel.render_raster.launches == before + 1
    assert torch.equal(got, rasterize.render_raster(*seg, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raster_kernel_four_segments(cuda, dtype):
    """K1 at S = 4 (fit_device's fragmented endpoints on the image path):
    bit-exact, on random segments half of which overlap in a 24-pixel
    corner and on fragment_endpoints_torch's output."""
    from svision_tpu_torch.models import train
    rng = np.random.RandomState(6)
    n = 64
    hi = np.where(np.arange(n) % 2 == 0, 24, rasterize.CANVAS)[:, None, None]
    ep = (rng.randint(0, 1 << 20, (n, 4, 4)) % hi).astype(np.int32)
    cases = [[torch.from_numpy(a).to(cuda)
              for a in (ep, rng.rand(n, 4) < 0.75, rng.rand(n, 4) < 0.5)],
             train.fragment_endpoints_torch(
                 *_batch(cuda, n), torch.Generator(device=cuda).manual_seed(1),
                 split_prob=0.5)]
    for seg in cases:
        before = raster_kernel.render_raster.launches
        got = raster_kernel.render_raster(*seg, dtype=dtype)
        assert raster_kernel.render_raster.launches == before + 1
        assert torch.equal(got, rasterize.render_raster(*seg, dtype=dtype))


def _k1_inputs(dev, n, segs, case="random"):
    """K1's inputs, n images of segs segments each:
    - 'random': _batch's candidates (SPECS in front), their first segment
      alone at S = 1, and at S = 3-4 random extra segments, every other
      image's inside a 24-pixel corner so that the runs overlap;
    - 'degenerate': SPECS (points, a vertical and a horizontal line, full
      diagonals, clipped lines, the sentinel pad row), then the same
      segments in the other order as segments 3-4;
    - 'all-dark': random endpoints, every segment invisible;
    - 'every-row': y-major lines from row 0 to row 226, so every row of
      every band holds a run."""
    rng = np.random.RandomState(100 * n + segs)
    if case == "every-row":
        c = rng.randint(0, rasterize.CANVAS, (n, segs, 2))
        ep = np.stack([c[..., 0], np.zeros_like(c[..., 0]), c[..., 1],
                       np.full_like(c[..., 0], rasterize.CANVAS - 1)], -1)
        flags = (np.ones((n, segs), bool), rng.rand(n, segs) < 0.5)
        return [torch.from_numpy(a).to(dev)
                for a in (ep.astype(np.int32),) + flags]
    if case == "all-dark":
        ep = rng.randint(0, rasterize.CANVAS, (n, segs, 4)).astype(np.int32)
        off = np.zeros((n, segs), bool)
        return [torch.from_numpy(a).to(dev) for a in (ep, off, ~off)]
    ep, vis, rev = _segments(dev) if case == "degenerate" else _batch(dev, n)
    if case == "degenerate":
        ep, vis, rev = (torch.cat([t, t.flip(1)], dim=1) for t in (ep, vis, rev))
    elif segs > 2:
        hi = np.where(np.arange(n) % 2 == 0, 24, rasterize.CANVAS)[:, None, None]
        extra = (rng.randint(0, 1 << 20, (n, segs - 2, 4)) % hi).astype(np.int32)
        ep = torch.cat([ep, torch.from_numpy(extra).to(dev)], dim=1)
        vis = torch.cat([vis, torch.from_numpy(
            rng.rand(n, segs - 2) < 0.75).to(dev)], dim=1)
        rev = torch.cat([rev, torch.from_numpy(
            rng.rand(n, segs - 2) < 0.5).to(dev)], dim=1)
    return [t[:, :segs].contiguous() for t in (ep, vis, rev)]


def _check_k1(seg, dtype):
    """One launch, and the plain raster's bits."""
    before = raster_kernel.render_raster.launches
    got = raster_kernel.render_raster(*seg, dtype=dtype)
    assert raster_kernel.render_raster.launches == before + 1
    want = rasterize.render_raster(*seg, dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    return got


@pytest.mark.parametrize("n", [1, 3, 127, 128, 129])
@pytest.mark.parametrize("segs", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raster_kernel_batches(cuda, dtype, segs, n):
    """K1 at every segment count and at batches whose image bases fall at
    every 16-byte phase (an image holds 154,587 values) and whose bands
    fill the grid unevenly: bit-equal to the plain raster."""
    _check_k1(_k1_inputs(cuda, n, segs), dtype)


@pytest.mark.parametrize("case", ["degenerate", "all-dark", "every-row"])
@pytest.mark.parametrize("segs", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raster_kernel_cases(cuda, dtype, segs, case):
    """Degenerate lines, nothing lit (exactly zero) and every row lit
    (no dark row to skip), bit-equal to the plain raster."""
    seg = _k1_inputs(cuda, len(SPECS) if case == "degenerate" else 37, segs,
                    case)
    got = _check_k1(seg, dtype)
    if case == "all-dark":
        assert got.count_nonzero().item() == 0
    if case == "every-row":
        assert got[..., 0].amax(dim=2).bool().all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raster_kernel_graph_replay(cuda, dtype):
    """K1 alone in a CUDA graph: each replay equals the eager call on what
    the static inputs hold then, and counts one launch."""
    from svision_tpu_torch import graphs
    first = _k1_inputs(cuda, 128, 2)
    static = [t.clone() for t in first]
    _check_k1(static, dtype)        # builds and loads before the capture
    g = graphs.capture(
        lambda: raster_kernel.render_raster(*static, dtype=dtype), cuda)
    assert g.launches == ((raster_kernel.render_raster, 1),)
    for seg in (first, _k1_inputs(cuda, 128, 2, "every-row")):
        for t, src in zip(static, seg):
            t.copy_(src)
        before = raster_kernel.render_raster.launches
        got = g.replay()
        assert raster_kernel.render_raster.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, raster_kernel.render_raster(*seg, dtype=dtype))


def _check_pool_lrn(dev, n, h, w, c, dtype, bias_dtype):
    """One launch per call; bf16 bit-equal to the plain version (f32
    inside, the same operation order, one rounding), f32 within 1e-5
    relative."""
    gen = torch.Generator(device=dev).manual_seed(n * 1000 + c)
    x = (torch.randn((n, h, w, c), generator=gen, device=dev) * 2).to(dtype)
    b = torch.randn((c,), generator=gen, device=dev).to(bias_dtype)
    before = fused_pool_lrn.bias_relu_pool_lrn.launches
    got = fused_pool_lrn.bias_relu_pool_lrn(x, b)
    assert fused_pool_lrn.bias_relu_pool_lrn.launches == before + 1
    want = fused_pool_lrn.bias_relu_pool_lrn_plain(x, b)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        g, ref = got.float(), want.float()
        assert ((g - ref).abs() <= 1e-5 * ref.abs() + 1e-6).all()


@pytest.mark.parametrize("n", [1, 3, 128, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c", [(55, 96), (27, 256)])
def test_pool_lrn_kernel(cuda, dtype, h, c, n):
    """Both tails at batches whose runs end mid-image and wrap the ring;
    the bias in x's dtype (bf16 on the fast path), passed as it is."""
    _check_pool_lrn(cuda, n, h, h, c, dtype, dtype)


def _split_call(x, b, form):
    """K2 in a split form on x whole: 'halves_in' hands it x's two channel
    halves (contiguous copies), 'halves_out' asks for its output's two;
    returns the output joined and the counters' deltas (launches, split
    calls)."""
    xin = (tuple(t.contiguous() for t in x.chunk(2, dim=-1))
           if form == "halves_in" else x)
    before = (fused_pool_lrn.bias_relu_pool_lrn.launches,
              fused_pool_lrn.bias_relu_pool_lrn_halves.launches)
    out = fused_pool_lrn.bias_relu_pool_lrn(
        xin, b, out_halves=form == "halves_out")
    after = (fused_pool_lrn.bias_relu_pool_lrn.launches,
             fused_pool_lrn.bias_relu_pool_lrn_halves.launches)
    if form == "halves_out":
        assert isinstance(out, tuple) and len(out) == 2
        assert all(t.is_contiguous() for t in out)
        out = torch.cat(out, dim=-1)
    return out, (after[0] - before[0], after[1] - before[1])


# the split forms at the tails the bf16 network takes them at (conv2's
# reads halves, conv1's writes them)
SPLIT_FORMS = {"halves_in": (27, 256), "halves_out": (55, 96)}


@pytest.mark.parametrize("n", [1, 3, 128, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", list(SPLIT_FORMS))
def test_pool_lrn_kernel_halves(cuda, form, dtype, n):
    """K2 reading x as two channel halves (at [n,27,27,256]) or writing
    its output as two (at [n,55,55,96]): bit-equal to the joined launch
    on the same channels, one launch and one split call each."""
    h, c = SPLIT_FORMS[form]
    gen = torch.Generator(device=cuda).manual_seed(n * 1000 + c + 1)
    x = (torch.randn((n, h, h, c), generator=gen, device=cuda) * 2).to(dtype)
    b = torch.randn((c,), generator=gen, device=cuda).to(dtype)
    want = fused_pool_lrn.bias_relu_pool_lrn(x, b)
    got, counts = _split_call(x, b, form)
    assert counts == (1, 1)
    assert got.dtype == dtype and torch.equal(got, want)


def test_pool_lrn_halves_graph_replay(cuda):
    """Both split forms of K2 in one CUDA graph, bf16, 128 rows: each
    replay equals the joined launches on what the static inputs hold then,
    and counts two launches, both split."""
    from svision_tpu_torch import graphs
    gen = torch.Generator(device=cuda).manual_seed(5)

    def inputs():
        x1 = torch.randn((128, 55, 55, 96), generator=gen, device=cuda)
        x2 = torch.randn((128, 27, 27, 256), generator=gen, device=cuda)
        return [x1.to(torch.bfloat16)] + [
            t.contiguous() for t in x2.to(torch.bfloat16).chunk(2, dim=-1)]
    b1 = torch.randn((96,), generator=gen, device=cuda).to(torch.bfloat16)
    b2 = torch.randn((256,), generator=gen, device=cuda).to(torch.bfloat16)
    static = inputs()

    def both():
        return (fused_pool_lrn.bias_relu_pool_lrn(static[0], b1,
                                                  out_halves=True),
                fused_pool_lrn.bias_relu_pool_lrn(tuple(static[1:]), b2))
    both()                      # builds and loads before the capture
    g = graphs.capture(both, cuda)
    assert g.launches == ((fused_pool_lrn.bias_relu_pool_lrn, 2),
                          (fused_pool_lrn.bias_relu_pool_lrn_halves, 2))
    for _ in range(2):
        for t, src in zip(static, inputs()):
            t.copy_(src)
        before = _launches()
        (o0, o1), o2 = g.replay()
        got = {k: v - before[k] for k, v in _launches().items()}
        assert got["bias_relu_pool_lrn"] == 2
        assert got["bias_relu_pool_lrn_halves"] == 2
        torch.cuda.synchronize()
        assert torch.equal(torch.cat((o0, o1), dim=-1),
                           fused_pool_lrn.bias_relu_pool_lrn(static[0], b1))
        assert torch.equal(o2, fused_pool_lrn.bias_relu_pool_lrn(
            torch.cat(static[1:], dim=-1), b2))


def _check_pool_lrn_backward(dev, n, h, c, dtype, ties):
    """One launch per call; dx within 1e-5 (f32, with the same positions
    receiving a gradient) or 1e-2 (bf16) of the plain version's largest
    entry, the bias gradient likewise."""
    gen = torch.Generator(device=dev).manual_seed(n * 1000 + c)
    ho = (h - 3) // 2 + 1
    x = torch.randn((n, h, h, c), generator=gen, device=dev) * 2
    if ties:
        # a raster's blank regions: one constant, and repeated patches
        x[:, : h // 2] = 0.5
        x[:, h // 2:, : h // 3] = x[:, h // 2:, h // 3: 2 * (h // 3)]
    x = x.to(dtype)
    b = torch.randn((c,), generator=gen, device=dev).to(dtype)
    dy = torch.randn((n, ho, ho, c), generator=gen, device=dev).to(dtype)
    before = fused_pool_lrn.bias_relu_pool_lrn_backward.launches
    dx, db = fused_pool_lrn.bias_relu_pool_lrn_backward(x, b, dy)
    assert fused_pool_lrn.bias_relu_pool_lrn_backward.launches == before + 1
    want_dx, want_db = fused_pool_lrn.bias_relu_pool_lrn_backward_plain(x, b, dy)
    assert dx.shape == x.shape and dx.dtype == dtype and db.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in ((dx, want_dx), (db, want_db)):
        g, w = got.float(), want.float()
        assert (g - w).abs().max() <= tol * w.abs().max()
    if dtype == torch.float32:
        assert torch.equal(dx != 0, want_dx != 0)
    if ties:
        assert (dx[:, 1: h // 2: 2] == 0).all()   # odd rows of the blank half


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c", [(55, 96), (27, 256)])
def test_pool_lrn_backward_kernel(cuda, dtype, h, c, n):
    """K2's backward at both tails, at the training batch of 64 and at
    batches whose blocks' runs of output rows start mid-image and cross
    images."""
    _check_pool_lrn_backward(cuda, n, h, c, dtype, ties=False)


def _backward_inputs(dev, n, h, c, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    ho = (h - 3) // 2 + 1
    return (torch.randn((n, h, h, c), generator=gen, device=dev).to(dtype),
            torch.randn((c,), generator=gen, device=dev).to(dtype),
            torch.randn((n, ho, ho, c), generator=gen, device=dev).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c", [(55, 96), (27, 256)])
def test_pool_lrn_backward_kernel_graph(cuda, dtype, h, c):
    """A CUDA graph of the wrapper, replayed twice, equals the eager call
    bit for bit in dx and the bias gradient (the kernel's sums run in a
    fixed order)."""
    x, b, dy = _backward_inputs(cuda, 64, h, c, dtype, 7)
    dx, db = fused_pool_lrn.bias_relu_pool_lrn_backward(x, b, dy)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gdx, gdb = fused_pool_lrn.bias_relu_pool_lrn_backward(x, b, dy)
    for _ in range(2):
        gdx.zero_()
        gdb.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(gdx, dx) and torch.equal(gdb, db)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_lrn_backward_kernel_two_streams(cuda, dtype):
    """Two calls at once on two streams, at the two tails: each equals its
    own call alone (each call counts its blocks on its own ticket)."""
    one = _backward_inputs(cuda, 64, 55, 96, dtype, 8)
    two = _backward_inputs(cuda, 64, 27, 256, dtype, 9)
    alone = [fused_pool_lrn.bias_relu_pool_lrn_backward(*t) for t in (one, two)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(3):
        for s, t in zip(streams, (one, two)):
            with torch.cuda.stream(s):
                got.append(fused_pool_lrn.bias_relu_pool_lrn_backward(*t))
    torch.cuda.synchronize()
    for i, (dx, db) in enumerate(got):
        want_dx, want_db = alone[i % 2]
        assert torch.equal(dx, want_dx) and torch.equal(db, want_db)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c", [(55, 96), (27, 256)])
def test_pool_lrn_backward_kernel_ties(cuda, dtype, h, c):
    """A tie-heavy, mostly blank input routes each window's gradient to its
    first maximum, as the plain version does."""
    _check_pool_lrn_backward(cuda, 64, h, c, dtype, ties=True)


def _check_backward_shape(dev, h, w, c, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn((3, h, w, c), generator=gen, device=dev).to(dtype)
    b = torch.randn((c,), generator=gen, device=dev).to(dtype)
    dy = torch.randn((3, (h - 3) // 2 + 1, (w - 3) // 2 + 1, c),
                     generator=gen, device=dev).to(dtype)
    dx, db = fused_pool_lrn.bias_relu_pool_lrn_backward(x, b, dy)
    want_dx, want_db = fused_pool_lrn.bias_relu_pool_lrn_backward_plain(x, b, dy)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in ((dx, want_dx), (db, want_db)):
        g, ref = got.float(), want.float()
        assert (g - ref).abs().max() <= tol * ref.abs().max()
    if dtype == torch.float32:
        assert torch.equal(dx != 0, want_dx != 0)


@pytest.mark.parametrize("h,w,c", [(13, 11, 16), (8, 9, 400), (7, 7, 8)])
def test_pool_lrn_backward_kernel_other_shapes(cuda, h, w, c):
    """Runtime shapes beside the tails: W != H, an even H (its last row
    receives nothing), 50 lanes a pixel (a warp's pixels start mid-warp),
    the least C, 8."""
    _check_backward_shape(cuda, h, w, c)


@pytest.mark.parametrize("h,w,c,dtype", [(5, 5, 3072, torch.float32),
                                         (9, 9, 3072, torch.bfloat16)])
def test_pool_lrn_backward_kernel_wide_rows(cuda, h, w, c, dtype):
    """Rows too wide for the shared-memory ring take the kernel's simple
    path (a block per output row), at the widest C the wrapper takes."""
    _check_backward_shape(cuda, h, w, c, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,bias_dtype", [
    (55, 55, 64, torch.float32),      # runtime C, 8 channels a lane
    (27, 27, 12, torch.bfloat16),     # 4 a lane; bf16 rows of 648 bytes
    (55, 55, 12, torch.float32),
    (13, 31, 3, torch.bfloat16),      # 1 a lane, not square
])
def test_pool_lrn_kernel_other_channels(cuda, dtype, h, w, c, bias_dtype):
    """C outside {96, 256}: the runtime-C instances, with rows whose byte
    length is not a multiple of 16 in bf16."""
    _check_pool_lrn(cuda, 5, h, w, c, dtype, bias_dtype)


def _batch(dev, n):
    """n random candidate specs (mixed scales and strands) with SPECS, the
    degenerate ones, in front."""
    rng = np.random.RandomState(n)
    specs = np.zeros((n, 12), np.int64)
    read_len = rng.randint(150, 9000, n)
    ref_len = rng.randint(150, 9000, n)
    for k, length in ((0, read_len), (5, read_len), (2, ref_len), (7, ref_len)):
        specs[:, k] = rng.randint(0, 1 << 30, n) % (length // 2)
        specs[:, k + 1] = specs[:, k] + rng.randint(2, length // 2 + 2)
    specs[:, 4] = 1
    specs[:, 9] = rng.randint(0, 2, n)
    specs[:, 10], specs[:, 11] = read_len, ref_len
    k = min(n, len(SPECS))
    specs[:k] = SPECS[:k]
    return [torch.from_numpy(a).to(dev)
            for a in rasterize.specs_to_endpoints(specs)]


def _conv1_inputs(dev, case):
    if case == "degenerate":
        return _segments(dev)
    if case == "all-dark":          # no visible segment: exactly 0 out
        off = torch.zeros((300, 2), dtype=torch.bool, device=dev)
        return [torch.zeros((300, 2, 4), dtype=torch.int32, device=dev),
                off, off]
    if case == "sentinel":          # the engine's padding spec alone
        return [torch.from_numpy(a).to(dev) for a in
                rasterize.specs_to_endpoints(np.repeat(SPECS[-1:], 200, 0))]
    if case == "dense":             # long diagonals: densely lit
        from svision_tpu_torch.timing import diagonal_specs
        return [torch.from_numpy(a).to(dev) for a in
                rasterize.specs_to_endpoints(diagonal_specs(128, seed=2))]
    return _batch(dev, case)


@pytest.mark.parametrize("case", ["degenerate", "all-dark", "sentinel",
                                  "dense", 1, 7, 128, 129, 1000, 4096])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_conv1_kernel(cuda, dtype, tol, case):
    """Batch sizes that split unevenly over the SMs, with a partial last
    wave, up to 4,096 (K3 f32 stripes its items over the SMs), batches with
    nothing or almost nothing lit, and a densely lit one; one launch per
    call."""
    from svision_tpu_torch.infer.engine import exact_f32
    seg = _conv1_inputs(cuda, case)
    w = torch.from_numpy(fold_conv1_params(init_params(0))["conv1/weights"])
    w = w.to(cuda, dtype)
    with exact_f32():
        before = fused_conv1.conv1_fused_raster.launches
        got = fused_conv1.conv1_fused_raster(*seg, w).float()
        assert fused_conv1.conv1_fused_raster.launches == before + 1
        want = fused_conv1.conv1_fused_raster_plain(*seg, w).float()
    assert got.shape == want.shape
    assert (got - want).abs().max() <= tol * want.abs().max()
    if case == "all-dark":
        assert got.count_nonzero().item() == 0


def _wild_specs(n, seed):
    """The genome mix's specs (benchmark/traffic.py) with SPECS first and
    every third row wild: ends far outside the canvas on every side,
    lengths down to -5 (zero-length and reversed segments), strand fields
    0, 1 and 2, read and ref lengths under and over 227; many of their
    segments are clipped or wholly invisible."""
    from benchmark.traffic import random_specs
    rng = np.random.RandomState(seed)
    specs = random_specs(n, rng)
    wild = np.arange(n) % 3 == 0
    w = int(wild.sum())
    for k in (0, 5):
        specs[wild, k] = rng.randint(-900, 1400, w)
    for k in (2, 7):
        specs[wild, k] = rng.randint(-900, 1400, w)
        specs[wild, k + 1] = specs[wild, k] + rng.randint(-5, 700, w)
    specs[wild, 4] = rng.randint(0, 3, w)
    specs[wild, 9] = rng.randint(0, 3, w)
    specs[wild, 10] = rng.randint(50, 2000, w)
    specs[wild, 11] = rng.randint(50, 2000, w)
    k = min(n, len(SPECS))
    specs[:k] = SPECS[:k]
    return torch.from_numpy(specs)


@pytest.mark.parametrize("n", [1, 127, 128, 4096, 4099])
def test_specs_endpoints_kernel_bit_exact(cuda, n):
    """The endpoints kernel against its plain version (held to the host's
    numpy by tests/test_torch_endpoints.py), bit for bit in all three
    outputs, invisible segments' endpoints included; one launch a call.
    The plain version run on the card (as chip_smoke's all-plain engines
    run it) gives the same bits."""
    specs = _wild_specs(n, seed=n)
    before = endpoints.specs_endpoints.launches
    got = endpoints.specs_endpoints(specs.to(cuda))
    assert endpoints.specs_endpoints.launches == before + 1
    want = endpoints.specs_endpoints_plain(specs)
    on_card = endpoints.specs_endpoints_plain(specs.to(cuda))
    for g, w, c in zip(got, want, on_card):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
        assert torch.equal(c, g)
    if n >= 127:
        assert not want[1].all() and want[1].any()


def test_specs_endpoints_kernel_in_a_graph(cuda):
    """Captured in a CUDA graph over a static buffer of 4,096 specs, as
    the engine holds it: each replay makes the endpoints of the rows
    copied in before it, three sets in turn; each replay counts one
    launch."""
    from svision_tpu_torch import graphs
    static = torch.zeros((4096, 12), dtype=torch.int64, device=cuda)
    with torch.inference_mode():
        endpoints.specs_endpoints(static)
        g = graphs.capture(lambda: endpoints.specs_endpoints(static), cuda)
    assert g.launches == ((endpoints.specs_endpoints, 1),)
    before = endpoints.specs_endpoints.launches
    for seed in (1, 2, 3):
        specs = _wild_specs(4096, seed=seed)
        static.copy_(specs.to(cuda))
        got = g.replay()
        for a, w in zip(got, endpoints.specs_endpoints_plain(specs)):
            assert torch.equal(a.cpu(), w)
    assert endpoints.specs_endpoints.launches == before + 3


def test_wrappers_reject_bad_inputs(cuda):
    ep, vis, rev = _segments(cuda)
    with pytest.raises(ValueError):
        raster_kernel.render_raster(ep.to(torch.int64), vis, rev)
    with pytest.raises(ValueError):
        fused_conv1.conv1_fused_raster(ep, vis, rev,
                                       torch.zeros((3, 3, 48, 95), device=cuda))
    # the endpoints kernel takes contiguous int64 [N,12] specs alone
    specs = torch.zeros((4, 12), dtype=torch.int64, device=cuda)
    for bad in (specs.int(), specs.double(), specs[:, :11],
                torch.zeros((12, 4), dtype=torch.int64, device=cuda).t()):
        with pytest.raises(ValueError):
            endpoints.specs_endpoints(bad)
    # K2 copies nothing: a non-contiguous x and one off 16-byte alignment
    # (a 1-element-offset view) are refused
    b = torch.zeros((96,), dtype=torch.bfloat16, device=cuda)
    x = torch.zeros((2, 55, 55, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        fused_pool_lrn.bias_relu_pool_lrn(x.transpose(1, 2), b)
    flat = torch.zeros((x.numel() + 1,), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        fused_pool_lrn.bias_relu_pool_lrn(flat[1:].view(x.shape), b)
    with pytest.raises(ValueError):
        fused_pool_lrn.bias_relu_pool_lrn(x, b[:95])
    # its split forms: halves of unequal shape, dtype or device, a
    # non-contiguous or misaligned half, halves both in and out, a C the
    # forms do not take
    h0 = torch.zeros((2, 27, 27, 128), dtype=torch.bfloat16, device=cuda)
    b2 = torch.zeros((256,), dtype=torch.bfloat16, device=cuda)
    flat = torch.zeros((h0.numel() + 1,), dtype=torch.bfloat16, device=cuda)
    for bad in ((h0, h0[..., :120]), (h0, h0.float()), (h0, h0.cpu()),
                (h0, h0.transpose(1, 2)), (h0, flat[1:].view(h0.shape)),
                (flat[1:].view(h0.shape), h0)):
        with pytest.raises(ValueError):
            fused_pool_lrn.bias_relu_pool_lrn(bad, b2)
    with pytest.raises(ValueError):
        fused_pool_lrn.bias_relu_pool_lrn((h0, h0), b2, out_halves=True)
    h8 = torch.zeros((2, 27, 27, 4), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        fused_pool_lrn.bias_relu_pool_lrn((h8, h8), b2[:8])
    with pytest.raises(ValueError):
        fused_pool_lrn.bias_relu_pool_lrn(h8, b2[:4], out_halves=True)
    # its backward: a non-contiguous or misaligned dy, f64, mixed dtypes,
    # a C that is not a multiple of 8 or beyond a block's 384 lanes
    bwd = fused_pool_lrn.bias_relu_pool_lrn_backward
    dy = torch.zeros((2, 27, 27, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        bwd(x, b, dy.transpose(1, 2))
    flat = torch.zeros((dy.numel() + 1,), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        bwd(x, b, flat[1:].view(dy.shape))
    with pytest.raises(ValueError):
        bwd(x.double(), b.double(), dy.double())
    with pytest.raises(ValueError):
        bwd(x, b, dy.float())
    for c in (12, 3080):
        with pytest.raises(ValueError):
            bwd(torch.zeros((1, 3, 3, c), device=cuda),
                torch.zeros(c, device=cuda),
                torch.zeros((1, 1, 1, c), device=cuda))
    # the autograd Function: f64 has no kernel, and raises on the card
    with pytest.raises(ValueError):
        fused_pool_lrn.BiasReluPoolLRN.apply(
            x.double().requires_grad_(), b.double())


@pytest.mark.parametrize("s2d", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_reaches_every_parameter(cuda, s2d, dtype):
    """One training step on the card leaves a finite, non-zero gradient on
    every one of the 16 parameters: no kernel cut the graph (the image
    path's batch comes from K1, outside it), so the optimizer skipped
    nothing."""
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import AlexNet
    model = AlexNet.trainable(init_params(0), device=cuda)
    _, step = train.make_train_step(model, clip_norm=1.0, keep_prob=0.5,
                                    compute_dtype=dtype, s2d=s2d)
    seg = _batch(cuda, 16)
    if s2d:
        x = rasterize.render_raster_s2d(*seg, dtype=dtype)
    else:
        before = raster_kernel.render_raster.launches
        x = raster_kernel.render_images(*seg)
        assert raster_kernel.render_raster.launches == before + 1
    labels = torch.arange(16, device=cuda) % 5
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    loss = step(x, labels, torch.Generator(device=cuda).manual_seed(0))
    assert torch.isfinite(loss)
    named = dict(model.named_parameters())
    assert len(named) == 16
    for k, v in named.items():
        assert v.grad is not None, f"{k}: no gradient"
        assert torch.isfinite(v.grad).all() and v.grad.abs().max() > 0, k
        assert not torch.equal(v.detach(), start[k]), f"{k}: not updated"


# the V-MoE's kernel wrappers (ops/moe.py): AlexNet's steps launch none
MOE_WRAPPERS = ("moe_route", "moe_dispatch", "moe_bias_gelu", "moe_combine")
# launches per batch of each engine mode's step, and K2's launches in a
# split form (the bf16 network's); the endpoints kernel runs once a
# dispatch (_dispatches)
PER_BATCH = {True: {"render_raster": 0, "bias_relu_pool_lrn": 2,
                    "bias_relu_pool_lrn_backward": 0, "conv1_fused_raster": 1,
                    "specs_endpoints": 0, "bias_relu_pool_lrn_halves": 2,
                    **dict.fromkeys(MOE_WRAPPERS, 0)},
             False: {"render_raster": 0, "bias_relu_pool_lrn": 2,
                     "bias_relu_pool_lrn_backward": 0, "conv1_fused_raster": 1,
                     "specs_endpoints": 0, "bias_relu_pool_lrn_halves": 0,
                     **dict.fromkeys(MOE_WRAPPERS, 0)}}


def _dispatches(eng, n):
    """The dispatches of a call of n specs: one endpoints launch each, on
    each card."""
    chunks, singles = eng.plan(n)
    return len(chunks) + singles


def _warmup_runs(eng):
    """(batches, dispatches) of warmup() on the card: the eager sentinel
    batch, the single-batch graph's replay and, under tail 'full', the
    full-chunk graph's."""
    full = eng.tail == "full" and eng.chunk > 1
    return 2 + (eng.chunk if full else 0), 2 + full


def _launches():
    from svision_tpu_torch import graphs
    return {w.__name__: w.launches for w in graphs.kernel_wrappers()}


@pytest.mark.parametrize("bf16", [True, False])
def test_engine_graphs_equal_eager(cuda, bf16):
    """The engine's graph replays against its eager step on the card, bit
    for bit, at n = 1, 128, 129, a short tail (17 x 128 + 5), a long one
    (chunk + 20 batches) and 8,192; every kernel counter equals launches
    per batch x the batches run, and the endpoints kernel's the dispatches
    run, captures excluded and replays counted."""
    from svision_tpu_torch.infer.engine import InferenceEngine
    from bench import random_specs
    eng = InferenceEngine(init_params(0), bf16=bf16)
    start = _launches()
    eng.warmup()
    batches, dispatches = _warmup_runs(eng)
    for n in (1, 128, 129, 17 * 128 + 5, (eng.chunk + 20) * 128, 8192):
        specs = random_specs(n, seed=n)
        p, s = eng.predict_specs(specs)
        with torch.inference_mode():
            ep, es = eng._predict(specs, graphed=False)
        chunks, singles = eng.plan(n)
        batches += 2 * (sum(chunks) + singles)
        dispatches += 2 * _dispatches(eng, n)
        assert np.array_equal(p, ep) and np.array_equal(s, es), n
    got = {k: v - start[k] for k, v in _launches().items()}
    assert got == {**{k: v * batches for k, v in PER_BATCH[bf16].items()},
                   "specs_endpoints": dispatches}


def _f64_max_softmax(seg, monkeypatch):
    """Max softmax of the unfolded network in f64 on the card, the answer
    every f32 route rounds: the plain raster and K2's plain version (the
    kernels take f32 and bf16 only), fc8 in f64 too."""
    from svision_tpu_torch.models import alexnet
    monkeypatch.setattr(alexnet, "bias_relu_pool_lrn",
                        fused_pool_lrn.bias_relu_pool_lrn_plain)
    model = alexnet.AlexNet.from_params(
        {k: v.astype(np.float64) for k, v in init_params(0).items()},
        device=seg[0].device)
    logits = []
    with torch.inference_mode():
        for i in range(0, seg[0].shape[0], 512):
            x = rasterize.render_images(*(a[i:i + 512] for a in seg),
                                        dtype=torch.float64)
            pre = model._conv(model.conv1, x.permute(0, 3, 1, 2), bias=False)
            h = model.forward_conv1(pre.permute(0, 2, 3, 1), 5)
            h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
            h = torch.relu(model.fc7(torch.relu(model.fc6(h))))
            logits.append(model.fc8(h))
    return torch.softmax(torch.cat(logits), dim=1).amax(dim=1).cpu().numpy()


def test_exact_engine_runs_the_fused_route(cuda, monkeypatch):
    """The exact engine on the card takes the fused route: its replica is
    the folded f32 network with conv1's weights kept for K3; engine.call's
    launches a batch are K1 0, K3 1 and K2 2, and the endpoints kernel's
    one a dispatch, with split_groups 0; its
    graph replays give the eager step's answers bit for bit. On 8,192
    random specs it agrees with the CPU exact engine (the unfolded
    network) on every argmax, and its max softmax lies within 1e-4 of the
    f64 answer (_f64_max_softmax). The f64 answer is the bar, not the CPU's
    f32 one: K3 sums conv1 in another order than the unfolded convolutions
    of the CPU and of K1 + cuDNN, so their f32 roundings agree with each
    other more closely than either does with the card's fused route,
    though all three lie as close to the f64 answer."""
    import os
    from svision_tpu_torch import trace
    from svision_tpu_torch.infer.engine import InferenceEngine
    from bench import random_specs
    specs = random_specs(8192, seed=23)
    eng = InferenceEngine(init_params(0), bf16=False)
    model, w_s2d = eng._replicas[0]
    assert model.s2d and model.compute_dtype == torch.float32
    assert w_s2d is not None and w_s2d.dtype == torch.float32
    eng.warmup()
    with trace.recording([cuda]) as rec:
        p, s = eng.predict_specs(specs)
    (call,) = rec.find("engine.call")
    batches = call.attrs["padded_rows"] // eng.batch_size
    assert call.attrs["split_groups"] == 0
    assert call.attrs["launches"] == {
        **{k: v * batches for k, v in PER_BATCH[False].items()},
        "specs_endpoints": call.attrs["dispatches"]}
    with torch.inference_mode():
        ep, es = eng._predict(specs, graphed=False)
    assert np.array_equal(p, ep) and np.array_equal(s, es)
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or threads)
    try:
        cp, _ = InferenceEngine(init_params(0), bf16=False,
                                device="cpu").predict_specs(specs)
    finally:
        torch.set_num_threads(threads)
    assert np.array_equal(p, cp)
    seg = [torch.from_numpy(a).to(cuda)
           for a in rasterize.specs_to_endpoints(specs)]
    assert float(np.abs(s - _f64_max_softmax(seg, monkeypatch)).max()) <= 1e-4



# the ViT's bounds against the f32 reference on 1,024 rows: bf16 at the
# cell's limits (benchmark/limits/vit-b16.genome.json); f32 at f32's
# rounding, which the fitted weights scale up with the images' spread of
# features to logits of std 2 (6e-4 in max softmax, 1.8e-4 in argmax_gap
# on the card)
VIT_F32_BOUNDS = {"argmax_gap": 0.005, "softmax_err": 0.005,
                  "softmax_err_mean": 0.001}


@pytest.mark.parametrize("bf16", [True, False])
def test_vit_engine_at_published_widths(cuda, bf16):
    """ViT-B/16 at its published widths, with the benchmark's fitted
    weights of one seed, through the engine: its graph replays give the
    eager step's answers bit for bit (n = 1, 129, a short tail and 8,192);
    engine.call says network vit_b16 and tokens = padded rows x 197, and
    launches K1 once a batch and the endpoints kernel once a dispatch; on
    1,024 rows its answers lie within the bounds above of
    tests/reference_vit.py's, computed in f32 (TF32 off) on the card from
    the raster benchmark/reference/raster.py draws."""
    from benchmark import spec
    from benchmark.drivers import engine as bench_engine
    from benchmark.drivers import engine_vit
    from benchmark.reference import raster as ref_raster
    from bench import random_specs
    from svision_tpu_torch import trace
    from svision_tpu_torch.infer.engine import InferenceEngine
    from tests import reference_vit
    bench = spec.load()
    model = spec.config(bench, "svision-vit-b16-bf16")["model"]
    params = {k: v.cpu().numpy()
              for k, v in engine_vit.params(model, 1_000_003, cuda).items()}
    eng = InferenceEngine(params, bf16=bf16)
    assert eng.network == "vit_b16"
    assert eng._replicas[0][0].widths.hidden == 768
    eng.warmup()
    for n in (1, 129, 17 * 128 + 5, 8192):
        specs = random_specs(n, seed=n)
        with trace.recording([cuda]) as rec:
            p, s = eng.predict_specs(specs)
        (call,) = rec.find("engine.call")
        chunks, singles = eng.plan(n)
        batches = sum(chunks) + singles
        assert call.attrs["network"] == "vit_b16"
        assert call.attrs["tokens"] == batches * 128 * 197
        assert call.attrs["launches"] == {
            **{w: 0 for w in _launches()}, "render_raster": batches,
            "specs_endpoints": len(chunks) + singles}
        with torch.inference_mode():
            ep, es = eng._predict(specs, graphed=False)
        assert np.array_equal(p, ep) and np.array_equal(s, es), n
    specs = random_specs(1024, seed=31)
    p, s = eng.predict_specs(specs)
    seg = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
           for a in ref_raster.endpoints(specs))
    with torch.no_grad(), reference_vit.f32_exact():
        logits = reference_vit.logits(params, ref_raster.draw(*seg))
    got = bench_engine.readings(logits, p, s)
    bounds = (spec.limits("vit-b16.genome")["limits"] if bf16
              else VIT_F32_BOUNDS)
    assert all(got[k] <= v for k, v in bounds.items()), got
    assert int((np.bincount(p, minlength=5) >= 0.05 * len(p)).sum()) >= 3

@pytest.mark.parametrize("bf16", [True, False])
def test_mesh_engine_equals_one_card(cuda, bf16):
    """The data-parallel engine over two cards gives each replica whole
    batches of 128 (a round of 256), so each card runs the one-card
    engine's batch shape on the same rows: on 8,192 random specs the bf16
    and the exact engine equal the one-card engine bit for bit, and each
    engine.dispatch span of a chunk carries 8 x 128 = 1,024 rows."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    from svision_tpu_torch import trace
    from svision_tpu_torch.infer.engine import InferenceEngine
    from bench import random_specs
    specs = random_specs(8192, seed=24)
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    one = InferenceEngine(init_params(0), bf16=bf16, device=devs[0])
    two = InferenceEngine(init_params(0), bf16=bf16, devices=devs)
    assert one.batch_size == 128 and two.batch_size == 256
    want = one.predict_specs(specs)
    two.warmup()
    with trace.recording(devs) as rec:
        got = two.predict_specs(specs)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    chunks = [s for s in rec.find("engine.dispatch", device=False)
              if s.attrs["batches"] == two.chunk]
    assert len(chunks) == 4 * 2          # 32 rounds, 4 chunks, 2 cards
    assert all(s.attrs["rows"] == 1024 for s in chunks)


# the engine's other modes (engine arguments), their launches per batch
# (K1, K2, K3, K2 in a split form) and the endpoints kernel's per dispatch
MODES = {
    "bf16-compare": (dict(raster="compare"), (0, 2, 0, 2), 1),
    "bf16-einsum": (dict(raster="einsum"), (0, 2, 0, 2), 1),
    "bf16-pallas": (dict(raster="pallas"), (1, 2, 0, 2), 1),
    "int8-compare": (dict(int8=True), (0, 2, 0, 0), 1),
    "int8-einsum": (dict(int8=True, raster="einsum"), (0, 2, 0, 0), 1),
    "int8-pallas": (dict(int8=True, raster="pallas"), (1, 2, 0, 0), 1),
    "unfolded-bf16": (dict(fast=False), (1, 2, 0, 2), 1),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_mode_graphs_equal_eager(cuda, mode):
    """test_engine_graphs_equal_eager for each of the engine's other modes
    (raster kinds, int8, the unfolded bf16 network): replays bit-equal to
    the eager step at n = 1, 129 and chunk + 20 batches, launches per
    batch x batches and per dispatch x dispatches."""
    from svision_tpu_torch.infer.engine import InferenceEngine
    from bench import random_specs
    kw, per_batch, per_dispatch = MODES[mode]
    eng = InferenceEngine(init_params(0), **kw)
    assert eng.raster == kw.get("raster", "compare" if eng.int8 else "s2d")
    start = _launches()
    eng.warmup()
    batches, dispatches = _warmup_runs(eng)
    for n in (1, 129, (eng.chunk + 20) * 128):
        specs = random_specs(n, seed=n)
        p, s = eng.predict_specs(specs)
        with torch.inference_mode():
            ep, es = eng._predict(specs, graphed=False)
        chunks, singles = eng.plan(n)
        batches += 2 * (sum(chunks) + singles)
        dispatches += 2 * _dispatches(eng, n)
        assert np.array_equal(p, ep) and np.array_equal(s, es), n
    got = {k: v - start[k] for k, v in _launches().items()}
    names = ("render_raster", "bias_relu_pool_lrn", "conv1_fused_raster",
             "bias_relu_pool_lrn_halves")
    assert got == {"bias_relu_pool_lrn_backward": 0,
                   "specs_endpoints": per_dispatch * dispatches,
                   **{k: v * batches for k, v in zip(names, per_batch)},
                   **dict.fromkeys(MOE_WRAPPERS, 0)}


@pytest.mark.parametrize("int8", [False, True])
def test_pallas_engine_raster_is_the_plain_raster(cuda, int8, monkeypatch):
    """K1 in bf16 as the 'pallas' engine calls it, eagerly: every raster
    it renders equals the plain raster of the same endpoints, and the
    engine's outputs equal those of the 'compare' engine, which renders
    the plain raster."""
    from svision_tpu_torch.infer import engine
    from bench import random_specs
    seen, real = [], engine.render_raster_kernel

    def recording(ep, vis, rev, dtype):
        out = real(ep, vis, rev, dtype=dtype)
        seen.append((ep.clone(), vis.clone(), rev.clone(), dtype, out.clone()))
        return out
    monkeypatch.setattr(engine, "render_raster_kernel", recording)
    specs = random_specs(3 * 128 + 7, seed=9)
    eng = engine.InferenceEngine(init_params(0), raster="pallas", int8=int8)
    with torch.inference_mode():
        got = eng._predict(specs, graphed=False)
    assert len(seen) == 4
    for ep, vis, rev, dtype, out in seen:
        assert dtype == torch.bfloat16
        assert torch.equal(out, rasterize.render_raster(ep, vis, rev,
                                                        dtype=dtype))
    cmp = engine.InferenceEngine(init_params(0), raster="compare", int8=int8)
    with torch.inference_mode():
        want = cmp._predict(specs, graphed=False)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_bf16_engine_split_groups_against_the_grouped_network(cuda):
    """The bf16 engine, whose conv2, conv4 and conv5 run as two ungrouped
    convolutions each, against a grouped forward built here from the same
    weights (one F.conv2d with groups=2 a grouped layer, after the same
    K3 and K2) on 8,192 random specs: argmax agreement >= 0.99 and a mean
    max-softmax gap under bf16.genome's softmax_err_mean limit, 0.019.
    engine.call reads split_groups 3 for it and 0 for the exact engine."""
    import torch.nn.functional as F
    from svision_tpu_torch import trace
    from svision_tpu_torch.infer.engine import InferenceEngine
    from bench import random_specs
    specs = random_specs(8192, seed=22)
    eng = InferenceEngine(init_params(0))
    eng.warmup()
    with trace.recording([cuda]) as rec:
        p, s = eng.predict_specs(specs)
    assert [c.attrs["split_groups"] for c in rec.find("engine.call")] == [3]
    model, w_s2d = eng._replicas[0]

    def conv(layer, h, bias=True):
        return F.conv2d(h, layer.weight, layer.bias if bias else None,
                        layer.stride, layer.padding, 1, layer.groups)

    def grouped(ep, vis, rev):
        h = fused_pool_lrn.bias_relu_pool_lrn(
            fused_conv1.conv1_fused_raster(ep, vis, rev, w_s2d),
            model.conv1.bias)
        h = conv(model.conv2, h.permute(0, 3, 1, 2), bias=False)
        h = fused_pool_lrn.bias_relu_pool_lrn(h.permute(0, 2, 3, 1),
                                              model.conv2.bias)
        h = torch.relu(conv(model.conv3, h.permute(0, 3, 1, 2)))
        h = torch.relu(conv(model.conv4, h))
        h = F.max_pool2d(torch.relu(conv(model.conv5, h)), 3, 2)
        return model._head(h)
    ep, vis, rev = (torch.from_numpy(a).to(cuda)
                    for a in rasterize.specs_to_endpoints(specs))
    with torch.inference_mode():
        logits = torch.cat([grouped(ep[i:i + 128], vis[i:i + 128],
                                    rev[i:i + 128])
                            for i in range(0, len(specs), 128)])
    soft = torch.softmax(logits.double(), dim=1).cpu().numpy()
    agree = float((p == soft.argmax(1)).mean())
    gap = float(np.abs(s - soft.max(1)).mean())
    assert agree >= 0.99 and gap < 0.019, (agree, gap)
    exact = InferenceEngine(init_params(0), bf16=False)
    exact.warmup()
    with trace.recording([cuda]) as rec:
        exact.predict_specs(specs[:128])
    assert [c.attrs["split_groups"] for c in rec.find("engine.call")] == [0]


def test_bf16_engine_equals_the_joined_route(cuda):
    """The bf16 engine, whose K2 writes conv2's input halves and reads
    conv2's output halves where they lie, against the route that joined
    them (K2 whole, conv2's inputs as strided channel views of its output,
    conv2's two outputs joined by a cat for K2), on the engine's own
    weights and 8,192 random specs: the logits bit for bit, batch by
    batch, and the engine's answers equal to those of the joined logits.
    engine.call counts K2's split calls: two a batch on the bf16 engine,
    none on the exact one."""
    from svision_tpu_torch import trace
    from svision_tpu_torch.infer import engine
    from svision_tpu_torch.models import alexnet
    from bench import random_specs
    specs = random_specs(8192, seed=29)
    k2 = fused_pool_lrn.bias_relu_pool_lrn
    for bf16 in (True, False):
        eng = engine.InferenceEngine(init_params(0), bf16=bf16)
        eng.warmup()
        with trace.recording([cuda]) as rec:
            p, s = eng.predict_specs(specs if bf16 else specs[:128])
        (call,) = rec.find("engine.call")
        batches = call.attrs["padded_rows"] // eng.batch_size
        assert call.attrs["launches"]["bias_relu_pool_lrn_halves"] == \
            2 * batches * bf16
    eng = engine.InferenceEngine(init_params(0))
    p, s = eng.predict_specs(specs)
    model, w_s2d = eng._replicas[0]

    def joined(ep, vis, rev):
        pre = fused_conv1.conv1_fused_raster(ep, vis, rev, w_s2d)
        h = k2(pre, model.conv1.bias).permute(0, 3, 1, 2)
        h = torch.cat(alexnet.conv_halves(model.conv2, h.chunk(2, dim=1),
                                          bias=False), dim=1)
        h = k2(h.permute(0, 2, 3, 1), model.conv2.bias).permute(0, 3, 1, 2)
        for stage in model.stages()[2:]:
            h = stage(h)
        return h
    ep, vis, rev = (torch.from_numpy(a).to(cuda)
                    for a in rasterize.specs_to_endpoints(specs))
    preds, softs = [], []
    with torch.inference_mode():
        for i in range(0, len(specs), eng.batch_size):
            seg = (ep[i:i + 128], vis[i:i + 128], rev[i:i + 128])
            want = joined(*seg)
            assert torch.equal(engine.fused_logits(model, w_s2d, *seg), want)
            preds.append(want.argmax(dim=1))
            softs.append(torch.softmax(want, dim=1).amax(dim=1))
    assert np.array_equal(p, torch.cat(preds).cpu().numpy())
    assert np.array_equal(s, torch.cat(softs).float().cpu().numpy())


@pytest.mark.parametrize("s2d", [True, False])
def test_device_step_graph_equals_eager(cuda, s2d):
    """fit_device's step (make_device_step) at keep_prob 1 without
    augmentation: after the eager warm-up steps, the first replay against
    an eager step from the same weights, momentum and batch: the same loss
    and parameters within 1e-6 of their largest entries (conv5's max-pool
    backward adds with atomics on the card, so not bit for bit). K1 runs
    once a step on the image path, K2 and its backward twice a step on
    both, replays counted."""
    from svision_tpu_torch import graphs
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import (AlexNet, params_to_numpy)
    from bench import random_specs
    n = 16 * (graphs.WARMUP_STEPS + 1)
    seg = [torch.from_numpy(a).to(cuda) for a in
           rasterize.specs_to_endpoints(random_specs(n, seed=3))]
    labels = torch.arange(n, device=cuda) % 5
    flip = torch.zeros((), dtype=torch.bool, device=cuda)

    def trainer(model, eager):
        return train.make_device_step(
            model, *seg, labels, torch.Generator(device=cuda).manual_seed(0),
            batch_size=16, keep_prob=1.0, augment=False, s2d=s2d, eager=eager)

    model = AlexNet.trainable(init_params(0), device=cuda)
    opt, step = trainer(model, eager=False)
    before = _launches()
    rows = [torch.arange(16 * i, 16 * (i + 1), device=cuda)
            for i in range(graphs.WARMUP_STEPS + 1)]
    for idx in rows[:-1]:
        step(idx, flip)
    twin = AlexNet.trainable(params_to_numpy(dict(model.named_parameters())),
                             device=cuda)
    twin_opt, twin_step = trainer(twin, eager=True)
    for p, q in zip(model.parameters(), twin.parameters()):
        twin_opt.state[q]["momentum_buffer"] = \
            opt.state[p]["momentum_buffer"].clone()
    got, want = float(step(rows[-1], flip)), float(twin_step(rows[-1], flip))
    steps = 2 + graphs.WARMUP_STEPS
    assert {k: v - before[k] for k, v in _launches().items()} == {
        "render_raster": 0 if s2d else steps, "bias_relu_pool_lrn": 2 * steps,
        "bias_relu_pool_lrn_backward": 2 * steps, "conv1_fused_raster": 0,
        "specs_endpoints": 0, "bias_relu_pool_lrn_halves": 0,
        **dict.fromkeys(MOE_WRAPPERS, 0)}
    assert abs(got - want) <= 1e-6 * abs(want)
    for (k, p), q in zip(model.named_parameters(), twin.parameters()):
        assert (p - q).abs().max() <= 1e-6 * q.abs().max(), k


def test_graphed_dropout_draws_new_masks(cuda):
    """Replays at keep_prob 0.5 on one batch with a zero learning rate (the
    weights stay put) draw new dropout masks: every loss differs."""
    from svision_tpu_torch import graphs
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import AlexNet
    model = AlexNet.trainable(init_params(0), device=cuda)
    _, step = train.make_train_step(model, learning_rate=0.0, keep_prob=0.5)
    x = raster_kernel.render_images(*_batch(cuda, 16))
    y = torch.arange(16, device=cuda) % 5
    gen = torch.Generator(device=cuda).manual_seed(0)
    losses = [float(step(x, y, gen)) for _ in range(graphs.WARMUP_STEPS + 3)]
    assert len(set(losses)) == len(losses), losses


@pytest.mark.parametrize("keep_prob", [1.0, 0.5])
def test_mesh_step_graphs_equal_eager(cuda, keep_prob):
    """The DP x TP step (make_mesh_train_step) on a 2 x 2 grid of four
    cells of one GPU: after the eager warm-up steps its first replay (one
    CUDA graph a piece, 16 in all) against an eager twin (eager=True) from
    the same weights, momentum and generator state: the same loss and
    parameters within 1e-6 of their largest entries (max-pool's backward
    adds with atomics). At keep_prob 0.5 the graphs draw the eager step's
    dropout masks: the twin's generator starts where the graphed one is."""
    from svision_tpu_torch import graphs
    from svision_tpu_torch.models import train
    from svision_tpu_torch.parallel import mesh as M
    cuda = torch.device("cuda", torch.cuda.current_device())
    grid = ((cuda, cuda), (cuda, cuda))
    x = raster_kernel.render_images(*_batch(cuda, 8))
    y = torch.arange(8, device=cuda) % 5
    cells = M.shard_params_tp(init_params(0), grid)
    gen = {cuda: torch.Generator(device=cuda).manual_seed(0)}
    opts, step = train.make_mesh_train_step(
        cells, learning_rate=5e-3, clip_norm=1.0, keep_prob=keep_prob)
    for _ in range(graphs.WARMUP_STEPS):
        step(x, y, gen)
    twin = tuple(tuple({k: t.detach().clone().requires_grad_(True)
                        for k, t in cell.items()} for cell in row)
                 for row in cells)
    twin_opts, twin_step = train.make_mesh_train_step(
        twin, learning_rate=5e-3, clip_norm=1.0, keep_prob=keep_prob,
        eager=True)
    for c, opt in opts.items():
        for p, q in zip(opt.param_groups[0]["params"],
                        twin_opts[c].param_groups[0]["params"]):
            twin_opts[c].state[q]["momentum_buffer"] = \
                opt.state[p]["momentum_buffer"].clone()
    twin_gen = {cuda: torch.Generator(device=cuda)}
    twin_gen[cuda].set_state(gen[cuda].get_state())
    got, want = float(step(x, y, gen)), float(twin_step(x, y, twin_gen))
    assert len(step.pieces.graphs) == 16 and step.pieces.replaying
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    for row, trow in zip(cells, twin):
        for cell, tcell in zip(row, trow):
            for k, p in cell.items():
                q = tcell[k]
                assert (p - q).abs().max() <= 1e-6 * q.abs().max(), k


# ---------------------------------------------------------------------------
# V-MoE: the MoE kernels (ops/moe.py, csrc/moe.cu) at V-MoE-B/16's widths
# on the engine's batch of 128 images: T = 128 x 197 tokens, E = 32, k = 2
# ---------------------------------------------------------------------------

VMOE_T, VMOE_E, VMOE_K, VMOE_D, VMOE_M = 128 * 197, 32, 2, 768, 3072


def _vmoe_logits(case, dev, seed=0):
    """Router logits f32 [T,E] of one routing case: 'skewed' (most tokens
    on two experts, as blank patches route, and expert 5 given no row),
    'one' (every token's first expert is expert 3: it takes every row
    once), 'even' (random) or 'ties' (every logit of a token equal: the
    lower index wins)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((VMOE_T, VMOE_E), generator=g)
    if case == "skewed":
        x[: VMOE_T * 9 // 10, 7] += 6.0
        x[: VMOE_T * 9 // 10, 11] += 5.0
        x[:, 5] = -1e4
    elif case == "one":
        x[:, 3] += 1e3
    elif case == "ties":
        x[:] = 0.25
    return x.to(dev)


@pytest.mark.parametrize("case", ["skewed", "one", "even", "ties"])
def test_vmoe_route_kernel(cuda, case):
    """The route kernel against its plain version run on the card: the top
    experts, ranks, block bases and offsets bit for bit, the gates within
    f32 rounding of exp and of the softmax's sum (2e-6 relative), and the
    histogram's rows; one launch a call."""
    from svision_tpu_torch.ops import moe
    logits = _vmoe_logits(case, cuda)
    rows = torch.zeros(VMOE_E, dtype=torch.int64, device=cuda)
    before = moe.moe_route.launches
    got = moe.moe_route(logits, VMOE_K, rows)
    assert moe.moe_route.launches == before + 1
    want_rows = torch.full_like(rows, 7)
    want = moe.moe_route_plain(logits, VMOE_K, want_rows)
    for name, g, w in zip(("top", "gates", "ranks", "bases", "offsets"),
                          got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "gates":
            torch.testing.assert_close(g, w, rtol=2e-6, atol=1e-30)
        else:
            assert torch.equal(g, w), name
    assert torch.equal(rows + 7, want_rows)
    assert int(got[4][-1]) == VMOE_T * VMOE_K
    if case == "skewed":
        assert int(rows[5]) == 0
    if case == "one":
        assert int(rows[3]) == VMOE_T
    if case == "ties":
        assert torch.equal(got[0][:, 0], torch.zeros_like(got[0][:, 0]))


@pytest.mark.parametrize("case", ["skewed", "one"])
def test_vmoe_dispatch_bias_gelu_combine_kernels(cuda, case):
    """Dispatch and combine against their plain versions on the card, bit
    for bit (the same f32 operations in the same order); the bias-GELU
    within one bf16 step (2^-7 relative) of its plain version: the card's
    erff and torch's erf may round an f32 apart, which can move a bf16
    rounding by a step. One launch each a call."""
    from svision_tpu_torch.ops import moe
    g = torch.Generator(device="cpu").manual_seed(1)
    u = torch.randn((VMOE_T, VMOE_D), generator=g).to(cuda, torch.bfloat16)
    y = torch.randn((VMOE_T, VMOE_D), generator=g).to(cuda, torch.bfloat16)
    b1 = torch.randn((VMOE_E, VMOE_M), generator=g).to(cuda, torch.bfloat16)
    b2 = torch.randn((VMOE_E, VMOE_D), generator=g).to(cuda, torch.bfloat16)
    top, gates, ranks, bases, offsets = moe.moe_route(
        _vmoe_logits(case, cuda), VMOE_K)
    before = [f.launches for f in (moe.moe_dispatch, moe.moe_bias_gelu,
                                   moe.moe_combine)]
    xs, slots = moe.moe_dispatch(u, top, ranks, bases)
    want_xs, want_slots = moe.moe_dispatch_plain(u, top, ranks, bases)
    assert torch.equal(xs, want_xs) and torch.equal(slots, want_slots)
    h = torch.randn((VMOE_T * VMOE_K, VMOE_M), generator=g).to(
        cuda, torch.bfloat16)
    want_h = moe.moe_bias_gelu_plain(h.clone(), b1, offsets)
    assert moe.moe_bias_gelu(h, b1, offsets) is h
    torch.testing.assert_close(h.float(), want_h.float(), rtol=2 ** -7,
                               atol=1e-30)
    assert float((h != want_h).float().mean()) < 1e-3
    h2 = torch.randn((VMOE_T * VMOE_K, VMOE_D), generator=g).to(
        cuda, torch.bfloat16)
    out = moe.moe_combine(y, h2, b2, top, gates, slots)
    assert torch.equal(out, moe.moe_combine_plain(y, h2, b2, top, gates,
                                                  slots))
    assert [f.launches for f in (moe.moe_dispatch, moe.moe_bias_gelu,
                                 moe.moe_combine)] == [b + 1 for b in before]


def _vmoe_weights(dev, seed=2):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def draw(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).to(dev)
    return dict(router=draw(VMOE_D, VMOE_E, scale=0.05),
                w1=draw(VMOE_E, VMOE_D, VMOE_M, scale=0.036).bfloat16(),
                b1=draw(VMOE_E, VMOE_M, scale=0.1).bfloat16(),
                w2=draw(VMOE_E, VMOE_M, VMOE_D, scale=0.018).bfloat16(),
                b2=draw(VMOE_E, VMOE_D, scale=0.1).bfloat16())


def test_vmoe_expert_mm_against_f32(cuda):
    """The grouped product (torch._grouped_mm with its offsets on the card)
    against an f32 product of each expert's rows, with one expert given no
    rows: within bf16's rounding of the output (2^-8 relative) plus f32
    sums in other orders (1e-3 of the row's scale)."""
    from svision_tpu_torch.ops import moe
    w = _vmoe_weights(cuda)
    top, _, _, _, offsets = moe.moe_route(_vmoe_logits("skewed", cuda),
                                          VMOE_K)
    assert int(offsets[5] - offsets[4]) == 0
    x = torch.randn((VMOE_T * VMOE_K, VMOE_D), device=cuda).bfloat16()
    got = moe.expert_mm(x, w["w1"], offsets).float()
    want = moe.expert_mm_plain(x.float(), w["w1"].float(), offsets)
    err = (got - want).abs() - 2 ** -8 * want.abs()
    assert float(err.max()) <= 1e-3 * float(want.abs().max())


def test_vmoe_layer_graph_replays(cuda):
    """moe_mlp (the sparse layer) captured once in a CUDA graph on static
    inputs, then replayed as the routing changes under it (every token's
    first expert made expert 0, then a random router: even), equals its
    eager result on the same inputs bit for bit, and its histogram gains
    each replay's rows; the graph holds one launch of each MoE kernel."""
    from svision_tpu_torch import graphs
    from svision_tpu_torch.ops import moe
    w = _vmoe_weights(cuda)
    g = torch.Generator(device="cpu").manual_seed(3)
    y = torch.randn((VMOE_T, VMOE_D), generator=g).to(cuda, torch.bfloat16)
    u = torch.randn((VMOE_T, VMOE_D), generator=g).to(cuda, torch.bfloat16)
    rows = torch.zeros(VMOE_E, dtype=torch.int64, device=cuda)

    def layer():
        return moe.moe_mlp(y, u, w["router"], w["w1"], w["b1"], w["w2"],
                           w["b2"], VMOE_K, rows)
    with torch.inference_mode():
        layer()
        graph = graphs.capture(layer, cuda)
    assert graph.launches == tuple((f, 1) for f in (
        moe.moe_route, moe.moe_dispatch, moe.moe_bias_gelu, moe.moe_combine))
    # positive u through a router of ones on expert 0 (0 elsewhere: expert
    # 1 wins the ties) puts every token on experts 0 and 1; then a random
    # router on random u spreads them
    one = torch.zeros((VMOE_D, VMOE_E))
    one[:, 0] = 1.0
    for router, x in ((one, torch.randn((VMOE_T, VMOE_D), generator=g).abs()),
                      (0.05 * torch.randn((VMOE_D, VMOE_E), generator=g),
                       torch.randn((VMOE_T, VMOE_D), generator=g))):
        w["router"].copy_(router.to(cuda))
        u.copy_(x.to(cuda, torch.bfloat16))
        rows.zero_()
        got = graph.replay().clone()
        replayed = rows.clone()
        rows.zero_()
        with torch.inference_mode():
            want = layer()
        assert torch.equal(got, want)
        assert torch.equal(replayed, rows)
        assert int(rows.sum()) == VMOE_T * VMOE_K
        if router is one:
            assert int(rows[0]) == int(rows[1]) == VMOE_T
    # the last router spreads the rows; the first put every token on 0
    assert int(rows.max()) < VMOE_T // 4


@pytest.mark.parametrize("bad", ["f32", "misaligned", "k"])
def test_vmoe_wrappers_reject_bad_inputs(cuda, bad):
    from svision_tpu_torch.ops import moe
    logits = _vmoe_logits("even", cuda)[:256].contiguous()
    top, gates, ranks, bases, offsets = moe.moe_route(logits, VMOE_K)
    u = torch.zeros((256, VMOE_D), dtype=torch.bfloat16, device=cuda)
    if bad == "f32":
        with pytest.raises(ValueError):
            moe.moe_dispatch(u.float(), top, ranks, bases)
        with pytest.raises(ValueError):
            moe.moe_route(logits.double(), VMOE_K)
    elif bad == "misaligned":
        flat = torch.zeros(256 * VMOE_D + 1, dtype=torch.bfloat16,
                           device=cuda)
        with pytest.raises(ValueError):
            moe.moe_dispatch(flat[1:].view(256, VMOE_D), top, ranks, bases)
    else:
        with pytest.raises(ValueError):
            moe.moe_route(logits, VMOE_E + 1)
        with pytest.raises(ValueError):
            moe.moe_combine(u, u, u[:VMOE_E], top, gates, slots=top[:, :1])


def test_vmoe_engine_at_published_widths(cuda):
    """V-MoE-B/16 at its published widths, with the benchmark's fitted
    weights of one seed, through the engine (bf16; bf16=False raises on
    the card): its graph replays give the eager step's answers bit for bit
    (n = 1, 129, a short tail and 8,192); engine.call says network
    vmoe_b16, the experts, k, sparse layers and routed rows, and launches
    K1 once a batch, each MoE kernel once a sparse layer a batch and the
    endpoints kernel once a dispatch; expert_rows() gives every routed row
    once; on 1,024 rows its routing (expert_choices) is the reference's
    but for near-ties: every token routed otherwise falls short of the
    reference's top-k gate mass by at most the cell's tie (engine_vmoe.TIE);
    and its answers lie within the cell's limits of tests/reference_vmoe.py's
    given that routing on those near-ties, computed in f32 (TF32 off) on
    the card from the raster benchmark/reference/raster.py draws."""
    from benchmark import spec
    from benchmark.drivers import engine as bench_engine
    from benchmark.drivers import engine_vmoe
    from benchmark.reference import raster as ref_raster
    from bench import random_specs
    from svision_tpu_torch import trace
    from svision_tpu_torch.infer.engine import InferenceEngine
    from tests import reference_vmoe
    bench = spec.load()
    model = spec.config(bench, "svision-vmoe-b16-e32-bf16")["model"]
    params = {k: v.cpu().numpy()
              for k, v in engine_vmoe.params(model, 1_000_003, cuda).items()}
    with pytest.raises(ValueError, match="bf16"):
        InferenceEngine(params, bf16=False)
    eng = InferenceEngine(params)
    assert eng.network == "vmoe_b16"
    w = eng._replicas[0][0].widths
    assert (w.hidden, w.experts, w.top_k, w.moe_layers) == (
        768, 32, 2, (1, 3, 5, 7, 9, 11))
    eng.warmup()
    eng.expert_rows()
    for n in (1, 129, 17 * 128 + 5, 8192):
        specs = random_specs(n, seed=n)
        with trace.recording([cuda]) as rec:
            p, s = eng.predict_specs(specs)
            rows = eng.expert_rows()
        (call,) = rec.find("engine.call")
        chunks, singles = eng.plan(n)
        batches = sum(chunks) + singles
        routed = batches * 128 * 197 * 2 * 6
        assert call.attrs["network"] == "vmoe_b16"
        assert (call.attrs["experts"], call.attrs["top_k"],
                call.attrs["moe_layers"]) == (32, 2, [1, 3, 5, 7, 9, 11])
        assert call.attrs["routed_rows"] == routed
        assert call.attrs["launches"] == {
            **{k: 0 for k in _launches()}, "render_raster": batches,
            "specs_endpoints": len(chunks) + singles,
            **dict.fromkeys(MOE_WRAPPERS, 6 * batches)}
        assert int(rows.sum()) == routed and rows.shape == (6, 32)
        assert sum(v for k, v in rec.counts.items()
                   if k.startswith("moe.expert_rows/")) == routed
        with torch.inference_mode():
            ep, es = eng._predict(specs, graphed=False)
        eng.expert_rows()
        assert np.array_equal(p, ep) and np.array_equal(s, es), n
    specs = random_specs(1024, seed=31)
    p, s = eng.predict_specs(specs)
    choices = eng.expert_choices(specs)
    assert [c.shape for c in choices] == [(1024, 197, 2)] * 6
    raster = ref_raster.draw(*(torch.from_numpy(np.ascontiguousarray(a))
                               .to(cuda) for a in ref_raster.endpoints(specs)))
    routed, short = [], []
    with torch.no_grad(), reference_vmoe.f32_exact():
        reference_vmoe.logits(params, raster, routed)
        logits = reference_vmoe.logits(params, raster, routing=[
            torch.from_numpy(c).to(cuda).long().reshape(-1, 2)
            for c in choices], tie=engine_vmoe.TIE, shortfall=short)
    # the engine's routing is the reference's but where bf16 rounding
    # moves a near-tie: under a tenth of the tokens a layer, each within
    # the tie of the reference's top-2 gate mass
    for c, r, miss in zip(choices, routed, short):
        differ = (torch.from_numpy(c).to(cuda).long().reshape(-1, 2) != r)
        assert float(differ.any(1).float().mean()) < 0.1
        assert float(miss.max()) <= engine_vmoe.TIE
    assert spec.limits("vmoe-b16.genome")["limits"]["route_miss_max"] == \
        engine_vmoe.TIE
    got = bench_engine.readings(logits, p, s)
    bounds = spec.limits("vmoe-b16.genome")["limits"]
    assert all(got[k] <= v for k, v in bounds.items() if k in got), got
    assert int((np.bincount(p, minlength=5) >= 0.05 * len(p)).sum()) >= 3
