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
from svision_tpu_torch.ops import fused_conv1, fused_pool_lrn, raster_kernel
from svision_tpu_torch.ops import rasterize

pytestmark = pytest.mark.gpu

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
@pytest.mark.parametrize("h,c", [(55, 96), (27, 256)])
def test_pool_lrn_kernel(cuda, dtype, h, c):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn((3, h, h, c), generator=gen, device=cuda) * 2).to(dtype)
    b = torch.randn((c,), generator=gen, device=cuda).to(dtype)
    got = fused_pool_lrn.bias_relu_pool_lrn(x, b).float()
    want = fused_pool_lrn.bias_relu_pool_lrn_plain(x, b).float()
    if dtype == torch.float32:      # f32 inside, same operation order
        assert ((got - want).abs() <= 1e-5 * want.abs() + 1e-6).all()
    else:                           # one bf16 ulp
        ulp = torch.pow(2.0, torch.floor(torch.log2(
            want.abs().clamp_min(2.0 ** -126))) - 7)
        assert ((got - want).abs() <= ulp).all()


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
    return _batch(dev, case)


@pytest.mark.parametrize("case", ["degenerate", "all-dark", "sentinel",
                                  1, 7, 128, 129, 1000])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_conv1_kernel(cuda, dtype, tol, case):
    """Batch sizes that split unevenly over the SMs, with a partial last
    wave, and batches with nothing or almost nothing lit; one launch per
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


def test_wrappers_reject_bad_inputs(cuda):
    ep, vis, rev = _segments(cuda)
    with pytest.raises(ValueError):
        raster_kernel.render_raster(ep.to(torch.int64), vis, rev)
    with pytest.raises(ValueError):
        fused_conv1.conv1_fused_raster(ep, vis, rev,
                                       torch.zeros((3, 3, 48, 95), device=cuda))
