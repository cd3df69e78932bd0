"""The port's bias/ReLU/pool/LRN plain version against the JAX package's
bias_relu_pool_lrn (Pallas kernel in interpret mode, as
tests/test_fused_pool_lrn.py runs it) and its jnp _reference, at the
engine's two shapes. f32 within 1e-5 relative; bf16 input within one bf16
ulp (both sides compute in f32 and round once; the window sums in another
order)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svision_tpu.ops import fused_pool_lrn as J
from svision_tpu_torch.ops import fused_pool_lrn as T

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(J, "_INTERPRET", True)


def _inputs(h, c, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, h, c).astype(np.float32) * 2
    b = rng.randn(c).astype(np.float32)
    return x, b


def _bf16_ulp(v):
    """One bf16 ulp at |v| (at least the smallest normal's)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("h,c", [(55, 96), (27, 256)])
def test_plain_matches_jax_f32(h, c):
    x, b = _inputs(h, c, 0)
    got = T.bias_relu_pool_lrn(torch.from_numpy(x), torch.from_numpy(b))
    got = got.numpy()
    assert got.shape == (2, (h - 3) // 2 + 1, (h - 3) // 2 + 1, c)
    for want in (J.bias_relu_pool_lrn(jnp.asarray(x), jnp.asarray(b),
                                      use_pallas=True),
                 J._reference(jnp.asarray(x), jnp.asarray(b))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("h,c", [(55, 96), (27, 256)])
def test_plain_matches_jax_bf16(h, c):
    x, b = _inputs(h, c, 1)
    xj = jnp.asarray(x, jnp.bfloat16)
    bj = jnp.asarray(b, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    got = T.bias_relu_pool_lrn(xt, bt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (J.bias_relu_pool_lrn(xj, bj, use_pallas=True),
                 J._reference(xj, bj)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))


def test_lrn_is_tf_not_torch_local_response_norm():
    """alpha is not divided by the window size (F.local_response_norm
    would): a single channel of value v gives v / (1 + 2e-5 v^2)^0.75."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 3] = 10.0
    got = T.lrn(x)[..., 3].item()
    assert abs(got - 10.0 / (1 + 2e-5 * 100) ** 0.75) < 1e-6


@pytest.mark.parametrize("form", ["halves-in", "halves-out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,c", [(55, 96), (27, 256)])
def test_split_forms_equal_the_joined_plain(h, c, dtype, form):
    """bias_relu_pool_lrn's split forms on the CPU (the plain version, as
    the bf16 network calls it there) against the joined call on the same
    channels, bit for bit: x as two contiguous channel halves, or the
    output as two. Each such call ticks bias_relu_pool_lrn_halves once,
    the joined call does not, and neither counts a launch."""
    x, b = (torch.from_numpy(a).to(dtype) for a in _inputs(h, c, 2))
    before = (T.bias_relu_pool_lrn.launches,
              T.bias_relu_pool_lrn_halves.launches)
    want = T.bias_relu_pool_lrn(x, b)
    xin = (tuple(t.contiguous() for t in x.chunk(2, dim=-1))
           if form != "halves-out" else x)
    out_halves = form != "halves-in"
    got = T.bias_relu_pool_lrn(xin, b, out_halves=out_halves)
    assert (T.bias_relu_pool_lrn.launches,
            T.bias_relu_pool_lrn_halves.launches) == (before[0],
                                                      before[1] + 1)
    plain = T.bias_relu_pool_lrn_plain(xin, b, out_halves)
    if out_halves:
        assert isinstance(got, tuple) and len(got) == 2
        assert all(t.is_contiguous() and t.shape[-1] == c // 2 for t in got)
        got, plain = torch.cat(got, dim=-1), torch.cat(plain, dim=-1)
    assert got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(plain, want)


def test_split_forms_refuse_bad_halves():
    """x as anything but two halves of one shape, dtype and device is
    refused, and so are halves both in and out, on the CPU as on the
    card."""
    x0 = torch.ones((1, 5, 5, 8))
    b = torch.zeros(16)
    for bad in ((x0, x0[..., :7]), (x0, x0.double()),
                (x0, torch.ones((1, 5, 5, 8), device="meta")), (x0,),
                (x0, x0, x0)):
        with pytest.raises(ValueError, match="channel halves"):
            T.bias_relu_pool_lrn(bad, b)
    with pytest.raises(ValueError, match="not both"):
        T.bias_relu_pool_lrn((x0, x0), b, out_halves=True)
