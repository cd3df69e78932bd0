"""The engine's other raster encoders and the raster network, against the
JAX package's: _line_walk and render_raster_einsum bit for bit on the
fixtures of tests/test_torch_rasterize.py (and equal to render_raster, as
the JAX package's kinds are to each other), space_to_depth equal to
_space_to_depth, and forward_raster on the same folded parameters: f32
logits within 1e-4 with the same argmax, bf16 with the same argmax."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svision_tpu.models import alexnet as ja
from svision_tpu.ops import rasterize as jr
from svision_tpu_torch.models import alexnet as ta
from svision_tpu_torch.ops import rasterize as tr
from tests.test_torch_alexnet import _rand_params
from tests.test_torch_rasterize import _both, _specs

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["random", "degenerate"])
def test_line_walk_bit_exact(kind):
    ep = jr.specs_to_endpoints(_specs(kind))[0]
    want = jr._line_walk(jnp.asarray(ep))
    got = tr._line_walk(torch.from_numpy(ep))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "degenerate"])
def test_render_raster_einsum_bit_exact(kind, dtype):
    j, t = _both(_specs(kind))
    want = np.asarray(jr.render_raster_einsum(*j, dtype=getattr(jnp, dtype)),
                      np.float32)
    got = tr.render_raster_einsum(*t, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    compare = tr.render_raster(*t, dtype=getattr(torch, dtype))
    assert torch.equal(got, compare)


@pytest.mark.parametrize("kind", ["random", "degenerate"])
def test_space_to_depth_matches_jax(kind):
    """Equal to JAX's _space_to_depth, and on a raster to the raster
    emitted in s2d layout."""
    j, t = _both(_specs(kind))
    raster = tr.render_raster(*t, dtype=torch.float32)
    want = np.asarray(ja._space_to_depth(jnp.asarray(raster.numpy())))
    got = ta.space_to_depth(raster)
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tr.render_raster_s2d(*t, dtype=torch.float32))


@pytest.fixture(scope="module")
def raster():
    _, t = _both(_specs("random")[:6])
    return tr.render_raster(*t, dtype=torch.float32)


def test_forward_raster_f32_matches_jax(raster):
    params = _rand_params(seed=4)
    folded = ja.fold_conv1_params(params)
    want = np.asarray(ja.forward_raster(
        {k: jnp.asarray(v) for k, v in folded.items()},
        jnp.asarray(raster.numpy()), compute_dtype=jnp.float32))
    model = ta.AlexNet.from_params(ta.fold_conv1_params(params), s2d=True,
                                   device="cpu")
    got = model.forward_raster(raster).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_forward_raster_bf16_agrees_with_jax(raster):
    """bf16 rounds at other places in the two frameworks: decisions
    agree. The network reads the bf16 raster as it is."""
    params = _rand_params(seed=4)
    want = np.asarray(ja.forward_raster(
        {k: jnp.asarray(v) for k, v in ja.fold_params_bf16(params).items()},
        jnp.asarray(raster.numpy()), compute_dtype=jnp.bfloat16))
    model = ta.AlexNet.from_params(ta.fold_params_bf16(params), s2d=True,
                                   device="cpu")
    got = model.forward_raster(raster.to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert (got.numpy().argmax(1) == want.argmax(1)).all()
