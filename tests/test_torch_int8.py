"""The port's int8 network (models/int8.py) against the JAX package's.

quantize_params_int8 and the activation quantizer give the same bits; the
im2col + torch._int_mm convolutions, the two groups split by hand, give
XLA's int32 sums bit for bit at every AlexNet layer; int_mm pads a first
operand of 16 rows or fewer. forward_raster_int8 at full width, batch 16,
on tests/test_int8.py's parameters and rasters: logits within 1e-4 of the
JAX package's, and the same argmax wherever JAX's top two logits are more
than 2e-4 apart; against the f32 forward_raster within test_int8.py's
bars. The 1e-4 comes from the LRN: the port's bias/ReLU/pool/LRN computes
it in f32 and rounds once, the JAX package rounds each of its steps to
bf16, and a changed bf16 value can move an int8 step of the next layer.
Over 3 parameter seeds x 3 raster seeds the difference was at most 3.0e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svision_tpu.models import alexnet as ja
from svision_tpu_torch.models import alexnet as ta
from svision_tpu_torch.models import int8 as ti
from tests.test_int8 import _random_raster, _trained_like_params

torch.set_num_threads(2)

TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return _trained_like_params()


@pytest.fixture(scope="module")
def qparams(params):
    return ti.quantize_params_int8(ta.fold_conv1_params(params))


def test_quantize_params_bit_equal(params, qparams):
    want = ja.quantize_params_int8(ja.fold_conv1_params(params))
    assert want.keys() == qparams.keys()
    for k in want:
        assert qparams[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(qparams[k], want[k], err_msg=k)
    assert qparams["conv2/weights"].dtype == np.int8
    assert qparams["fc8/weights"].dtype == np.float32


def test_quantize_act_bit_equal():
    """The same int8 values and the same f32 scale, on bf16 activations
    whose max is 127, so that the scale is 1 and the values k + 0.5 among
    them are ties, which round to even."""
    rng = np.random.RandomState(3)
    x = np.clip(rng.standard_normal((4, 13, 13, 256)) * 40, -126, 126)
    x.flat[0] = 127.0
    x.flat[1:65] = np.arange(64) - 32 + 0.5
    xb = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
    want8, want_s = ja._quantize_act(xb)
    assert float(want_s) == 1.0
    got8, got_s = ti.quantize_act(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert got8.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_s.dim() == 0
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    assert got_s.item() == float(want_s)


@pytest.mark.parametrize("layer", ["conv1", "conv2", "conv3", "conv4",
                                   "conv5"])
def test_int8_conv_matches_xla(qparams, layer):
    """im2col + torch._int_mm, per group, against lax.conv_general_dilated
    with int32 accumulation, per group as the JAX package runs it: the
    same int32 sums, bit for bit."""
    model = ti.AlexNetInt8.from_params(qparams, device="cpu")
    name, k, pad, groups = next(c for c in model.convs if c[0] == layer)
    cin = {"conv1": 48, "conv2": 96, "conv3": 256, "conv4": 384,
           "conv5": 384}[layer]
    hw = {"conv1": 57, "conv2": 27}.get(layer, 13)
    rng = np.random.RandomState(7)
    x8 = rng.randint(-127, 128, (2, hw, hw, cin)).astype(np.int8)
    w8 = jnp.asarray(qparams[f"{layer}/weights"])
    padding = "VALID" if layer == "conv1" else "SAME"

    def one(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
    gi, go = cin // groups, w8.shape[-1] // groups
    want = jnp.concatenate(
        [one(jnp.asarray(x8[..., g * gi:(g + 1) * gi]),
             w8[..., g * go:(g + 1) * go]) for g in range(groups)], axis=-1)
    got = model._conv8(name, torch.from_numpy(x8), k, pad, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows", [1, 8, 16, 17, 40])
def test_int_mm_pads_few_rows(rows, monkeypatch):
    """torch._int_mm on the card wants more than 16 rows: int_mm hands it
    at least 17 and returns the caller's rows, the exact int32 product."""
    seen = []
    real = torch._int_mm

    def recording(a, b):
        seen.append(a.shape[0])
        return real(a, b)
    monkeypatch.setattr(torch, "_int_mm", recording)
    rng = np.random.RandomState(rows)
    a = torch.from_numpy(rng.randint(-127, 128, (rows, 64)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (24, 64)).astype(np.int8))
    got = ti.int_mm(a, w.t())
    assert seen == [max(rows, ti.MIN_ROWS)]
    assert tuple(got.shape) == (rows, 24) and got.dtype == torch.int32
    assert torch.equal(got, a.int() @ w.int().t())


def test_int8_grouped_conv_workaround(qparams):
    """tests/test_int8.py's check of the manual group split, on the port's
    split conv: within 3% of the f32 grouped conv's largest value."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 80, (2, 27, 27, 96)).astype(np.float32)
    w = rng.normal(0, 0.05, (5, 5, 48, 256)).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=2,
        preferred_element_type=jnp.float32))
    sw = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12) / 127.0
    q = dict(qparams)
    q["conv2/weights"] = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
    model = ti.AlexNetInt8.from_params(q, device="cpu")
    x8, sx = ti.quantize_act(torch.from_numpy(x))
    y = model._conv8("conv2", x8, 5, 2, 2)
    got = y.numpy().astype(np.float32) * (sw * sx.item())
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 0.03, rel


def test_forward_raster_int8_matches_jax(params, qparams):
    raster = _random_raster(16)
    want = np.asarray(jax.jit(ja.forward_raster_int8)(
        {k: jnp.asarray(v)
         for k, v in ja.quantize_params_int8(
             ja.fold_conv1_params(params)).items()},
        jnp.asarray(raster)))
    model = ti.AlexNetInt8.from_params(qparams, device="cpu")
    got = model(torch.from_numpy(raster).to(torch.bfloat16))
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 5)
    got = got.numpy()
    assert np.abs(got - want).max() <= TOL
    top = np.sort(want, axis=1)
    clear = top[:, -1] - top[:, -2] > 2 * TOL
    assert clear.any()
    assert (got.argmax(1) == want.argmax(1))[clear].all()


def test_forward_raster_int8_concordance(params, qparams):
    """tests/test_int8.py's bars, on the port: against the f32
    forward_raster, argmax agreement >= 0.9 and |logit error| <= 0.25 x
    the largest logit spread (at least 1)."""
    raster = torch.from_numpy(_random_raster(16))
    exact = ta.AlexNet.from_params(ta.fold_conv1_params(params), s2d=True,
                                   device="cpu").forward_raster(raster).numpy()
    turbo = ti.AlexNetInt8.from_params(qparams, device="cpu")(
        raster.to(torch.bfloat16)).numpy()
    assert turbo.shape == exact.shape
    spread = exact.max(1) - exact.min(1)
    assert (turbo.argmax(1) == exact.argmax(1)).mean() >= 0.9
    assert np.abs(turbo - exact).max() <= 0.25 * max(spread.max(), 1.0)
