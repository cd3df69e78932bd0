"""The port's AlexNet against the JAX package's: the parameter layout
round trip, f32 forward (logits within 1e-4, same argmax) on the batch
fixture of tests/test_alexnet.py, the folded s2d forward, the bit-equal
bf16 fold, and TF-semantics LRN within 1e-6."""
import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from svision_tpu.models import alexnet as ja
from svision_tpu_torch.models import alexnet as ta

torch.set_num_threads(2)


def _rand_params(seed=0, num_classes=5):
    """The parameter generator of tests/test_alexnet.py."""
    rng = np.random.RandomState(seed)
    params = {}
    in_ch = 3
    for name, kh, kw, out_ch, _, _, groups in ja._CONV_SPECS:
        params[f"{name}/weights"] = rng.randn(kh, kw, in_ch // groups, out_ch).astype(np.float32) * 0.01
        params[f"{name}/biases"] = rng.randn(out_ch).astype(np.float32) * 0.01
        in_ch = out_ch
    for name, n_in, n_out in ja._FC_SPECS:
        params[f"{name}/weights"] = rng.randn(n_in, n_out).astype(np.float32) * 0.001
        params[f"{name}/biases"] = rng.randn(n_out).astype(np.float32) * 0.01
    return params


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(1)
    img = rng.choice([0.0, 255.0], size=(4, 227, 227, 3), p=[0.97, 0.03]).astype(np.float32)
    img -= np.array(ja.IMAGE_MEAN, dtype=np.float32)
    return img


def test_params_from_numpy_round_trip():
    params = _rand_params(seed=2)
    state = ta.params_from_numpy(params)
    assert tuple(state["conv2.weight"].shape) == (256, 48, 5, 5)
    assert tuple(state["fc6.weight"].shape) == (4096, 9216)
    back = {}
    for key, t in state.items():        # OIHW / [out,in] -> HWIO / [in,out]
        layer, kind = key.split(".")
        if kind == "bias":
            back[f"{layer}/biases"] = t.numpy()
        else:
            t = t.permute(2, 3, 1, 0) if layer.startswith("conv") else t.t()
            back[f"{layer}/weights"] = t.numpy()
    assert back.keys() == params.keys()
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])


def test_forward_matches_jax(batch):
    params = _rand_params()
    want = np.asarray(ja.forward(params, jnp.asarray(batch)))
    model = ta.AlexNet.from_params(params, device="cpu")
    got = model(torch.from_numpy(batch)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_forward_s2d_matches_jax(batch):
    params = _rand_params(seed=4)
    folded = ja.fold_conv1_params(params)
    raster = (batch + np.array(ja.IMAGE_MEAN, np.float32)) / 255.0
    h = np.array(ja._space_to_depth(jnp.asarray(raster)))
    want = np.asarray(ja.forward_s2d(folded, jnp.asarray(h),
                                     compute_dtype=jnp.float32))
    model = ta.AlexNet.from_params(ta.fold_conv1_params(params), s2d=True,
                                   device="cpu")
    got = model.forward_s2d(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_bf16_forward_s2d_agrees_with_jax(batch):
    """bf16 rounds at other places in the two frameworks (torch adds the
    bias before rounding the conv output, JAX after): decisions agree."""
    params = _rand_params(seed=4)
    raster = (batch + np.array(ja.IMAGE_MEAN, np.float32)) / 255.0
    h = np.array(ja._space_to_depth(jnp.asarray(raster)))
    jf = ja.fold_params_bf16(params)
    want = np.asarray(ja.forward_s2d(jf, jnp.asarray(h),
                                     compute_dtype=jnp.bfloat16))
    model = ta.AlexNet.from_params(ta.fold_params_bf16(params), s2d=True,
                                   device="cpu")
    got = model.forward_s2d(torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert (got.numpy().argmax(1) == want.argmax(1)).all()


def test_fold_params_bf16_bit_equal():
    params = _rand_params(seed=5)
    want = ja.fold_params_bf16(params)
    got = ta.fold_params_bf16(params)
    assert want.keys() == got.keys()
    for k in want:
        if k == "fc8/biases":
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k])
            continue
        assert want[k].dtype == ml_dtypes.bfloat16
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                      want[k].view(np.int16))


def test_lrn_matches_jax():
    x = np.random.RandomState(2).randn(2, 5, 5, 96).astype(np.float32)
    want = np.asarray(ja.lrn(jnp.asarray(x)))
    got = ta.lrn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
