"""The port's InferenceEngine on the CPU against the JAX package's on
bench.random_specs: exact mode argmax equal and softmax within 1e-5, bf16
mode agreeing on at least 95% of argmaxes, and the N=0 and N<batch
shapes."""
import numpy as np
import jax
import pytest
import torch

from bench import random_specs
from svision_tpu.infer.engine import InferenceEngine as JaxEngine
from svision_tpu.models import alexnet as ja
from svision_tpu_torch.infer.engine import InferenceEngine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return {k: np.asarray(v) for k, v in
            ja.init_params(jax.random.PRNGKey(0)).items()}


@pytest.fixture(scope="module")
def specs():
    return random_specs(40, seed=0)


def test_exact_matches_jax(params, specs):
    want_p, want_s = JaxEngine(params, batch_size=16,
                               bf16=False).predict_specs(specs)
    got_p, got_s = InferenceEngine(params, batch_size=16, bf16=False,
                                   device="cpu").predict_specs(specs)
    assert got_p.dtype == np.int64 and got_s.dtype == np.float32
    assert got_p.shape == got_s.shape == (40,)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)


def test_bf16_agrees_with_jax(params, specs):
    want_p, _ = JaxEngine(params, batch_size=16).predict_specs(specs)
    got_p, got_s = InferenceEngine(params, batch_size=16,
                                   device="cpu").predict_specs(specs)
    assert (got_p == want_p).mean() >= 0.95
    assert np.all((got_s > 0) & (got_s <= 1))


def test_empty_and_partial_batches(params, specs):
    eng = InferenceEngine(params, batch_size=16, bf16=False, device="cpu")
    p, s = eng.predict_specs(specs[:0])
    assert p.shape == (0,) and s.shape == (0,)
    p5, s5 = eng.predict_specs(specs[:5])
    p40, s40 = eng.predict_specs(specs)
    assert p5.shape == (5,)
    np.testing.assert_array_equal(p5, p40[:5])
    np.testing.assert_array_equal(s5, s40[:5])


@pytest.mark.parametrize("bf16", [False, True])
def test_pool_lrn_inputs_need_no_copy(params, specs, bf16, monkeypatch):
    """K2's kernel copies nothing and refuses a non-contiguous x: both of
    its inputs on the engine's path (conv1's and conv2's outputs, NHWC)
    are contiguous already, with the bias in x's dtype."""
    from svision_tpu_torch.models import alexnet as ta
    seen, real = [], ta.bias_relu_pool_lrn

    def recording(x, b):
        seen.append((tuple(x.shape[1:]), x.is_contiguous(), x.dtype, b.dtype))
        return real(x, b)
    monkeypatch.setattr(ta, "bias_relu_pool_lrn", recording)
    InferenceEngine(params, batch_size=4, bf16=bf16,
                    device="cpu").predict_specs(specs[:4])
    dt = torch.bfloat16 if bf16 else torch.float32
    assert seen == [((55, 55, 96), True, dt, dt), ((27, 27, 256), True, dt, dt)]
