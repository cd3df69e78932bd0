"""The port's InferenceEngine on the CPU against the JAX package's on
bench.random_specs: exact mode argmax equal and softmax within 1e-5, bf16
mode agreeing on at least 95% of argmaxes, the N=0 and N<batch shapes, and
the chunked dispatch plan: the same dispatches as the JAX engine's, and
outputs that do not depend on chunk or tail."""
import numpy as np
import jax
import jax.numpy as jnp
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
    are contiguous already, with the bias in x's dtype. The bf16 network
    runs its groups split: K2 hands conv1's tail on as two contiguous
    halves, and takes conv2's two output halves as they are."""
    from svision_tpu_torch.models import alexnet as ta
    seen, real = [], ta.bias_relu_pool_lrn

    def recording(x, b, out_halves=False):
        xs = x if isinstance(x, tuple) else (x,)
        out = real(x, b, out_halves=out_halves)
        outs = out if isinstance(out, tuple) else (out,)
        seen.append(([tuple(t.shape[1:]) for t in xs],
                     all(t.is_contiguous() for t in xs + outs),
                     len(outs), x[0].dtype if len(xs) == 2 else x.dtype,
                     b.dtype))
        return out
    monkeypatch.setattr(ta, "bias_relu_pool_lrn", recording)
    InferenceEngine(params, batch_size=4, bf16=bf16,
                    device="cpu").predict_specs(specs[:4])
    dt = torch.bfloat16 if bf16 else torch.float32
    if bf16:
        assert seen == [([(55, 55, 96)], True, 2, dt, dt),
                        ([(27, 27, 128)] * 2, True, 1, dt, dt)]
    else:
        assert seen == [([(55, 55, 96)], True, 1, dt, dt),
                        ([(27, 27, 256)], True, 1, dt, dt)]


@pytest.mark.parametrize("tail", ["full", "pow2"])
@pytest.mark.parametrize("chunk", [2, 4])
def test_plan_matches_jax_dispatches(params, chunk, tail, monkeypatch):
    """plan(n) against the dispatches the JAX engine makes for n specs, at
    batch 8, n from 0 to 40 batches plus a remainder: its device steps are
    wrapped to record their batch counts (and return zeros, so nothing is
    compiled)."""
    import svision_tpu.infer.engine as je
    calls = []

    def many(params, ep, vis, rev, **kw):
        calls.append(("chunk", ep.shape[0]))
        m = ep.shape[0] * ep.shape[1]
        return jnp.zeros(m, jnp.int32), jnp.zeros(m, jnp.float32)

    def single(params, ep, vis, rev, **kw):
        calls.append(("single", 1))
        return jnp.zeros(ep.shape[0], jnp.int32), jnp.zeros(ep.shape[0])
    monkeypatch.setattr(je, "_device_step_many", many)
    monkeypatch.setattr(je, "_device_step_fast", single)
    monkeypatch.setattr(je, "_device_step", single)
    jeng = JaxEngine(params, batch_size=8, chunk=chunk, tail=tail)
    eng = InferenceEngine(params, batch_size=8, bf16=False, chunk=chunk,
                          tail=tail, device="cpu")
    specs = random_specs(8 * 41, seed=2)
    for n in [8 * k + r for k in range(41) for r in (0, 5)]:
        calls.clear()
        jeng.predict_specs(specs[:n])
        chunks, singles = eng.plan(n)
        assert [("chunk", c) for c in chunks] + [("single", 1)] * singles \
            == calls, n


@pytest.mark.parametrize("bf16", [False, True])
def test_outputs_do_not_depend_on_plan(params, bf16):
    """83 specs at batch 4 (21 batches) under plans of 21 single-batch
    chunks, chunks of 2 and a single batch, chunks of 4 and a power-of-2
    tail, and one 32-batch chunk (a tail longer than 16 batches padded to
    a full chunk): the same outputs, bit for bit."""
    specs = random_specs(83, seed=1)
    got = []
    for chunk, tail in ((1, "full"), (2, "full"), (4, "pow2"), (32, "full")):
        eng = InferenceEngine(params, batch_size=4, bf16=bf16, chunk=chunk,
                              tail=tail, device="cpu")
        got.append((eng.plan(83), eng.predict_specs(specs)))
    assert [plan for plan, _ in got] == [([1] * 21, 0), ([2] * 10, 1),
                                         ([4] * 5 + [1], 0), ([32], 0)]
    for _, (p, s) in got[1:]:
        np.testing.assert_array_equal(p, got[0][1][0])
        np.testing.assert_array_equal(s, got[0][1][1])


def test_plan_options_are_checked(params):
    with pytest.raises(ValueError):
        InferenceEngine(params, batch_size=4, chunk=0, device="cpu")
    with pytest.raises(ValueError):
        InferenceEngine(params, batch_size=4, tail="half", device="cpu")
