"""The exact step's fused route, the folded f32 network fed by the fused
raster+conv1 kernel (infer/engine.py:fused_logits), on the CPU, where the
kernel takes its plain version: against the JAX package's exact step
(_device_step, the unfolded reference network) and its fast step in f32
(_device_step_fast on the folded weights, raster_kind 's2d'). Argmax
equal, max softmax within 1e-5 and logits within 1e-4 of the batch's
largest logit, on bench.random_specs, an all-dark batch and a densely lit
one (timing.diagonal_specs). The logits are held as the kernels' outputs
are, relative to their scale: on the densely lit batch two f32 networks of
two frameworks differ by cancellation noise of about 3e-4 at logits near
150, beyond rtol = atol = 1e-4 for the port's unfolded network too.

The exact engine takes this route on the card: the replicas it builds
there, built on the CPU, are held to the CPU exact engine at the same bars;
on the CPU the engine keeps the unfolded network."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bench import random_specs
from svision_tpu.infer import engine as je
from svision_tpu.models import alexnet as ja
from svision_tpu.ops import rasterize as jr
from svision_tpu_torch.infer.engine import (InferenceEngine, exact_f32,
                                            fused_logits)
from svision_tpu_torch.models.alexnet import AlexNet, fold_conv1_params
from svision_tpu_torch.ops.raster_kernel import render_images
from svision_tpu_torch.timing import diagonal_specs

torch.set_num_threads(2)

N = 12


@pytest.fixture(scope="module")
def params():
    return {k: np.asarray(v) for k, v in
            ja.init_params(jax.random.PRNGKey(0)).items()}


def _specs(case):
    if case == "random":
        return random_specs(N, seed=7)
    if case == "dense":
        return diagonal_specs(N, seed=3)
    specs = random_specs(N, seed=8)
    specs[:, [4, 9]] = 1
    # segments off the read axis: clipped away, nothing lit
    specs[:, [0, 5]] = specs[:, 10:11] * 2
    return specs


def _segments(case):
    ep, vis, rev = jr.specs_to_endpoints(_specs(case))
    if case == "all-dark":
        assert not vis.any()
    return ep, vis, rev


def _port(params, seg):
    """The fused route's step on the CPU: logits, argmax, max softmax."""
    model = AlexNet.from_params(fold_conv1_params(params), s2d=True,
                                device="cpu")
    with torch.inference_mode():
        logits = fused_logits(model, model.conv1_weight_hwio(),
                              *(torch.from_numpy(a) for a in seg))
    return (logits.numpy(), logits.argmax(dim=1).numpy(),
            torch.softmax(logits, dim=1).amax(dim=1).numpy())


def _jax_exact(params, seg):
    """_device_step's logits (its body), and its outputs."""
    ep, vis, rev = (jnp.asarray(a) for a in seg)
    images = jr.render_images(ep, vis, rev, dtype=jnp.float32)
    logits = ja.forward(params, images, compute_dtype=jnp.float32)
    p, s = je._device_step(params, ep, vis, rev, compute_dtype=jnp.float32)
    return np.asarray(logits), np.asarray(p), np.asarray(s)


def _jax_fast(params, seg):
    """_device_step_fast's logits (its 's2d' body) on the folded weights, in
    f32, and its outputs."""
    folded = ja.fold_conv1_params(params)
    ep, vis, rev = (jnp.asarray(a) for a in seg)
    raster = jr.render_raster_s2d(ep, vis, rev, dtype=jnp.float32)
    logits = ja.forward_s2d(folded, raster, compute_dtype=jnp.float32)
    p, s = je._device_step_fast(folded, ep, vis, rev,
                                compute_dtype=jnp.float32, raster_kind="s2d")
    return np.asarray(logits), np.asarray(p), np.asarray(s)


@pytest.mark.parametrize("reference", ["exact", "fast_f32"])
@pytest.mark.parametrize("case", ["random", "all-dark", "dense"])
def test_exact_fused_step_matches_jax(params, case, reference):
    seg = _segments(case)
    want_logits, want_p, want_s = (_jax_exact if reference == "exact"
                                   else _jax_fast)(params, seg)
    np.testing.assert_allclose(want_logits.argmax(1), want_p)
    logits, p, s = _port(params, seg)
    assert logits.shape == (N, 5) and logits.dtype == np.float32
    np.testing.assert_array_equal(p, want_p)
    np.testing.assert_allclose(s, want_s, rtol=0, atol=1e-5)
    scale = np.abs(want_logits).max()
    assert np.abs(logits - want_logits).max() <= 1e-4 * scale


def test_exact_engine_keeps_the_unfolded_network(params):
    """The exact engine runs the JAX engine's unfolded form (the images
    into the reference network), not fused_logits: its outputs are
    _device_step's, and its network reads [N,227,227,3] images."""
    eng = InferenceEngine(params, batch_size=N, bf16=False, device="cpu")
    assert eng.compute_dtype == torch.float32
    model, w_s2d = eng._replicas[0]
    assert w_s2d is None and not model.s2d
    specs = _specs("random")
    p, s = eng.predict_specs(specs)
    _, want_p, want_s = _jax_exact(params, jr.specs_to_endpoints(specs))
    np.testing.assert_array_equal(p, want_p)
    np.testing.assert_allclose(s, want_s, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "all-dark", "dense"])
def test_card_exact_replica_matches_the_cpu_exact_engine(params, case):
    """The replicas the exact engine builds for the card
    (InferenceEngine._replicas_for with device type 'cuda'), built here on
    two CPU devices as --mesh builds them: each the folded f32 network
    (s2d=True) with its conv1 weights kept for the fused kernel. The
    engine's _step on one of them, on CPU tensors under exact_f32(),
    against the CPU exact engine (the unfolded network): argmax equal, max
    softmax within 1e-5, and logits within 1e-4 of the batch's largest."""
    eng = InferenceEngine(params, batch_size=N, bf16=False,
                          devices=("cpu", "cpu"))
    replicas = eng._replicas_for(params, "cuda")
    assert len(replicas) == 2
    folded = fold_conv1_params(params)
    for model, w_s2d in replicas:
        assert model.s2d and model.compute_dtype == torch.float32
        assert model.split_groups == 0
        assert w_s2d.dtype == torch.float32
        assert torch.equal(w_s2d, torch.from_numpy(folded["conv1/weights"]))
        assert torch.equal(model.conv1.bias,
                           torch.from_numpy(folded["conv1/biases"]))
    model, w_s2d = replicas[0]
    seg = tuple(torch.from_numpy(a) for a in _segments(case))
    cpu_model, cpu_w = eng._replicas[0]
    assert cpu_w is None and not cpu_model.s2d
    with torch.inference_mode(), exact_f32():
        p, s = eng._step(model, w_s2d, *seg)
        logits = fused_logits(model, w_s2d, *seg)
        want_logits = cpu_model(render_images(*seg, dtype=torch.float32))
    want_p, want_s = eng.predict_specs(_specs(case))
    assert torch.equal(p, logits.argmax(dim=1))
    np.testing.assert_array_equal(p.numpy(), want_p)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=0, atol=1e-5)
    scale = want_logits.abs().max()
    assert (logits - want_logits).abs().max() <= 1e-4 * scale
