"""The port engine's other modes on the CPU: raster= ('s2d', 'compare',
'einsum', 'pallas'), int8= and fast=, against the JAX engine in the same
mode, and against each other.

The weights are the numpy He-init ones at half scale with small random
biases: their decisions vary from spec to spec (unlike the JAX package's
init_params(PRNGKey(0)), whose softmax is 1.0 for every spec) without
letting bf16 rounding flip many of them (at full scale bf16 decides a
tenth of the specs differently in the two packages). Against the JAX
engine in the same mode, on 64 specs: argmax agreement >= 0.9, the
selected softmax within 0.02, and its median difference within 0.004
(measured: 0.984 / 0.0021 / 0.00064 in bf16, 0.953 / 0.0056 / 0.0015 in
int8; the same engine fed the specs in reverse order is 0.0089 away in the
median). Within the port the four kinds are the same bits, the outputs
do not depend on the plan, and the int8 engine on two CPU replicas equals
it on one, bit for bit."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bench import random_specs
from svision_tpu.infer.engine import InferenceEngine as JaxEngine
from svision_tpu_torch.infer.engine import InferenceEngine
from svision_tpu_torch.models.alexnet import init_params
from svision_tpu_torch.parallel import mesh as M

torch.set_num_threads(2)

# port engine arguments of each mode; the JAX engine gets the same ones
MODES = {
    "bf16-s2d": dict(raster="s2d"),
    "bf16-compare": dict(raster="compare"),
    "bf16-einsum": dict(raster="einsum"),
    "bf16-pallas": dict(raster="pallas"),
    "int8-s2d": dict(int8=True),
    "int8-einsum": dict(int8=True, raster="einsum"),
    "int8-pallas": dict(int8=True, raster="pallas"),
    "unfolded-bf16": dict(fast=False),
}
# JAX's four rasters are the same bits (tests/test_rasterize.py), and its
# int8 engine compiles for about 10 s: the int8 kinds share one JAX run
JAX_RUN = {"int8-einsum": "int8-s2d", "int8-pallas": "int8-s2d"}


@pytest.fixture(scope="module")
def params():
    rng = np.random.RandomState(0)
    return {k: (v * np.float32(0.5) if k.endswith("weights")
                else v + rng.normal(0, 0.05, v.shape).astype(np.float32))
            for k, v in init_params(0).items()}


@pytest.fixture(scope="module")
def specs():
    return random_specs(64, seed=0)


@pytest.fixture(scope="module")
def outputs(params, specs):
    """mode -> (port (argmax, softmax), JAX (argmax, softmax)), computed at
    first need."""
    port, jax_out = {}, {}

    def get(mode):
        if mode not in port:
            port[mode] = InferenceEngine(params, batch_size=16, device="cpu",
                                         **MODES[mode]).predict_specs(specs)
        jmode = JAX_RUN.get(mode, mode)
        if jmode not in jax_out:
            jax_out[jmode] = JaxEngine(params, batch_size=16, chunk=2,
                                       tail="pow2",
                                       **MODES[jmode]).predict_specs(specs)
        return port[mode], jax_out[jmode]
    return get


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_jax(outputs, mode):
    (p, s), (want_p, want_s) = outputs(mode)
    assert p.dtype == np.int64 and s.dtype == np.float32
    assert (p == want_p).mean() >= 0.9
    d = np.abs(s - want_s)
    assert d.max() <= 0.02 and np.median(d) <= 0.004


@pytest.mark.parametrize("kinds", [
    ("bf16-s2d", "bf16-compare", "bf16-einsum", "bf16-pallas"),
    ("int8-s2d", "int8-einsum", "int8-pallas")])
def test_kinds_are_the_same_bits(outputs, kinds):
    first = outputs(kinds[0])[0]
    for kind in kinds[1:]:
        p, s = outputs(kind)[0]
        np.testing.assert_array_equal(p, first[0], err_msg=kind)
        np.testing.assert_array_equal(s, first[1], err_msg=kind)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("raster", ["s2d", "compare", "pallas"])
def test_mode_rules_match_jax(params, bf16, fast, int8, raster):
    """int8 needs bf16 and fast, fast needs bf16, and int8 turns 's2d'
    into 'compare', visibly: the JAX engine's rules, attribute for
    attribute."""
    kw = dict(bf16=bf16, fast=fast, int8=int8, raster=raster)
    want = JaxEngine(params, batch_size=16, **kw)
    got = InferenceEngine(params, batch_size=16, device="cpu", **kw)
    dtypes = {jnp.int8: torch.int8, jnp.bfloat16: torch.bfloat16,
              jnp.float32: torch.float32}
    assert (got.int8, got.fast, got.raster) == (want.int8, want.fast,
                                                want.raster)
    assert got.compute_dtype == dtypes[want.compute_dtype]


def test_unknown_raster_raises(params):
    with pytest.raises(ValueError, match="raster"):
        InferenceEngine(params, batch_size=16, device="cpu", raster="conv")


@pytest.mark.parametrize("mode", ["int8-pallas", "bf16-einsum"])
def test_outputs_do_not_depend_on_plan(params, mode):
    """83 specs at batch 4 under four plans (tests/test_torch_engine.py's):
    the same outputs, bit for bit. An int8 activation scale is taken per
    batch, and the batches are the same rows in every plan."""
    specs = random_specs(83, seed=1)
    got = [InferenceEngine(params, batch_size=4, chunk=chunk, tail=tail,
                           device="cpu", **MODES[mode]).predict_specs(specs)
           for chunk, tail in ((1, "full"), (2, "full"), (4, "pow2"),
                               (32, "full"))]
    for p, s in got[1:]:
        np.testing.assert_array_equal(p, got[0][0])
        np.testing.assert_array_equal(s, got[0][1])


@pytest.mark.parametrize("mode", ["int8", "bf16", "f32"])
def test_int8_does_not_depend_on_replicas(params, mode):
    """Each replica takes whole batches in every mode, so two CPU replicas
    give one replica's output bit for bit, at 40 specs (an odd number of
    batches of 16: the second replica's last batch is all padding). An
    int8 activation's scale is the max over its batch; the bf16 and f32
    networks see the same batch shape and rows on either engine."""
    specs = random_specs(40, seed=0)
    kw = {"int8": dict(int8=True), "bf16": {}, "f32": dict(bf16=False)}[mode]
    one = InferenceEngine(params, batch_size=16, device="cpu", **kw)
    two = InferenceEngine(params, batch_size=16, devices=("cpu", "cpu"),
                          **kw)
    assert one.batch_size == 16 and two.batch_size == 32
    for a, b in zip(one.predict_specs(specs), two.predict_specs(specs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fast,chunk", [(True, 8), (False, 3)])
def test_sharded_inference_passes_fast_and_chunk(params, fast, chunk):
    """ShardedInference takes the JAX signature (fast=True, chunk=8) and
    hands both to the engine; the default arguments are the JAX ones. Its
    output is the one-device engine's within test_torch_parallel.py's
    rule."""
    mesh = M.make_mesh(2, "cpu")
    kw = {} if fast else dict(fast=fast, chunk=chunk)
    eng = M.ShardedInference(params, mesh, batch_size=16, **kw)
    assert (eng.fast, eng.chunk, eng.devices) == (fast, chunk, tuple(mesh))
    specs = random_specs(40, seed=2)
    want = InferenceEngine(params, batch_size=16, fast=fast, chunk=chunk,
                           device="cpu").predict_specs(specs)
    p, s = eng.predict_specs(specs)
    np.testing.assert_array_equal(p, want[0])
    np.testing.assert_allclose(s, want[1], rtol=0, atol=1e-5)
