"""The gradient of K2's function in the port against the JAX trainer's.

The JAX package has no backward kernel for K2: its trainer differentiates
the composition relu(x + b) -> alexnet._maxpool -> alexnet.lrn
(svision_tpu/models/train.py:44-47) through XLA. The port's trainers run
the same function through fused_pool_lrn.BiasReluPoolLRN, whose backward
on the card is a hand-written kernel held to bias_relu_pool_lrn_backward_plain
there (tests/test_torch_kernels_gpu.py); here that plain version is held to
jax.vjp of the JAX composition, at H/W 11 and 13, C 96 and 256, N 2-4:
f32 within 1e-5 and bf16 within 2e-2 of the largest entry (bf16 on the
sixteenths grid, where both packages route alike, and on random inputs,
where the JAX trainer's bf16 arithmetic reroutes some windows). Max-pool ties
must send the gradient where JAX sends it, the first maximum in row-major
window order: a planted-tie case holds the set of positions that receive a
gradient to JAX's exactly. The Function passes gradcheck in float64 and
equals autograd through the composition of torch ops that the trainers
ran before it (_composition below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from svision_tpu.models import alexnet as ja
from svision_tpu_torch.models import alexnet as ta
from svision_tpu_torch.models import train as tt
from svision_tpu_torch.ops import fused_pool_lrn as T

torch.set_num_threads(2)

SHAPES = [(2, 11, 11, 96), (3, 13, 13, 256), (4, 13, 11, 96), (2, 11, 13, 256)]


def _jax_vjp(x, b, dy, dtype):
    """(dx, db) of the JAX trainer's relu -> _maxpool -> lrn, in dtype."""
    def f(x, b):
        return ja.lrn(ja._maxpool(jax.nn.relu(x + b)))
    _, vjp = jax.vjp(f, jnp.asarray(x, dtype), jnp.asarray(b, dtype))
    dx, db = vjp(jnp.asarray(dy, dtype))
    return np.asarray(dx, np.float32), np.asarray(db, np.float32)


def _plain(x, b, dy, dtype):
    dx, db = T.bias_relu_pool_lrn_backward_plain(
        *(torch.from_numpy(a).to(dtype) for a in (x, b, dy)))
    assert dx.dtype == dtype and db.dtype == dtype
    return dx.float().numpy(), db.float().numpy()


def _close(got, want, rel, what):
    """max |got - want| <= rel * max |want|."""
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _out_shape(n, h, w, c):
    return n, (h - 3) // 2 + 1, (w - 3) // 2 + 1, c


def _random(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    dy = rng.randn(*_out_shape(*shape)).astype(np.float32)
    return x, b, dy


def _grid(shape, seed):
    """x and b on a grid of sixteenths with |x + b| <= 4: every sum is exact
    in bf16, so the JAX trainer's bf16 add (the port adds in f32, as K2
    does) sees the same maxima, ties included."""
    rng = np.random.RandomState(seed)
    x = (rng.randint(-48, 49, shape) / 16).astype(np.float32)
    b = (rng.randint(-16, 17, shape[-1]) / 16).astype(np.float32)
    dy = rng.randn(*_out_shape(*shape)).astype(np.float32)
    return x, b, dy


def _planted_ties(shape, seed):
    """Random inputs with blank regions (one constant value, all nine taps
    tied), a patch repeated along the rows and columns, and windows whose
    raw maximum rounds to the same x + b as an earlier tap (b = 1024, the
    f32 spacing there 2^-13)."""
    x, b, dy = _random(shape, seed)
    n, h, w, c = shape
    x[:, : h // 2, : w // 2] = 0.75
    x[:, h // 2:, : 4] = np.tile(x[:, h // 2:, 4:6], (1, 1, 2, 1))
    b[: c // 2] = 1024.0
    # in a window at (0, 6): tap 0 raw 0.5, tap 4 raw 0.5 + 2^-20, the
    # rest below; x + b rounds both to 1024.5
    x[:, 0:3, 6:9, : c // 2] = -1.0
    x[:, 0, 6, : c // 2] = 0.5
    x[:, 1, 7, : c // 2] = 0.5 + 2.0 ** -20
    return x, b, dy


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_f32(shape):
    x, b, dy = _random(shape, seed=sum(shape))
    want_dx, want_db = _jax_vjp(x, b, dy, jnp.float32)
    got_dx, got_db = _plain(x, b, dy, torch.float32)
    _close(got_dx, want_dx, 1e-5, "dx")
    _close(got_db, want_db, 1e-5, "db")


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_bf16(shape):
    """dx against JAX's bf16 vjp. db against JAX's bf16 dx summed in f32:
    JAX's own bf16 db sums in bf16 and departs from an f64 sum of the same
    gradient by 1.0-2.2% of its largest entry on these shapes, while the
    port sums in f32 and rounds once."""
    x, b, dy = _grid(shape, seed=sum(shape))
    want_dx, _ = _jax_vjp(x, b, dy, jnp.bfloat16)
    got_dx, got_db = _plain(x, b, dy, torch.bfloat16)
    _close(got_dx, want_dx, 2e-2, "dx")
    _close(got_db, want_dx.sum((0, 1, 2)), 2e-2, "db")


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_bf16_random_against_jax(shape):
    """bf16 on random inputs, off the sixteenths grid. The port adds,
    pools and normalizes in f32 and rounds once; the JAX trainer does each
    step in bf16, and its bf16 add rounds distinct x + b to one value, so
    some of its windows send their gradient to another tap. Held: the
    port's dx and db within 2e-2 of the largest entry of jax.vjp in f32 at
    the same bf16-rounded inputs, and no further from it than JAX's own
    bf16 vjp, by the largest error and the L2 norm. Against JAX's bf16
    vjp directly (readings on these shapes: dx 0.032-0.063 in L2 relative
    to its norm, up to 0.39 of its largest entry at a few rerouted
    positions; db 0.012-0.026 of its largest entry): dx within 0.1 in L2,
    db within 3e-2."""
    x, b, dy = _random(shape, seed=sum(shape))
    xr, br, dyr = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (x, b, dy))
    ref = _jax_vjp(xr, br, dyr, jnp.float32)
    theirs = _jax_vjp(x, b, dy, jnp.bfloat16)
    got = _plain(x, b, dy, torch.bfloat16)
    for g, t, r, what in zip(got, theirs, ref, ("dx", "db")):
        _close(g, r, 2e-2, what)
        assert np.abs(g - r).max() <= np.abs(t - r).max(), what
        assert np.linalg.norm(g - r) <= np.linalg.norm(t - r), what
    assert (np.linalg.norm(got[0] - theirs[0])
            <= 0.1 * np.linalg.norm(theirs[0]))
    _close(got[1], theirs[1], 3e-2, "db against JAX's bf16 db")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_planted_ties_route_as_jax(dtype):
    """The positions that receive a gradient equal JAX's exactly, and the
    values agree at the dtype's bar. bf16 takes the tie patterns on the
    sixteenths grid (the rounding tie is an f32 case)."""
    shape = (2, 13, 13, 96)
    if dtype == "f32":
        x, b, dy = _planted_ties(shape, seed=7)
        jdt, tdt, rel = jnp.float32, torch.float32, 1e-5
    else:
        x, b, dy = _grid(shape, seed=7)
        x[:, :6, :6] = 0.75
        x[:, 6:, :4] = np.tile(x[:, 6:, 4:6], (1, 1, 2, 1))
        jdt, tdt, rel = jnp.bfloat16, torch.bfloat16, 2e-2
    want_dx, want_db = _jax_vjp(x, b, dy, jdt)
    got_dx, got_db = _plain(x, b, dy, tdt)
    np.testing.assert_array_equal(got_dx != 0, want_dx != 0)
    _close(got_dx, want_dx, rel, "dx")
    # JAX's bf16 db sums in bf16 (test_plain_backward_matches_jax_bf16)
    _close(got_db, want_db if dtype == "f32" else want_dx.sum((0, 1, 2)),
           rel, "db")
    # the blank windows send everything to their first tap: nothing to an
    # odd row or column of the blank corner
    assert (got_dx[:, 1:6:2, :6] == 0).all() and (got_dx[:, :6, 1:6:2] == 0).all()
    assert (got_dx[:, 0:6:2, 0:6:2] != 0).any()
    if dtype == "f32":
        # the rounding tie: the earlier tap, not the larger raw x
        assert (got_dx[:, 0, 6, :48] != 0).all()
        assert (got_dx[:, 1, 7, :48] == 0).all()


def _composition(h, b):
    """The trainers' bias/ReLU/pool/LRN before BiasReluPoolLRN, in
    differentiable torch ops on NHWC h, in h's dtype."""
    p = F.max_pool2d(torch.relu(h.permute(0, 3, 1, 2) + b[:, None, None]),
                     3, 2)
    return T.lrn(p.permute(0, 2, 3, 1))


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_function_matches_the_composition(dtype, rel):
    """Output and gradients of the Function against autograd through
    _composition, on the planted ties (the grid's for bf16, whose
    composition adds, pools and normalizes in bf16), and in f32 and f64
    the same positions receiving a gradient."""
    shape = (3, 13, 11, 96)
    x, b, dy = (_grid if dtype == torch.bfloat16 else _planted_ties)(shape, 3)
    res = []
    for fn in (T.BiasReluPoolLRN.apply, _composition):
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        bt = torch.from_numpy(b).to(dtype).requires_grad_()
        out = fn(xt, bt)
        out.backward(torch.from_numpy(dy).to(dtype))
        assert out.dtype == dtype and xt.grad.dtype == dtype
        res.append([t.detach().double().numpy()
                    for t in (out, xt.grad, bt.grad)])
    for got, want, what in zip(*res, ("out", "dx", "db")):
        _close(got, want, rel, what)
    if dtype != torch.bfloat16:
        # (in bf16 the composition's sums of a window's taps can cancel
        # to 0 where the f32 sum does not)
        np.testing.assert_array_equal(res[0][1] != 0, res[1][1] != 0)


def test_function_gradcheck_f64():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 9, 8, 6) * 2).requires_grad_()
    b = torch.from_numpy(rng.randn(6)).requires_grad_()
    assert torch.autograd.gradcheck(T.BiasReluPoolLRN.apply, (x, b))


def test_plain_forward_computes_f64_in_f64():
    """f64 input is computed in f64 (the f32 step is held to its own f64
    run), f32 and bf16 as before, in f32."""
    x, b, _ = _planted_ties((2, 11, 11, 96), seed=2)
    x64, b64 = torch.from_numpy(x).double(), torch.from_numpy(b).double()
    got = T.bias_relu_pool_lrn_plain(x64, b64)
    assert got.dtype == torch.float64
    _close(got.numpy(), _composition(x64, b64).numpy(), 1e-14, "f64")
    f32 = T.bias_relu_pool_lrn_plain(x64.float(), b64.float()).double()
    assert not torch.equal(got, f32)
    _close(f32.numpy(), got.numpy(), 1e-6, "f32")


def test_backward_wrapper_cpu_path():
    """A CPU tensor takes the plain version and counts no launch; the
    wrapper refuses wrong shapes and dtypes on every device, a tensor
    that is neither on the CPU nor on CUDA, and inputs that require grad
    while grad mode is on."""
    x, b, dy = (torch.from_numpy(a) for a in _random((2, 11, 11, 8), 1))
    before = T.bias_relu_pool_lrn_backward.launches
    dx, db = T.bias_relu_pool_lrn_backward(x, b, dy)
    assert T.bias_relu_pool_lrn_backward.launches == before
    want = T.bias_relu_pool_lrn_backward_plain(x, b, dy)
    assert torch.equal(dx, want[0]) and torch.equal(db, want[1])
    bad = [(x, b[:7], dy), (x, b, dy[:, :4]), (x, b, dy.double()),
           (x[0], b, dy), (x[:, :2], b, dy[:, :0])]
    for args in bad:
        with pytest.raises(ValueError):
            T.bias_relu_pool_lrn_backward(*args)
    with pytest.raises(ValueError):
        T.bias_relu_pool_lrn_backward(*(t.to("meta") for t in (x, b, dy)))
    with pytest.raises(ValueError, match="requires grad"):
        T.bias_relu_pool_lrn_backward(x.clone().requires_grad_(), b, dy)
    with torch.no_grad():
        T.bias_relu_pool_lrn_backward(x.clone().requires_grad_(), b, dy)


def test_inference_wrapper_stays_not_differentiable():
    """The Function is the only door a gradient takes through K2."""
    x = torch.ones((1, 5, 5, 8), requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        T.bias_relu_pool_lrn(x, torch.zeros(8))
    out = T.BiasReluPoolLRN.apply(x, torch.zeros(8))
    assert out.grad_fn is not None and out.shape == (1, 2, 2, 8)


def _nodes(loss):
    """Names of every node of loss's autograd graph."""
    seen, todo, names = set(), [loss.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(node.name())
        todo.extend(f for f, _ in node.next_functions)
    return names


@pytest.mark.parametrize("s2d", [False, True])
def test_training_forward_goes_through_the_function(s2d):
    """Both training forwards pass the conv1 and conv2 tails through
    BiasReluPoolLRN, and the graph holds no max-pool but conv5's."""
    params = ta.init_params(0)
    model = ta.AlexNet.trainable(params, device="cpu")
    p = dict(model.named_parameters())
    rng = np.random.RandomState(0)
    shape = (2, 57, 57, 48) if s2d else (2, 227, 227, 3)
    x = torch.from_numpy((rng.rand(*shape) < 0.1).astype(np.float32))
    loss = tt.loss_fn(p, x, torch.tensor([0, 3]), torch.Generator(), 1.0,
                      s2d=s2d)
    names = _nodes(loss)
    assert sum("BiasReluPoolLRN" in k for k in names) == 2, names
    assert sum("MaxPool2D" in k for k in names) == 1, names
    loss.backward()
    assert all(torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
               for t in p.values())
