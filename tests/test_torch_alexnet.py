"""The port's AlexNet against the JAX package's: the parameter layout
round trip, f32 forward (logits within 1e-4, same argmax) on the batch
fixture of tests/test_alexnet.py, the folded s2d forward, the bit-equal
bf16 fold, and TF-semantics LRN within 1e-6."""
import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch
import torch.nn.functional as F

from svision_tpu.models import alexnet as ja
from svision_tpu_torch.models import alexnet as ta
from svision_tpu_torch.ops.fused_pool_lrn import bias_relu_pool_lrn

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


# ---------------------------------------------------------------------------
# The grouped layers run split in bf16 (AlexNet.split_groups, conv_halves)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    """The unfolded network from one set of seeded weights, in f32 and in
    bf16 (cast_params_bf16), on the CPU."""
    params = ta.init_params(3)
    return {torch.float32: ta.AlexNet.from_params(params, device="cpu"),
            torch.bfloat16: ta.AlexNet.from_params(
                ta.cast_params_bf16(params), device="cpu")}


def _grouped_forward_conv1(model, pre):
    """forward_conv1 as the network ran it with every grouped layer in one
    grouped F.conv2d call: the reference of the split route."""
    def conv(layer, h, bias=True):
        return F.conv2d(h, layer.weight, layer.bias if bias else None,
                        layer.stride, layer.padding, 1, layer.groups)
    h = bias_relu_pool_lrn(pre, model.conv1.bias)
    h = conv(model.conv2, h.permute(0, 3, 1, 2), bias=False)
    h = bias_relu_pool_lrn(h.permute(0, 2, 3, 1), model.conv2.bias)
    h = h.permute(0, 3, 1, 2)
    h = torch.relu(conv(model.conv3, h))
    h = torch.relu(conv(model.conv4, h))
    h = F.max_pool2d(torch.relu(conv(model.conv5, h)), 3, 2)
    return model._head(h)


def _pre(n, dtype, seed=0):
    """conv1's pre-activation NHWC [n,55,55,96], as K3 emits it."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 55, 55, 96), generator=g).mul(4).to(dtype)


def test_split_groups_follows_the_compute_dtype(nets):
    assert nets[torch.bfloat16].split_groups == 3
    assert nets[torch.float32].split_groups == 0


# layer -> (input channels, side) at the network's real shapes
_GROUPED_INPUTS = {"conv2": (96, 27), "conv4": (384, 13), "conv5": (384, 13)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(_GROUPED_INPUTS))
def test_conv_halves_equal_the_grouped_call(nets, name, dtype):
    """conv_halves on a grouped layer's two input halves, joined, against
    the layer's grouped F.conv2d on the whole input (conv2 without its
    bias, as the network calls it): within 1e-5 of the largest output in
    f32; in bf16, where each output is rounded to bf16 from an f32 sum of
    the same terms in another order, within one bf16 step (2^-7 of the
    value) plus 2^-14 of the largest output for the sums' order."""
    layer = getattr(nets[dtype], name)
    c, side = _GROUPED_INPUTS[name]
    g = torch.Generator().manual_seed(c + side)
    x = (torch.rand((2, c, side, side), generator=g).to(dtype)
         .contiguous(memory_format=torch.channels_last))
    bias = name != "conv2"
    want = F.conv2d(x, layer.weight, layer.bias if bias else None,
                    layer.stride, layer.padding, 1, 2).float()
    halves = ta.conv_halves(layer, x.chunk(2, dim=1), bias=bias)
    assert [tuple(h.shape) for h in halves] == [
        (2, layer.out_channels // 2, side, side)] * 2
    got = torch.cat(halves, dim=1).float()
    scale = want.abs().max()
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 1e-5 * scale
    else:
        assert ((got - want).abs()
                <= 2 ** -7 * want.abs() + 2 ** -14 * scale).all()


def test_f32_network_is_the_grouped_call(nets):
    """The f32 network keeps one grouped call a grouped layer: its logits
    are bit-equal to the grouped reference's, so the exact route is the
    one it was."""
    model = nets[torch.float32]
    pre = _pre(2, torch.float32)
    assert torch.equal(model.forward_conv1(pre),
                       _grouped_forward_conv1(model, pre))


def test_bf16_split_network_agrees_with_the_grouped_call(nets):
    """The bf16 network with its groups split against the same weights'
    grouped bf16 calls: the same sums in another order, so logits within
    bf16 rounding of each other and the same argmax."""
    model = nets[torch.bfloat16]
    pre = _pre(4, torch.bfloat16, seed=1)
    got, want = model.forward_conv1(pre), _grouped_forward_conv1(model, pre)
    assert got.dtype == want.dtype == torch.float32
    assert (got - want).abs().max() <= 2 ** -6 * want.abs().max()
    assert torch.equal(got.argmax(1), want.argmax(1))


def test_conv1_block_hands_halves_on_the_split_route_only(nets):
    """AlexNet.stages()'s conv1 block: on the split route (bf16) K2's two
    contiguous NHWC halves [N,27,27,48], the whole block's channels split
    at 48 bit for bit; in f32 the whole block, one [N,27,27,96] tensor."""
    for dtype, model in nets.items():
        pre = _pre(2, dtype, seed=3)
        got = model.stages()[0](pre)
        want = bias_relu_pool_lrn(pre, model.conv1.bias)
        if dtype == torch.float32:
            assert isinstance(got, torch.Tensor) and torch.equal(got, want)
            continue
        assert isinstance(got, tuple) and len(got) == 2
        assert all(t.is_contiguous() and tuple(t.shape) == (2, 27, 27, 48)
                   for t in got)
        assert torch.equal(torch.cat(got, dim=-1), want)


def test_split_route_equals_the_joined_route(nets):
    """The bf16 network, whose K2 writes conv2's input halves and reads
    its output halves, against the route that joined them: K2 whole,
    conv2's inputs as channel views of its output, conv2's halves joined
    for K2. The same values reach every op, so logits bit for bit."""
    model = nets[torch.bfloat16]
    pre = _pre(3, torch.bfloat16, seed=4)
    h = bias_relu_pool_lrn(pre, model.conv1.bias).permute(0, 3, 1, 2)
    h = torch.cat(ta.conv_halves(model.conv2, h.chunk(2, dim=1), bias=False),
                  dim=1)
    h = bias_relu_pool_lrn(h.permute(0, 2, 3, 1), model.conv2.bias)
    h = h.permute(0, 3, 1, 2)
    for stage in model.stages()[2:]:
        h = stage(h)
    assert torch.equal(model.forward_conv1(pre), h)


# forward_conv1(n_stages=k)'s output shapes [N=2]; conv3 and conv4 hand on
# a tuple of channel blocks (two halves in bf16, one block in f32), and in
# bf16 conv1's block K2's two NHWC halves
_STAGE_SHAPES = {0: (2, 55, 55, 96), 1: (2, 27, 27, 96), 2: (2, 256, 13, 13),
                 5: (2, 256, 6, 6), 6: (2, 5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", range(len(ta.AlexNet.STAGE_LAYERS) + 1))
def test_forward_conv1_runs_every_prefix(nets, k, dtype):
    """forward_conv1(n_stages=k) for every k, as scripts/torch_roofline.py
    times the prefixes: each runs and gives its stage's output, and the
    stages taken one by one from it reach the whole network's logits."""
    model = nets[dtype]
    pre = _pre(2, dtype, seed=2)
    h = model.forward_conv1(pre, n_stages=k)
    if k == 1 and model.split_groups:
        assert isinstance(h, tuple) and len(h) == 2
        assert all(tuple(b.shape) == (2, 27, 27, 48) for b in h)
    elif k in (3, 4):
        blocks = 2 if model.split_groups else 1
        assert isinstance(h, tuple) and len(h) == blocks
        assert all(tuple(b.shape) == (2, 384 // blocks, 13, 13) for b in h)
    else:
        assert tuple(h.shape) == _STAGE_SHAPES[k]
    for stage in model.stages()[k:]:
        h = stage(h)
    assert torch.equal(h, model.forward_conv1(pre))
