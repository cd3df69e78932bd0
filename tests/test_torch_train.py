"""The port's training against the JAX package's, on the CPU, at full
width and small batches: the training forward and its 16 gradients, two
SGD steps, the fit history, the labeled dataset, the conv1 fold, the
device augmentations, fit_device's two paths, the DP x TP step and the
trainer's CLI round trip. Weights are the JAX package's
init_params(PRNGKey(0)), carried across as numpy; inputs are rasters of
labeled specs (their blank regions tie in max-pool, which random noise
never does). keep_prob is 1: jax.random streams cannot be reproduced in
torch."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from svision_tpu.models import alexnet as ja
from svision_tpu.models import train as jt
from svision_tpu.ops import rasterize as jr
from svision_tpu_torch.models import alexnet as ta
from svision_tpu_torch.models import train as tt
from svision_tpu_torch.ops import rasterize as tr
from tests.test_training import _labeled_specs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return {k: np.asarray(v)
            for k, v in ja.init_params(jax.random.PRNGKey(0)).items()}


@pytest.fixture(scope="module")
def batch():
    specs, labels = _labeled_specs(8, seed=5)
    ep, vis, rev = jr.specs_to_endpoints(specs)
    seg = [jnp.asarray(a) for a in (ep, vis, rev)]
    images = np.asarray(jr.render_images_jit(*seg))
    raster = np.asarray(jr.render_raster_s2d(*seg, dtype=jnp.float32))
    return dict(specs=specs, labels=labels, image=images, s2d=raster)


def _cpu_gen():
    return torch.Generator().manual_seed(0)


def _close(got, want, rel, what):
    """max |got - want| <= rel * max |want| (per tensor)."""
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _params_close(got, want, start, upd):
    """Each trained parameter within 1e-4 of its largest value plus upd of
    its largest update (a zero-initialised bias is nothing but its
    update)."""
    for k in want:
        w = np.asarray(want[k])
        tol = (1e-4 * float(np.abs(w).max())
               + upd * float(np.abs(w - start[k]).max()))
        err = float(np.abs(got[k] - w).max())
        assert err <= tol, f"{k}: {err} > {tol}"


@pytest.mark.parametrize("path", ["image", "s2d"])
def test_forward_and_grads_match_jax(params, batch, path):
    s2d = path == "s2d"
    x, labels = batch[path], batch["labels"]
    rng = jax.random.PRNGKey(3)
    jfwd = jt.forward_train_s2d if s2d else jt.forward_train
    want_logits = np.asarray(jax.jit(
        lambda p, x: jfwd(p, x, rng, keep_prob=1.0))(params, jnp.asarray(x)))
    jgrad = jax.jit(jax.grad(lambda p, x: jt.loss_fn(
        p, x, jnp.asarray(labels), rng, 1.0, s2d=s2d)))(params, jnp.asarray(x))

    model = ta.AlexNet.trainable(params, device="cpu")
    p = dict(model.named_parameters())
    tfwd = tt.forward_train_s2d if s2d else tt.forward_train
    with tt.training_precision(torch.float32):
        logits = tfwd(p, torch.from_numpy(x), _cpu_gen(), keep_prob=1.0)
        tt.loss_fn(p, torch.from_numpy(x), torch.from_numpy(labels),
                   _cpu_gen(), 1.0, s2d=s2d).backward()
    got = logits.detach().numpy()
    assert got.dtype == np.float32 and got.shape == (8, 5)
    err = np.abs(got - want_logits).max()
    assert err <= 1e-4 * max(1.0, np.abs(want_logits).max()), err
    grads = ta.params_to_numpy({k: v.grad for k, v in p.items()})
    assert grads.keys() == params.keys() and len(grads) == 16
    for k in params:
        _close(grads[k], np.asarray(jgrad[k]), 1e-3, f"grad {k}")


@pytest.mark.parametrize("clip", [None, 1.0])
def test_two_train_steps_match_jax(params, batch, clip):
    """Two SGD steps (momentum 0.9, lr 1e-3; optax's global-norm clip
    first when clip is set) against the JAX package's make_train_step.
    The port's f32 steps stay within 1e-4 of the update of its own f64
    steps; the JAX package's f32 steps drift from them by up to 2.6e-3 of
    the update (conv4's bias, without the clip: its CPU convolutions'
    rounding), so the port is held to JAX within 3e-3 of the update."""
    x = jnp.asarray(batch["image"])
    y = jnp.asarray(batch["labels"])
    sgd = optax.sgd(1e-3, momentum=0.9)
    opt = sgd if clip is None else optax.chain(optax.clip_by_global_norm(clip),
                                               sgd)
    init, jstep = jt.make_train_step(opt, keep_prob=1.0)
    jstep = jax.jit(jstep)
    p1, o1, _ = jstep(params, init(params), x, y, jax.random.PRNGKey(1))
    p2, _, _ = jstep(p1, o1, x, y, jax.random.PRNGKey(2))

    got = {}
    for dtype in (torch.float32, torch.float64):
        model = ta.AlexNet.trainable(params, device="cpu").to(dtype)
        _, step = tt.make_train_step(model, learning_rate=1e-3,
                                     clip_norm=clip, keep_prob=1.0,
                                     compute_dtype=dtype)
        images = torch.from_numpy(batch["image"]).to(dtype)
        labels = torch.from_numpy(batch["labels"])
        losses = [step(images, labels, _cpu_gen()) for _ in range(2)]
        assert all(torch.isfinite(l) for l in losses)
        got[dtype] = ta.params_to_numpy(
            {k: v.double() for k, v in model.named_parameters()})
    _params_close(got[torch.float32], got[torch.float64], params, 1e-4)
    _params_close(got[torch.float32], p2, params, 3e-3)
    # the caller's arrays are copied, never updated in place
    assert np.array_equal(params["conv3/biases"], np.zeros(384, np.float32))


def test_fit_history_matches_jax(params):
    specs, labels = _labeled_specs(16, seed=2)
    kw = dict(epochs=1, batch_size=8, seed=4, learning_rate=1e-3,
              keep_prob=1.0, augment=True)
    _, want = jt.fit(params, specs, labels, **kw)
    got_params, got = tt.fit(params, specs, labels, device="cpu", **kw)
    assert len(got) == 1 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got_params.keys() == params.keys()


def test_build_dataset_matches_jax():
    from svision_tpu.models.dataset import build_dataset as jax_build
    from svision_tpu_torch.models.dataset import build_dataset
    want_specs, want_labels, want_events = jax_build(n_per_type=4)
    specs, labels, events = build_dataset(n_per_type=4)
    assert len(labels) > 0
    assert events == want_events
    np.testing.assert_array_equal(specs, want_specs)
    np.testing.assert_array_equal(labels, want_labels)


def test_fold_in_torch_and_numpy(params):
    """The one fold implementation gives bit-equal weights on numpy and on
    torch, and a bias that differs only by the 363-term contraction's
    summation order; the torch fold carries gradients back to the
    reference-space weights."""
    w, b = params["conv1/weights"], params["conv1/biases"] + 0.5
    want_w, want_b = ta.fold_conv1_math(w, b)
    tw = torch.from_numpy(w).requires_grad_(True)
    got_w, got_b = ta.fold_conv1_math(tw, torch.from_numpy(b))
    assert got_w.shape == (3, 3, 48, 96) and want_w.shape == (3, 3, 48, 96)
    np.testing.assert_array_equal(got_w.detach().numpy(), want_w)
    np.testing.assert_allclose(got_b.detach().numpy(), want_b,
                               rtol=0, atol=1e-6 * np.abs(want_b).max())
    (got_w.sum() + got_b.sum()).backward()
    # d/dw of (255 w summed) - (w . mean summed)
    want_g = 255.0 - np.array(ta.IMAGE_MEAN, np.float32)[None, None, :, None]
    np.testing.assert_allclose(tw.grad.numpy(),
                               np.broadcast_to(want_g, w.shape), rtol=1e-6)


def test_s2d_grad_matches_image_path(params, batch):
    """Within the port: the s2d forward (in-graph fold) against the image
    forward, logits and conv1's gradient, as tests/test_training.py holds
    the JAX package's two paths."""
    model = ta.AlexNet.trainable(params, device="cpu")
    p = dict(model.named_parameters())
    out, grads = {}, {}
    with tt.training_precision(torch.float32):
        for path, fwd in (("image", tt.forward_train),
                          ("s2d", tt.forward_train_s2d)):
            logits = fwd(p, torch.from_numpy(batch[path]), _cpu_gen(),
                         keep_prob=1.0)
            ((logits - 1.0) ** 2).mean().backward()
            out[path] = logits.detach().numpy()
            grads[path] = p["conv1.weight"].grad.numpy().copy()
            model.zero_grad(set_to_none=True)
    assert np.abs(out["image"] - out["s2d"]).max() <= 2e-3
    _close(grads["s2d"], grads["image"], 5e-3, "conv1 grad")


def test_jitter_endpoints_torch_stays_on_canvas():
    specs, _ = _labeled_specs(8, seed=3)
    ep, vis, rev = tr.specs_to_endpoints(specs)
    out_np = tt.jitter_endpoints_np(ep, np.random.RandomState(0))
    out_t = tt.jitter_endpoints_torch(torch.from_numpy(ep), _cpu_gen())
    assert out_t.dtype == torch.int32
    for out in (out_np, out_t.numpy()):
        assert out.shape == ep.shape and out.dtype == ep.dtype
        assert out.min() >= 0 and out.max() <= tr.CANVAS - 1
        # translation <= 10 plus jitter <= 2
        assert np.abs(out.astype(int) - ep.astype(int)).max() <= 12
    # one (dc, dr) shift per image: every endpoint of an image moves by it
    # up to the jitter, away from the canvas edges
    imgs = tr.render_images(out_t, torch.from_numpy(vis),
                            torch.from_numpy(rev))
    assert imgs.shape == (8, 227, 227, 3)


def test_fragment_endpoints_torch_preserves_line_and_gap():
    ep = torch.tensor([[[10, 10, 210, 210],      # long diagonal: splittable
                        [5, 100, 9, 104]]],      # major 4 < 12: never split
                      dtype=torch.int32)
    vis = torch.ones((1, 2), dtype=torch.bool)
    rev = torch.zeros((1, 2), dtype=torch.bool)
    ep2, vis2, rev2 = tt.fragment_endpoints_torch(ep, vis, rev, _cpu_gen(),
                                                  split_prob=1.0)
    assert ep2.shape == (1, 4, 4) and vis2.shape == (1, 4)
    assert rev2.shape == (1, 4) and ep2.dtype == torch.int32
    assert bool(vis2[0, 0]) and bool(vis2[0, 1])
    assert not bool(vis2[0, 3])                # short segment: no split
    assert bool(vis2[0, 2])                    # long segment: split
    c0, r0, c1, r1 = ep2[0, 0].tolist()
    c2, r2, c3, r3 = ep2[0, 2].tolist()
    assert (c0, r0) == (10, 10) and (c3, r3) == (210, 210)
    assert c2 - c1 >= 2                        # the gap
    for c, r in [(c1, r1), (c2, r2)]:          # midpoints on the diagonal
        assert abs((r - 10) - (c - 10)) <= 1
    assert ep2[0, 1].tolist() == [5, 100, 9, 104]   # unsplit passes through


def test_fit_device_paths_agree(params):
    """Both fit_device paths train (finite losses) and follow the same
    trajectory: the fold is exact up to f32 reassociation."""
    specs, labels = _labeled_specs(16, seed=1)
    histories = []
    for s2d in (False, True):
        _, h = tt.fit_device(params, specs, labels, epochs=2, batch_size=8,
                             seed=1, learning_rate=0.01, keep_prob=1.0,
                             augment=False, s2d=s2d, device="cpu")
        histories.append(np.asarray(h))
    a, b = histories
    assert len(a) == 2 and np.isfinite(a).all() and np.isfinite(b).all()
    np.testing.assert_allclose(a, b, rtol=0.15)


def test_fit_device_noise_aug_runs(params):
    specs, labels = _labeled_specs(16, seed=2)
    out, h = tt.fit_device(params, specs, labels, epochs=1, batch_size=8,
                           seed=1, learning_rate=0.01, augment=True,
                           noise_aug=True, device="cpu")
    assert len(h) == 1 and np.isfinite(h).all()
    assert not np.array_equal(out["conv1/weights"], params["conv1/weights"])


def test_plain_raster_matches_jax_on_fragments():
    """Fragmented [N,4,4] endpoints (fit_device's noise augmentation on the
    image path): the port's plain raster, which K1 is held to on the card,
    bit-equal to JAX's render_raster, visible and invisible slots included.
    Half the images keep their lines inside a 24-pixel corner, so their row
    runs overlap in shared columns (the union of four runs)."""
    rng = np.random.RandomState(6)
    n = 16
    hi = np.where(np.arange(n) % 2 == 0, 24, tr.CANVAS)[:, None, None]
    ep = (rng.randint(0, 1 << 20, (n, 4, 4)) % hi).astype(np.int32)
    vis = rng.rand(n, 4) < 0.75
    vis[0] = False                            # nothing visible
    rev = rng.rand(n, 4) < 0.5
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jr.render_raster(jnp.asarray(ep), jnp.asarray(vis),
                                           jnp.asarray(rev), dtype=jdtype),
                          np.float32)
        got = tr.render_raster(torch.from_numpy(ep), torch.from_numpy(vis),
                               torch.from_numpy(rev), dtype=dtype)
        assert got.shape == (n, 227, 227, 3) and got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert want[..., 1].any() and want[..., 2].any()


def test_fit_device_noise_aug_image_path(params):
    """fit_device(noise_aug=True, s2d=False) renders the fragmented
    endpoints (four segments an image) on the image path and trains."""
    specs, labels = _labeled_specs(16, seed=2)
    out, h = tt.fit_device(params, specs, labels, epochs=1, batch_size=8,
                           seed=1, learning_rate=0.01, augment=True,
                           noise_aug=True, s2d=False, device="cpu")
    assert len(h) == 1 and np.isfinite(h).all()
    assert not np.array_equal(out["fc8/weights"], params["fc8/weights"])


def test_dp_tp_step_matches_one_device(params, batch):
    """A 2 x 2 CPU grid (2 data rows x 2 model columns) against the
    one-device step: the same update, and fc6/fc7 stay split."""
    from svision_tpu_torch.parallel import mesh as M
    grid = M.make_train_mesh(2, 2, device="cpu")
    cells = M.shard_params_tp(params, grid)
    assert cells[1][1]["fc6.weight"].shape == (2048, 9216)
    assert cells[0][1]["fc7.weight"].shape == (4096, 2048)
    _, mstep = tt.make_mesh_train_step(cells, learning_rate=1e-3,
                                       clip_norm=1.0, keep_prob=1.0)
    images = torch.from_numpy(batch["image"])
    labels = torch.from_numpy(batch["labels"])
    gens = {torch.device("cpu"): _cpu_gen()}
    mloss = mstep(images, labels, gens)

    model = ta.AlexNet.trainable(params, device="cpu")
    _, step = tt.make_train_step(model, learning_rate=1e-3, clip_norm=1.0,
                                 keep_prob=1.0)
    loss = step(images, labels, _cpu_gen())
    assert abs(float(mloss) - float(loss)) <= 1e-5 * abs(float(loss))
    assert cells[0][0]["fc6.weight"].shape == (2048, 9216)   # still split
    # every copy of a replicated tensor took the same update
    assert all(torch.equal(cells[0][0]["conv2.weight"], c["conv2.weight"])
               for row in cells for c in row)
    # the clipped gradient each copy applied, joined over the model axis
    grads = M.gather_params([[{k: t.grad for k, t in c.items()}
                              for c in cells[0]]])
    want = ta.params_to_numpy({k: t.grad
                               for k, t in model.named_parameters()})
    for k in params:
        _close(grads[k], want[k], 1e-4, f"grad {k}")
    _params_close(M.gather_params(cells),
                  ta.params_to_numpy(dict(model.named_parameters())), params,
                  1e-4)
    with pytest.raises(ValueError, match="model axis"):
        M.replicate_params(params, grid)


def test_train_cli_round_trip(params, tmp_path):
    """The port's trainer writes an .npz that the JAX package reads; JAX's
    exact forward and the port's exact engine agree on its argmax."""
    from svision_tpu.models.checkpoint import load_params
    from svision_tpu_torch.infer.engine import InferenceEngine
    specs, labels = _labeled_specs(16, seed=2)
    data, out = tmp_path / "data.npz", tmp_path / "w.npz"
    np.savez(data, specs=specs, labels=labels)
    tt.main(["--data", str(data), "-o", str(out), "--epochs", "1",
             "--batch-size", "8", "--device", "cpu"])
    trained = load_params(str(out))
    assert trained.keys() == params.keys()
    assert trained["fc8/weights"].shape == (4096, 5)
    assert all(trained[k].dtype == np.float32 for k in trained)
    ep, vis, rev = jr.specs_to_endpoints(specs)
    images = jr.render_images_jit(jnp.asarray(ep), jnp.asarray(vis),
                                  jnp.asarray(rev))
    want = np.asarray(ja.forward(trained, images)).argmax(1)
    eng = InferenceEngine(trained, batch_size=16, bf16=False, device="cpu")
    got, _ = eng.predict_specs(specs)
    np.testing.assert_array_equal(got, want)
