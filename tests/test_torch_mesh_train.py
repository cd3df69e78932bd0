"""The port's DP x TP train step (make_mesh_train_step) on a 2 x 2 grid of
CPU replicas (2 data rows x 2 model columns, fc6/fc7 split), at full width
and batch 8: against the JAX package's jitted mesh step on a 2 x 2 virtual
CPU mesh, and, run eagerly as the CPU runs them, the pieces the step is cut
into against the composite step they were cut from. Weights are the JAX
package's init_params(PRNGKey(0)); inputs are rasters of labeled specs."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding, PartitionSpec as P

from svision_tpu.models import alexnet as ja
from svision_tpu.models import train as jt
from svision_tpu.ops import rasterize as jr
from svision_tpu.parallel import mesh as jm
from svision_tpu_torch.models import train as tt
from svision_tpu_torch.parallel import mesh as tm
from tests.test_torch_train import _params_close
from tests.test_training import _labeled_specs

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def params():
    return {k: np.asarray(v)
            for k, v in ja.init_params(jax.random.PRNGKey(0)).items()}


@pytest.fixture(scope="module")
def batch():
    specs, labels = _labeled_specs(8, seed=5)
    ep, vis, rev = jr.specs_to_endpoints(specs)
    images = np.asarray(jr.render_images_jit(
        *[jnp.asarray(a) for a in (ep, vis, rev)]))
    return images, labels


def _grid_cells(params):
    cells = tm.shard_params_tp(params, tm.make_train_mesh(2, 2, device="cpu"))
    for row in cells:
        for cell in row:
            assert cell["fc6.weight"].shape == (2048, 9216)
            assert cell["fc7.weight"].shape == (4096, 2048)
    return cells


def _still_split(cells):
    for row in cells:
        for cell in row:
            assert cell["fc6.weight"].shape == (2048, 9216)
            assert cell["fc6.bias"].shape == (2048,)
            assert cell["fc7.weight"].shape == (4096, 2048)


# the JAX package's jitted mesh step doubles these gradients on a mesh
# whose data and model axes both exceed 1 (jax 0.9.0, virtual CPU mesh):
# the grouped convolutions' weights (ROADMAP C)
JAX_MESH_DOUBLED = ("conv2/weights", "conv4/weights", "conv5/weights")


def _jax_steps(params, images, labels, clip, steps, mesh=None):
    """The JAX package's make_train_step, jitted, `steps` steps at
    keep_prob 1 (lr 1e-3, momentum 0.9, optax's global-norm clip first
    when clip is set): on one device, or over mesh with shard_params_tp
    and the batch on 'data', as tests/test_parallel.py runs it. Returns
    (losses, params)."""
    sgd = optax.sgd(1e-3, momentum=0.9)
    opt = sgd if clip is None else optax.chain(optax.clip_by_global_norm(clip),
                                               sgd)
    init, step = jt.make_train_step(opt, keep_prob=1.0)
    step = jax.jit(step)
    x, y = jnp.asarray(images), jnp.asarray(labels)
    p = params
    if mesh is not None:
        rows = NamedSharding(mesh, P("data"))
        x, y = jax.device_put(x, rows), jax.device_put(y, rows)
        p = jm.shard_params_tp(params, mesh)
    o, losses = init(p), []
    for key in range(1, steps + 1):
        p, o, loss = step(p, o, x, y, jax.random.PRNGKey(key))
        losses.append(float(loss))
    if mesh is not None:
        assert tuple(p["fc6/weights"].sharding.spec) == (None, "model")
        assert tuple(p["fc7/weights"].sharding.spec)[0] == "model"
    return losses, {k: np.asarray(v) for k, v in p.items()}


def _port_steps(params, images, labels, clip, steps):
    cells = _grid_cells(params)
    _, step = tt.make_mesh_train_step(cells, learning_rate=1e-3,
                                      clip_norm=clip, keep_prob=1.0)
    gens = {CPU: torch.Generator().manual_seed(0)}
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    losses = [float(step(x, y, gens)) for _ in range(steps)]
    _still_split(cells)
    return losses, tm.gather_params(cells)


def test_mesh_step_against_jax_mesh_step(params, batch):
    """One step (no clip) against the JAX package's make_train_step
    jitted over make_mesh(4, model_axis=2), a 2 x 2 virtual CPU mesh: the
    loss within 1e-4 relative and every update within 3e-3 of its largest
    entry (tests/test_torch_train.py's bar), fc6 and fc7 still split on
    both sides, but for the three tensors of JAX_MESH_DOUBLED, whose JAX
    update is twice the port's (and twice the JAX package's own
    one-device step's: test_mesh_step_matches_jax_one_device_steps)."""
    images, labels = batch
    want_loss, want = _jax_steps(params, images, labels, None, 1,
                                 mesh=jm.make_mesh(4, model_axis=2))
    got_loss, got = _port_steps(params, images, labels, None, 1)
    assert abs(got_loss[0] - want_loss[0]) <= 1e-4 * abs(want_loss[0])
    for k in params:
        upd_got, upd_want = got[k] - params[k], want[k] - params[k]
        if k in JAX_MESH_DOUBLED:
            upd_got = 2 * upd_got
        err = float(np.abs(upd_got - upd_want).max())
        assert err <= 3e-3 * float(np.abs(upd_want).max()), (k, err)


@pytest.mark.parametrize("clip", [None, 1.0])
def test_mesh_step_matches_jax_one_device_steps(params, batch, clip):
    """Two steps on the 2 x 2 grid against the JAX package's jitted step
    on one device, the semantics GSPMD's mesh step is to keep: each step's
    loss within 1e-4 relative, the parameters within 3e-3 of the update
    (the JAX package's own f32 steps drift from f64 by up to 2.6e-3 of
    it), fc6 and fc7 still split."""
    images, labels = batch
    want_losses, want = _jax_steps(params, images, labels, clip, 2)
    got_losses, got = _port_steps(params, images, labels, clip, 2)
    for g, w in zip(got_losses, want_losses):
        assert abs(g - w) <= 1e-4 * abs(w), (got_losses, want_losses)
    _params_close(got, want, params, 3e-3)


def _composite_step(cells, learning_rate, clip_norm, keep_prob):
    """The DP x TP step as one autograd graph over the grid, eager, as
    make_mesh_train_step ran it before it was cut into pieces (f32)."""
    groups = [[cells[d][m][k] for (d, m), k in g] for g in tm.holders(cells)]
    opt = torch.optim.SGD([t for g in groups for t in g], lr=learning_rate,
                          momentum=0.9)
    nd, cd = len(cells), torch.float32
    head0 = cells[0][0]["fc8.weight"].device

    def mesh_loss(images, labels, generators):
        rows = images.shape[0] // nd
        losses = []
        for d, row in enumerate(cells):
            x = images[d * rows:(d + 1) * rows]
            y = labels[d * rows:(d + 1) * rows]
            dev0 = row[0]["fc8.weight"].device
            fc7 = None
            for cell in row:
                dev = cell["fc8.weight"].device
                h = tt._features(cell, x.to(dev).to(cd).permute(0, 3, 1, 2),
                                 cd, s2d=False)
                h = tt._dense_relu(h, cell["fc6.weight"], cell["fc6.bias"], cd)
                h = tt._dropout(h, keep_prob, generators[dev])
                part = F.linear(h, cell["fc7.weight"].to(cd)).to(dev0)
                fc7 = part if fc7 is None else fc7 + part
            h = torch.relu(fc7 + row[0]["fc7.bias"].to(cd))
            h = tt._dropout(h, keep_prob, generators[dev0])
            logits = F.linear(h.float(), row[0]["fc8.weight"].float(),
                              row[0]["fc8.bias"].float())
            losses.append(F.cross_entropy(logits, y.to(dev0).long()).to(head0))
        return torch.stack(losses).mean()

    def train_step(images, labels, generators):
        opt.zero_grad(set_to_none=True)
        with tt.training_precision(cd):
            loss = mesh_loss(images, labels, generators)
            loss.backward()
        grads = []
        for group in groups:
            g = torch.zeros_like(group[0])
            for t in group:
                if t.grad is not None:
                    g += t.grad.to(g.device)
            grads.append(g)
        if clip_norm is not None:
            tt.clip_by_global_norm_(grads, clip_norm)
        for group, g in zip(groups, grads):
            for t in group:
                t.grad = g.to(t.device)
        opt.step()
        return loss.detach()

    return train_step


@pytest.mark.parametrize("keep_prob", [1.0, 0.5])
def test_mesh_pieces_match_composite_step(params, batch, keep_prob):
    """The step's pieces, run eagerly (fwd, head and bwd row by row, then
    reduce and update), against the composite step from the same weights
    and generator seed, two steps with clip 1: losses within 1e-6
    relative, parameters and their applied gradients within 1e-6 of their
    largest entry. At keep_prob 0.5 the dropout masks come from one CPU
    generator shared by the four cells, so this also holds the pieces to
    the composite's order of draws. Then a call with another batch shape
    raises: the step's inputs are static buffers."""
    images, labels = (torch.from_numpy(a) for a in batch)
    got, want = _grid_cells(params), _grid_cells(params)
    _, pieces = tt.make_mesh_train_step(got, learning_rate=5e-3,
                                        clip_norm=1.0, keep_prob=keep_prob)
    composite = _composite_step(want, 5e-3, 1.0, keep_prob)
    g_gen = {CPU: torch.Generator().manual_seed(3)}
    w_gen = {CPU: torch.Generator().manual_seed(3)}
    for _ in range(2):
        lg = float(pieces(images, labels, g_gen))
        lw = float(composite(images, labels, w_gen))
        assert abs(lg - lw) <= 1e-6 * abs(lw), (lg, lw)
    for row_g, row_w in zip(got, want):
        for cg, cw in zip(row_g, row_w):
            for k in cw:
                for a, b in ((cg[k], cw[k]), (cg[k].grad, cw[k].grad)):
                    a, b = a.detach(), b.detach()
                    err = float((a - b).abs().max())
                    assert err <= 1e-6 * float(b.abs().max()), (k, err)
    _still_split(got)
    with pytest.raises(ValueError, match="first call's shapes"):
        pieces(images[:4], labels[:4], g_gen)


def test_mesh_step_needs_even_rows(params, batch):
    images, labels = (torch.from_numpy(a) for a in batch)
    _, step = tt.make_mesh_train_step(_grid_cells(params), keep_prob=1.0)
    with pytest.raises(ValueError, match="split evenly over 2 data rows"):
        step(images[:7], labels[:7], {CPU: torch.Generator()})
