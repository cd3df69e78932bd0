"""The port stands alone: it imports with jax absent, imports nothing of
jax, ml_dtypes or the JAX package (nor does chip_smoke.py), its entry
points refuse to run without a GPU unless asked for the CPU, and its kernel
wrappers never quietly fall back to their plain versions."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "svision_tpu_torch")

torch.set_num_threads(2)


def test_imports_with_jax_absent():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['ml_dtypes'] = None; "
            "import svision_tpu_torch, svision_tpu_torch.cli, "
            "svision_tpu_torch.infer.engine, svision_tpu_torch.models.alexnet, "
            "svision_tpu_torch.models.int8, "
            "svision_tpu_torch.ops.raster_kernel, "
            "svision_tpu_torch.ops.fused_pool_lrn, "
            "svision_tpu_torch.ops.fused_conv1, svision_tpu_torch.serve, "
            "svision_tpu_torch.parallel.mesh, svision_tpu_torch.parallel.dist, "
            "svision_tpu_torch.parallel.cohort, svision_tpu_torch.models.train, "
            "svision_tpu_torch.models.dataset, svision_tpu_torch.evaluate, "
            "svision_tpu_torch.graphs, svision_tpu_torch.device, "
            "svision_tpu_torch.truvari; "
            "assert not any(m == 'svision_tpu' or m.startswith('svision_tpu.') "
            "for m in sys.modules), 'JAX package imported'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


SCRIPTS = os.path.join(ROOT, "scripts")
# the port's files outside its package
ROOT_FILES = ("chip_smoke.py", "bench_torch.py", "__graft_entry_torch__.py")


def _port_scripts():
    return sorted(f[:-3] for f in os.listdir(SCRIPTS)
                  if f.startswith("torch_") and f.endswith(".py"))


def _python_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    for f in ROOT_FILES:
        yield os.path.join(ROOT, f)
    for name in _port_scripts():
        yield os.path.join(SCRIPTS, name + ".py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_package_imports():
    """Nor of the JAX package's root files (bench.py, __graft_entry__.py)
    or scripts."""
    jax_scripts = {f[:-3] for f in os.listdir(SCRIPTS)
                   if f.endswith(".py") and not f.startswith("torch_")}
    banned = {"jax", "jaxlib", "ml_dtypes", "svision_tpu", "bench",
              "__graft_entry__"} | jax_scripts
    bad = []
    for path in _python_files():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in banned:
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad


def test_tools_import_with_jax_absent():
    """The port's root files and scripts import with jax absent, and
    bring in nothing of the JAX package or its root files."""
    mods = [f[:-3] for f in ROOT_FILES] + _port_scripts()
    code = ("import sys, importlib; sys.modules['jax'] = None; "
            "sys.modules['ml_dtypes'] = None; "
            f"sys.path[:0] = [{ROOT!r}, {SCRIPTS!r}]; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('svision_tpu', 'bench', '__graft_entry__')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_engine_without_gpu_raises(monkeypatch):
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.models.alexnet import init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(init_params(0))


def test_models_without_gpu_raise(monkeypatch):
    """The AlexNet constructors and the trainers run on the CPU only when
    asked, as the engine does."""
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import AlexNet, init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = init_params(0)
    specs = np.repeat([[0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2]], 4, 0)
    calls = [lambda: AlexNet.from_params(params),
             lambda: AlexNet.trainable(params),
             lambda: train.fit(params, specs, np.zeros(4), batch_size=4),
             lambda: train.fit_device(params, specs, np.zeros(4),
                                      batch_size=4)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert AlexNet.from_params(params, device="cpu").fc8.weight.device.type \
        == "cpu"


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is neither on the CPU nor on CUDA is refused, not
    handed to the plain version."""
    from svision_tpu_torch.ops.fused_conv1 import conv1_fused_raster
    from svision_tpu_torch.ops.fused_pool_lrn import bias_relu_pool_lrn
    from svision_tpu_torch.ops.raster_kernel import render_raster
    ep = torch.zeros((2, 2, 4), dtype=torch.int32, device="meta")
    flags = torch.zeros((2, 2), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        render_raster(ep, flags, flags)
    with pytest.raises(ValueError):
        conv1_fused_raster(ep, flags, flags,
                           torch.zeros((3, 3, 48, 96), device="meta"))
    with pytest.raises(ValueError):
        bias_relu_pool_lrn(torch.zeros((1, 5, 5, 8), device="meta"),
                           torch.zeros(8, device="meta"))


def test_cpu_path_counts_no_launches():
    from svision_tpu_torch.ops import fused_pool_lrn
    before = fused_pool_lrn.bias_relu_pool_lrn.launches
    fused_pool_lrn.bias_relu_pool_lrn(torch.ones((1, 5, 5, 8)),
                                      torch.zeros(8))
    assert fused_pool_lrn.bias_relu_pool_lrn.launches == before


def test_init_params_seeded():
    from svision_tpu_torch.models.alexnet import init_params
    a, b = init_params(3), init_params(3)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["conv1/weights"].shape == (11, 11, 3, 96)
    assert a["fc6/weights"].shape == (9216, 4096)


def test_wrappers_refuse_inputs_that_require_grad():
    """A kernel writes through raw pointers and cuts the autograd graph,
    silently on the card, so every wrapper refuses an input that requires
    grad while grad mode is on, on the CPU too; under no_grad or
    inference_mode (the engine's) it runs."""
    from svision_tpu_torch.ops.fused_conv1 import conv1_fused_raster
    from svision_tpu_torch.ops.fused_pool_lrn import bias_relu_pool_lrn
    from svision_tpu_torch.ops.raster_kernel import render_images, render_raster
    ep = torch.zeros((1, 2, 4), dtype=torch.int32)
    flags = torch.zeros((1, 2), dtype=torch.bool)
    x = torch.ones((1, 5, 5, 8), requires_grad=True)
    w = torch.zeros((3, 3, 48, 96), requires_grad=True)
    ep_f = ep.float().requires_grad_(True)
    calls = [lambda: bias_relu_pool_lrn(x, torch.zeros(8)),
             lambda: bias_relu_pool_lrn(torch.ones((1, 5, 5, 8)),
                                        torch.zeros(8, requires_grad=True)),
             lambda: conv1_fused_raster(ep, flags, flags, w),
             lambda: render_raster(ep_f, flags, flags),
             lambda: render_images(ep_f, flags, flags)]
    for call in calls:
        with pytest.raises(ValueError, match="requires grad"):
            call()
    with torch.no_grad():
        assert bias_relu_pool_lrn(x, torch.zeros(8)).shape == (1, 2, 2, 8)
    with torch.inference_mode():
        assert conv1_fused_raster(ep, flags, flags, w).shape == (1, 55, 55, 96)
