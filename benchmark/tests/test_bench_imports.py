"""What the benchmark's modules import: nothing of JAX or of the JAX
package anywhere (top-level names compared whole, so svision_tpu_torch is
not svision_tpu), and nothing of the program in the reference."""

import ast
import os

import pytest

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "svision_tpu"}
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(spec.HERE)
               for f in fs if f.endswith(".py"))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_scan_sees_the_files():
    assert any(p.endswith("run.py") for p in FILES)
    assert any(os.sep + "reference" + os.sep in p for p in FILES)


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, spec.HERE) for p in FILES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_names_are_compared_whole():
    assert "svision_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference"
                                  + os.sep in p])
def test_reference_imports_nothing_of_the_program(path):
    assert "svision_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "contextlib", "typing",
                                       "numpy", "torch", "benchmark"}


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    import types
    from benchmark import run
    monkeypatch.setitem(sys.modules, "svision_tpu_torch_probe",
                        types.ModuleType("svision_tpu_torch_probe"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "svision_tpu.cli",
                        types.ModuleType("svision_tpu.cli"))
    assert run.forbidden_modules() == ["svision_tpu"]
