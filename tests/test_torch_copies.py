"""The port's host stack is a verbatim copy of the JAX package's: each
copied file equals its twin byte for byte once the package name
`svision_tpu` is rewritten to `svision_tpu_torch`. An edit to either copy
alone fails here, whatever inputs the end-to-end fixtures reach."""
import glob
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "svision_tpu")
PORT_PKG = os.path.join(ROOT, "svision_tpu_torch")

# directories copied whole, and single files copied on their own
COPIED_DIRS = ["io", "io/native", "collect", "call"]
COPIED_FILES = ["config.py", "noise.py", "sim.py", "models/checkpoint.py",
                "ops/__init__.py", "ops/bresenham.py", "ops/dotplot.py",
                "utils/__init__.py", "utils/metrics.py", "utils/hostpool.py",
                "infer/__init__.py", "parallel/__init__.py",
                "models/dataset.py", "evaluate.py", "truvari.py"]


def _sources(pkg, d):
    return sorted(os.path.relpath(p, pkg)
                  for p in glob.glob(os.path.join(pkg, d, "*"))
                  if os.path.isfile(p) and not p.endswith((".so", ".pyc")))


COPIES = sorted({f for d in COPIED_DIRS for f in _sources(PORT_PKG, d)}
                | set(COPIED_FILES))


@pytest.mark.parametrize("d", COPIED_DIRS)
def test_copied_directory_is_complete(d):
    assert _sources(PORT_PKG, d) == _sources(JAX_PKG, d)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_twin(rel):
    with open(os.path.join(JAX_PKG, rel), "rb") as f:
        want = re.sub(rb"\bsvision_tpu\b", b"svision_tpu_torch", f.read())
    with open(os.path.join(PORT_PKG, rel), "rb") as f:
        got = f.read()
    assert got == want, f"{rel} differs from svision_tpu/{rel}"
