"""The port installed as its own command, `svision-tpu-torch`.

Both packaging files name the command and the `torch` extra. A copy of the
tree is installed offline into a scratch prefix (`pip install --no-deps
--no-build-isolation --no-index --prefix`), and from a directory outside
the checkout, with PYTHONPATH set to the prefix's site-packages alone and
HOME to an empty directory:
  * the installed `svision-tpu-torch --exact --device cpu` gives the output
    tree of the installed `svision-tpu --exact`, byte for byte but the run
    log, the bar of tests/test_torch_cli_modes.py;
  * its VCF equals an in-process svision_tpu_torch.cli.run_pipeline run of
    the same arguments byte for byte;
  * without --device it refuses to run on the CPU;
  * its kernels would build in ~/.cache/svision-tpu/kernels, never under
    site-packages, where a checkout builds in <repo>/build/kernels.
Sample: chr1 150 kb, DEL/INS/INV, support 8, seed 7 (tests/synth.py), the
JAX package's PRNGKey(0) weights.
"""
import ast
import glob
import importlib
import os
import re
import shutil
import subprocess
import sys
import tomllib

import jax
import numpy as np
import pytest
import torch

from svision_tpu.models import alexnet as ja
from svision_tpu.models.checkpoint import save_params
from svision_tpu_torch import cli as port_cli
from svision_tpu_torch.ops import _kernels
from tests.synth import make_genome, make_sv_bam
from tests.test_torch_cli_modes import _records, assert_same_tree

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"svision-tpu": "svision_tpu.cli:main",
           "svision-tpu-torch": "svision_tpu_torch.cli:main"}
# what the JAX package's packaging named before the port's command
DEPENDENCIES = ["jax>=0.4.30,<2", "numpy>=1.26", "optax>=0.2"]
PACKAGE_DATA = {"svision_tpu.io": ["native/Makefile", "native/*.cc"],
                "svision_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                "svision_tpu_torch.io": ["native/Makefile", "native/*.cc",
                                         "native/build.sh"]}
# what an install copies: the packaging files and both packages
TREE = ("pyproject.toml", "setup.py", "svision_tpu", "svision_tpu_torch")
EVENTS = [("DEL", "chr1", 20000, 300), ("INS", "chr1", 60000, 220),
          ("INV", "chr1", 100000, 400)]
ARGS = ["-n", "synthsample", "-s", "3", "--batch_size", "32",
        "--mesh", "none"]


def _checkout_state():
    """What an install could leave in the checkout: egg-info directories
    and the top of build/."""
    build = os.path.join(ROOT, "build")
    return (sorted(glob.glob(os.path.join(ROOT, "*.egg-info"))),
            sorted(os.listdir(build)) if os.path.isdir(build) else None)


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """A copy of the tree installed offline into a scratch prefix; the
    checkout gains nothing."""
    root = tmp_path_factory.mktemp("install")
    src, prefix, home = root / "src", root / "prefix", root / "home"
    src.mkdir()
    home.mkdir()
    for name in TREE:
        path = os.path.join(ROOT, name)
        if os.path.isdir(path):
            shutil.copytree(path, src / name, ignore=shutil.ignore_patterns(
                "build", "__pycache__", "*.so"))
        else:
            shutil.copy(path, src / name)
    before = _checkout_state()
    subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps",
                    "--no-build-isolation", "--no-index", "--no-cache-dir",
                    "--prefix", str(prefix), str(src)],
                   check=True, capture_output=True, timeout=300,
                   env=dict(os.environ, HOME=str(home)))
    assert _checkout_state() == before
    (site,) = glob.glob(str(prefix / "lib" / "python*" / "site-packages"))
    env = dict(os.environ, PYTHONPATH=site, HOME=str(home),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    return dict(root=root, bin=str(prefix / "bin"), site=site, home=str(home),
                env=env)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    root = tmp_path_factory.mktemp("install_sample")
    genome, bam, weights = (str(root / f) for f in
                            ("ref.fa", "sample.bam", "w.npz"))
    seqs = make_genome(genome, {"chr1": 150000}, seed=7)
    make_sv_bam(bam, seqs, seed=7, support=8, events=EVENTS)
    save_params({k: np.asarray(v) for k, v in
                 ja.init_params(jax.random.PRNGKey(0)).items()}, weights)
    return ["-b", bam, "-g", genome, "-m", weights, *ARGS]


@pytest.fixture(scope="module")
def runs(installed, sample):
    """Output directories of the installed port's and the installed JAX
    package's --exact runs, the two commands run at once."""
    out = {k: str(installed["root"] / k) for k in ("port", "jax")}
    flags = {"port": ["--exact", "--device", "cpu"], "jax": ["--exact"]}
    scripts = {"port": "svision-tpu-torch", "jax": "svision-tpu"}
    logs = {k: installed["root"] / f"{k}.log" for k in out}
    procs = {}
    try:
        for k in out:
            with open(logs[k], "w") as log:
                procs[k] = subprocess.Popen(
                    [os.path.join(installed["bin"], scripts[k]), "-o", out[k],
                     *sample, *flags[k]], cwd=installed["root"],
                    env=installed["env"], stdout=log,
                    stderr=subprocess.STDOUT)
        for p in procs.values():
            p.wait(timeout=300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, f"{scripts[k]} exited {p.returncode}:\n" \
            + logs[k].read_text()[-3000:]
    return out


def _vcf(outdir):
    (vcf,) = glob.glob(os.path.join(outdir, "*.vcf"))
    return vcf


def test_pyproject_names_the_command():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        meta = tomllib.load(f)
    project = meta["project"]
    assert project["scripts"] == SCRIPTS
    module, attr = SCRIPTS["svision-tpu-torch"].split(":")
    assert getattr(importlib.import_module(module), attr) is port_cli.main
    assert project["dependencies"] == DEPENDENCIES
    assert meta["tool"]["setuptools"]["package-data"] == PACKAGE_DATA
    extra = project["optional-dependencies"]["torch"]
    assert any(r.startswith("torch>=") for r in extra)


def _setup_keywords():
    tree = ast.parse(open(os.path.join(ROOT, "setup.py")).read())
    (call,) = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and getattr(n.func, "id", None) == "setup"]
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg in ("entry_points", "extras_require", "package_data")}


def test_setup_py_names_the_command():
    kw = _setup_keywords()
    scripts = dict(s.replace(" ", "").split("=")
                   for s in kw["entry_points"]["console_scripts"])
    assert scripts == SCRIPTS
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        extra = tomllib.load(f)["project"]["optional-dependencies"]["torch"]
    assert kw["extras_require"] == {"torch": extra}
    assert kw["package_data"] == PACKAGE_DATA


def test_install_carries_the_command_and_kernel_sources(installed):
    for script in SCRIPTS:
        assert os.access(os.path.join(installed["bin"], script), os.X_OK)
    want = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(ROOT, "svision_tpu_torch", "csrc", "*.cu*")))
    got = sorted(os.listdir(os.path.join(installed["site"],
                                         "svision_tpu_torch", "csrc")))
    assert got == want and len(want) == 8


def test_installed_port_matches_installed_jax(runs):
    """The two commands users type, at tests/test_torch_cli_modes.py's
    bar: the same files, each byte for byte but the run log."""
    assert _records(_vcf(runs["jax"])), "the JAX command wrote no records"
    assert os.path.basename(_vcf(runs["port"])) == \
        os.path.basename(_vcf(runs["jax"]))
    assert_same_tree(runs["port"], runs["jax"])


def test_installed_port_matches_in_process(runs, sample, tmp_path):
    vcf = port_cli.run_pipeline(port_cli.parse_arguments(
        ["-o", str(tmp_path / "port"), *sample, "--exact", "--device",
         "cpu"]))
    with open(vcf, "rb") as f, open(_vcf(runs["port"]), "rb") as g:
        assert f.read() == g.read()
    assert_same_tree(str(tmp_path / "port"), runs["port"])


def test_installed_port_refuses_the_cpu_unasked(installed, sample):
    """No --device: the run is on the card, and with none visible the
    command fails instead of carrying on on the CPU."""
    out = str(installed["root"] / "unasked")
    p = subprocess.run(
        [os.path.join(installed["bin"], "svision-tpu-torch"), "-o", out,
         *sample, "--exact"], cwd=installed["root"],
        env=dict(installed["env"], CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "no CUDA device available" in p.stderr
    assert not glob.glob(os.path.join(out, "*.vcf"))


def test_checkout_builds_kernels_in_its_build_dir():
    assert _kernels._BUILD == os.path.join(ROOT, "build", "kernels")


def test_installed_copy_builds_kernels_in_the_cache(installed, runs):
    """From the installed copy the build directory is the per-machine
    cache under HOME; the CPU runs built nothing, under site-packages or
    in the cache."""
    code = ("import svision_tpu_torch; from svision_tpu_torch.ops import "
            "_kernels; print(svision_tpu_torch.__file__); "
            "print(_kernels._BUILD)")
    p = subprocess.run([sys.executable, "-c", code], cwd=installed["root"],
                       env=installed["env"], capture_output=True, text=True,
                       check=True, timeout=120)
    pkg, build = p.stdout.splitlines()
    assert pkg == os.path.join(installed["site"], "svision_tpu_torch",
                               "__init__.py")
    cache = os.path.join(installed["home"], ".cache", "svision-tpu",
                         "kernels")
    assert build == cache
    assert not os.path.exists(os.path.join(installed["site"], "build"))
    assert not os.path.exists(cache)


def test_unwritable_build_dir_raises_naming_it(tmp_path, monkeypatch):
    """build() raises and names the directory; no launch falls back to a
    plain version."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    bad = str(blocker / "kernels")
    monkeypatch.setattr(_kernels, "_BUILD", bad)
    with pytest.raises(RuntimeError, match=re.escape(bad)):
        _kernels.build()
