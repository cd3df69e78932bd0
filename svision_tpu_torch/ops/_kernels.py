"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into its own shared library
with a plain C interface, loaded with ctypes. The build runs at first use,
one nvcc per source, all started together. In a source tree (the package's
parent holds pyproject.toml) it builds into <repo>/build/kernels/; an
installed package builds into the per-machine cache
~/.cache/svision-tpu/kernels/, the JAX package's cache convention, so a
kernel is compiled once per machine and never under site-packages. A
library's file name carries a hash of its sources and flags, so an edited
kernel is rebuilt, a stale one is never loaded, and two versions of the
package can share the cache.

Nothing is built or loaded at import: the CPU tests import every module,
and a machine without a GPU has neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_ROOT = os.path.dirname(_PKG)
_BUILD = (os.path.join(_ROOT, "build", "kernels")
          if os.path.exists(os.path.join(_ROOT, "pyproject.toml")) else
          os.path.join(os.path.expanduser("~"), ".cache", "svision-tpu",
                       "kernels"))
_HEADERS = ("bulk_ring.cuh", "raster_common.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (source, argtypes). Every entry returns the
# cudaError_t of its launch as an int.
ENTRIES = {
    "svt_render_raster": ("raster.cu", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "svt_bias_relu_pool_lrn": ("pool_lrn.cu",
                               [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "svt_bias_relu_pool_lrn_split": (
        "pool_lrn.cu", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "svt_bias_relu_pool_lrn_backward": (
        "pool_lrn_backward.cu",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "svt_conv1_fused_raster": ("conv1_raster.cu",
                               [_P, _P, _P, _P, _P, _I, _I, _P]),
    "svt_specs_endpoints": ("specs_endpoints.cu", [_P, _P, _P, _P, _I, _P]),
    "svt_moe_route": ("moe.cu", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _P]),
    "svt_moe_dispatch": ("moe.cu", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _P]),
    "svt_moe_bias_gelu": ("moe.cu", [_P, _P, _P, _I, _I, _I, _P]),
    "svt_moe_combine": ("moe.cu", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _P]),
}
SOURCES = tuple(sorted({src for src, _ in ENTRIES.values()}))

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the GPU")
    return found


def _lib_path(src: str) -> str:
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    for name in (src,) + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(_BUILD, f"lib{stem}-{h.hexdigest()[:12]}.so")


def build() -> Dict[str, str]:
    """Compile every source whose library is missing, all nvcc processes at
    once. Returns {source: library path}; raises with nvcc's output on a
    failed build. ptxas's register and shared-memory report is kept beside
    each library as <library>.log."""
    paths = {src: _lib_path(src) for src in SOURCES}
    todo = {src: p for src, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    try:
        os.makedirs(_BUILD, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"cannot create the kernel build directory "
                           f"{_BUILD}: {e}") from e
    if not os.access(_BUILD, os.W_OK):
        raise RuntimeError(f"the kernel build directory {_BUILD} cannot be "
                           "written")
    nvcc = _nvcc()
    procs = {}
    for src, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), tmp, path)
    errors = []
    for src, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src}:\n{out.decode(errors='replace')}")
        else:
            with open(path + ".log", "wb") as log:
                log.write(out)
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return paths


def function(name: str):
    """The ctypes function of a C entry point, building its library first
    if needed."""
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            src, argtypes = ENTRIES[name]
            lib = _libs.get(src)
            if lib is None:
                lib = _libs[src] = ctypes.CDLL(build()[src])
            fn = _fns[name] = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return fn


def launch(name: str, *args) -> None:
    """Call a C entry point; raise if the launch reported a CUDA error."""
    err = function(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_no_grad(name: str, *tensors) -> None:
    """Refuse inputs that autograd tracks. A kernel writes its output
    through raw pointers, so the output has no grad_fn: on the card a
    training graph would be cut there without a word (and an optimizer
    would skip the parameters before it). The plain versions would keep
    the graph on the CPU, so the check runs on every device, or the CPU
    tests could not see what the card does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: an input requires grad, and the kernel "
                         "is not differentiable; call it under "
                         "torch.no_grad() or torch.inference_mode()")


def check_cuda(*tensors) -> None:
    """All tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected tensors on one CUDA device, got "
                             f"{[str(u.device) for u in tensors]}")


def check_segments(endpoints, visible, reverse, segs=(2,)) -> int:
    """Validate the raster kernels' segment inputs; returns the image count.
    endpoints int32 [N,S,4], visible/reverse bool [N,S], all contiguous,
    with S one of segs (K3 reads two segments an image, K1 one to four)."""
    check_cuda(endpoints, visible, reverse)
    n, s = endpoints.shape[:2] if endpoints.dim() == 3 else (-1, -1)
    if s not in segs:
        raise ValueError(f"endpoints: expected [N,S,4] with S in {tuple(segs)}, "
                         f"got {tuple(endpoints.shape)}")
    for name, t, dtype, shape in (("endpoints", endpoints, torch.int32, (n, s, 4)),
                                  ("visible", visible, torch.bool, (n, s)),
                                  ("reverse", reverse, torch.bool, (n, s))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    return n
