"""Time K3's f32 path (svision_tpu_torch/csrc/conv1_raster.cu, namespace
simt) against other builds of it and, given a parent checkout, against the
parent's, in turns, on one CUDA GPU.

Run from the repository root on the machine with the card:

    python3 scripts/torch_k3_variants.py [--parent DIR] [--out FILE]

A variant is a copy of conv1_raster.cu with a few lines replaced (the
consumer warps, the quads a thread owns, the items' order), or DIR's own
conv1_raster.cu
(--parent: a checkout holding svision_tpu_torch/, such as `git archive`
of the parent commit unpacked under build/). Every variant is built by
nvcc, all at once, into build/k3_variants/, with the package's flags
(ptxas's register and spill report kept per kernel). At batch 128 on
chip_smoke's random specs with its DEGENERATE ones, on densely lit specs
(timing.diagonal_specs) and at batch 4,096, each must agree with the plain
version within 1e-4 of its largest output (chip_smoke's f32 bar) under
exact_f32(), but for the diagnostic ones. Its time is the mean of 20
back-to-back launches with the queue held (timing.time_ms), 5 at batch
4,096, taken in the order A B ... B A and averaged; beside it the bound
(chip_smoke.least of benchmark/work.py's K3 stage in f32, the lit pixels'
multiply-accumulates counted) and what bounds it, the share of it reached,
and a torch zero_ of the output's bytes (a write of the same bytes with
nothing computed).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV1 = os.path.join(ROOT, "svision_tpu_torch", "csrc", "conv1_raster.cu")
# name: {text: its replacement}, each text found once in conv1_raster.cu.
# A "diagnostic" variant gives wrong outputs on purpose (nothing lit, or no
# weights): it is timed, not checked, to show what a part of the kernel costs.
VARIANTS = {
    "lists": {},
    "lists, 1 quad a thread": {"kLaneQuads = 2;": "kLaneQuads = 1;"},
    "lists, 3 quads a thread": {"kLaneQuads = 2;": "kLaneQuads = 3;"},
    "lists, 20 consumer warps": {
        "kConsumers = 896;": "kConsumers = 640;"},
    "lists, contiguous runs of items": {
        "  // lit image spread over the blocks\n"
        "  const int items = n_img * kBands;\n":
        "  // lit image spread over the blocks\n"
        "  const int items = n_img * kBands;\n"
        "  const int first = static_cast<int>(1LL * blockIdx.x * items\n"
        "                                     / gridDim.x);\n"
        "  const int last = static_cast<int>(1LL * (blockIdx.x + 1) * items\n"
        "                                    / gridDim.x);\n",
        "    for (int item = blockIdx.x, j = 0; item < items;\n"
        "         item += gridDim.x, ++j) {":
        "    for (int item = first, j = 0; item < last; ++item, ++j) {",
        "  for (int item = blockIdx.x, j = 0; item < items; item += gridDim.x, "
        "++j) {": "  for (int item = first, j = 0; item < last; ++item, ++j) {",
        "    if (item + 2 * static_cast<int>(gridDim.x) < items) {":
        "    if (item + 2 < last) {"},
    "diagnostic: every pixel dark": {
        "uint32_t t = taps[px];": "uint32_t t = 0;"},
    "diagnostic: no weight copy": {
        "i < static_cast<int>(kWBytes / 16);": "i < 0;"},
}


def build(sources: dict, build_dir: str) -> dict:
    """sources: {name: (conv1_raster.cu path, {text: replacement})} ->
    {name: (library, ptxas report by kernel)}, every nvcc started
    together."""
    import chip_smoke
    from svision_tpu_torch.ops import _kernels
    procs = {}
    for i, (name, (cu, edits)) in enumerate(sources.items()):
        d = os.path.join(build_dir, str(i))
        os.makedirs(d, exist_ok=True)
        with open(cu) as f:
            text = f.read()
        for old, new in edits.items():
            assert text.count(old) == 1, f"{old!r} not found once in {cu}"
            text = text.replace(old, new)
        dst = os.path.join(d, "conv1_raster.cu")
        with open(dst, "w") as f:
            f.write(text)
        lib = os.path.join(d, "libk3.so")
        # the variant's own headers first (a parent's), then the package's
        procs[name] = (subprocess.Popen(
            [_kernels._nvcc(), *_kernels._FLAGS, f"-I{os.path.dirname(cu)}",
             f"-I{_kernels._CSRC}", "-o", lib, dst],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        assert proc.returncode == 0, f"variant {name} did not build:\n{out}"
        with open(lib + ".log", "w") as f:
            f.write(out)
        libs[name] = (lib, chip_smoke.ptxas_by_kernel(lib + ".log"))
    return libs


def caller(lib: str):
    """K3's C entry point in lib, called as the wrapper calls it."""
    import torch
    from svision_tpu_torch.ops import _kernels
    fn = ctypes.CDLL(lib).svt_conv1_fused_raster
    fn.argtypes = _kernels.ENTRIES["svt_conv1_fused_raster"][1]
    fn.restype = ctypes.c_int

    def call(ep, vis, rev, w):
        out = torch.empty((ep.shape[0], 55, 55, 96), dtype=w.dtype,
                          device=ep.device)
        err = fn(ep.data_ptr(), vis.data_ptr(), rev.data_ptr(), w.data_ptr(),
                 out.data_ptr(), ep.shape[0], int(w.dtype == torch.bfloat16),
                 _kernels.stream_of(ep))
        assert err == 0, f"{lib}: CUDA error {err}"
        return out
    return call


def inputs() -> dict:
    """K3's inputs by case: chip_smoke's batch of random specs with its
    DEGENERATE ones, densely lit specs, and a batch of 4,096."""
    import numpy as np
    import torch
    import chip_smoke
    from svision_tpu_torch.ops import rasterize
    from svision_tpu_torch.timing import diagonal_specs, random_specs
    dev = torch.device("cuda")
    b = chip_smoke.B
    cases = {"random": np.concatenate([
                 random_specs(b - len(chip_smoke.DEGENERATE), seed=1),
                 np.array(chip_smoke.DEGENERATE, np.int64)]),
             "dense": diagonal_specs(b, seed=0),
             "random 4096": random_specs(4096, seed=5)}
    return {k: tuple(torch.from_numpy(a).to(dev)
                     for a in rasterize.specs_to_endpoints(s))
            for k, s in cases.items()}


def measure(calls: dict, w) -> list:
    """Each variant checked and timed in turns on every case, with a torch
    zero_ of the output's bytes beside them."""
    import torch
    import chip_smoke
    from svision_tpu_torch.infer.engine import exact_f32
    from svision_tpu_torch.ops import fused_conv1
    from svision_tpu_torch.timing import time_ms
    rows = []
    for case, seg in inputs().items():
        n = seg[0].shape[0]
        with exact_f32():
            want = torch.cat([fused_conv1.conv1_fused_raster_plain(
                *(t[i:i + 1024] for t in seg), w) for i in range(0, n, 1024)])
            scale = want.abs().max().item()
            for name, call in calls.items():
                if name.startswith("diagnostic"):
                    continue
                err = (call(*seg, w) - want).abs().max().item()
                assert err <= 1e-4 * scale, \
                    f"variant {name} {case}: {err} > 1e-4 * {scale}"
        bound, by = chip_smoke.least(*chip_smoke.stage(
            "conv1_fused_raster", "f32", n,
            lit_macs=chip_smoke.lit_macs(*seg)))
        timed = dict(calls, **{"context: torch zero_ of the output":
                               lambda *_, o=want: o.zero_()})
        reps = 20 if n <= chip_smoke.B else 5
        t = {name: [] for name in timed}
        for name in list(timed) + list(timed)[::-1]:
            t[name].append(time_ms(lambda f=timed[name]: f(*seg, w),
                                   reps=reps))
        for name in timed:
            ms = sum(t[name]) / 2
            rows.append(dict(variant=name, case=case, batch=n, ms=ms,
                             turns_ms=t[name], bound_ms=bound,
                             bound_by=by, bound_fraction=bound / ms))
            print(json.dumps(rows[-1]), flush=True)
        del want
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose conv1_raster.cu is "
                    "timed as the variant 'parent'")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from svision_tpu_torch.models.alexnet import fold_conv1_params, init_params
    from svision_tpu_torch.timing import nvidia_smi

    smi = nvidia_smi()
    print(smi, flush=True)
    sources = {name: (CONV1, edits) for name, edits in VARIANTS.items()}
    if args.parent:
        sources["parent"] = (os.path.join(os.path.abspath(args.parent),
                                          "svision_tpu_torch", "csrc",
                                          "conv1_raster.cu"), {})
    built = build(sources, os.path.join(ROOT, "build", "k3_variants"))
    calls = {name: caller(lib) for name, (lib, _) in built.items()}
    w = torch.from_numpy(fold_conv1_params(init_params(0))["conv1/weights"])
    rows = measure(calls, w.to("cuda").contiguous())
    ptxas = {name: report for name, (_, report) in built.items()}
    print(json.dumps(ptxas, indent=1), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(nvidia_smi=smi, variants=rows, ptxas=ptxas), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
