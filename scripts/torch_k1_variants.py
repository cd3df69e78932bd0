"""Time K1 (svision_tpu_torch/csrc/raster.cu) against other builds of it and
against its per-pixel design (scripts/k1_per_pixel.cu), in turns, on one
CUDA GPU.

Run from the repository root on the machine with the card:

    python3 scripts/torch_k1_variants.py [--out FILE]

A variant is a copy of raster.cu with a few lines replaced (the band
height, the block size, the store policy), or the per-pixel design. Every
variant is built by nvcc, all at once, into build/k1_variants/, with the
package's flags (ptxas's register and shared-memory report kept per
kernel). In f32 and bf16, at S = 2
(candidates) and S = 4 (fit_device's fragments, train.fragment_endpoints_torch)
and at batch 128 and 256 (chip_smoke's random specs with its DEGENERATE
ones), each must be bit-equal to the plain raster. Its time is the mean of
20 back-to-back launches with the queue held (chip_smoke.time_ms), taken in
the order A B ... B A and averaged; beside it the bound (chip_smoke.k1_least:
the bytes the call must move, as benchmark/work.py counts them at S = 2,
over the card's memory rate in benchmark/peaks.json) and the share of the
bound reached.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RASTER = os.path.join(ROOT, "svision_tpu_torch", "csrc", "raster.cu")
PER_PIXEL = os.path.join(ROOT, "scripts", "k1_per_pixel.cu")
# name: (source, {text: its replacement}), each text found once
VARIANTS = {
    "tables": (RASTER, {}),
    "tables, plain stores": (RASTER, {
        "__stcs(vout + v, q);": "vout[v] = q;"}),
    "tables, 57-row bands": (RASTER, {
        "kBandRows = 29;": "kBandRows = 57;"}),
    "tables, 15-row bands, 192 threads": (RASTER, {
        "kBandRows = 29;": "kBandRows = 15;",
        "kThreads = 384;": "kThreads = 192;"}),
    "per-pixel": (PER_PIXEL, {}),
}


def build(variants: dict, build_dir: str) -> dict:
    """{name: (library, ptxas report by kernel)}, every nvcc started
    together."""
    import chip_smoke
    from svision_tpu_torch.ops import _kernels
    procs = {}
    for i, (name, (cu, edits)) in enumerate(variants.items()):
        d = os.path.join(build_dir, str(i))
        os.makedirs(d, exist_ok=True)
        with open(cu) as f:
            text = f.read()
        for old, new in edits.items():
            assert text.count(old) == 1, f"{old!r} not found once in {cu}"
            text = text.replace(old, new)
        cu = os.path.join(d, os.path.basename(cu))
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(d, "libk1.so")
        procs[name] = (subprocess.Popen(
            [_kernels._nvcc(), *_kernels._FLAGS, f"-I{_kernels._CSRC}",
             "-o", lib, cu],
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
    """K1's C entry point in lib, called as the wrapper calls it."""
    import torch
    from svision_tpu_torch.ops import _kernels
    from svision_tpu_torch.ops.rasterize import CANVAS
    fn = ctypes.CDLL(lib).svt_render_raster
    fn.argtypes = _kernels.ENTRIES["svt_render_raster"][1]
    fn.restype = ctypes.c_int

    def call(ep, vis, rev, dtype):
        out = torch.empty((ep.shape[0], CANVAS, CANVAS, 3), dtype=dtype,
                          device=ep.device)
        err = fn(ep.data_ptr(), vis.data_ptr(), rev.data_ptr(),
                 out.data_ptr(), ep.shape[0], ep.shape[1],
                 int(dtype == torch.bfloat16), _kernels.stream_of(ep))
        assert err == 0, f"{lib}: CUDA error {err}"
        return out
    return call


def inputs(n: int, segs: int):
    """K1's inputs at batch n: chip_smoke's random specs with its DEGENERATE
    ones, their first segment alone at S = 1, fit_device's fragments
    (train.fragment_endpoints_torch) at S = 4 and their first three at 3."""
    import numpy as np
    import torch
    import chip_smoke
    from svision_tpu_torch.models import train
    from svision_tpu_torch.ops import rasterize
    dev = torch.device("cuda")
    specs = np.concatenate([
        chip_smoke.random_specs(n - len(chip_smoke.DEGENERATE), seed=1),
        np.array(chip_smoke.DEGENERATE, np.int64)])
    seg = tuple(torch.from_numpy(a).to(dev)
                for a in rasterize.specs_to_endpoints(specs))
    if segs > 2:
        seg = train.fragment_endpoints_torch(
            *seg, torch.Generator(device=dev).manual_seed(1), split_prob=0.5)
    return tuple(t[:, :segs].contiguous() for t in seg)


def measure(calls: dict, batches, seg_counts) -> list:
    """Each variant checked and timed in turns at every batch, segment
    count and dtype, with a torch zero_ of the output's bytes beside them
    (a write of the same bytes with nothing computed)."""
    import torch
    import chip_smoke
    from svision_tpu_torch.ops import rasterize
    rows = []
    for n in batches:
        for segs in seg_counts:
            seg = inputs(n, segs)
            for dt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                want = rasterize.render_raster(*seg, dtype=dt)
                for name, call in calls.items():
                    assert torch.equal(call(*seg, dt), want), \
                        f"variant {name} {kind} S={segs} N={n} disagrees"
                bound, by = chip_smoke.k1_least(seg, want, kind)
                timed = dict(calls, **{"context: torch zero_ of the output":
                                       lambda *_, w=want: w.zero_()})
                t = {name: [] for name in timed}
                for name in list(timed) + list(timed)[::-1]:
                    t[name].append(chip_smoke.time_ms(
                        lambda f=timed[name]: f(*seg, dt)))
                for name in timed:
                    ms = sum(t[name]) / 2
                    rows.append(dict(
                        variant=name, dtype=kind, segs=segs, batch=n, ms=ms,
                        turns_ms=t[name], bound_ms=bound, bound_by=by,
                        bound_fraction=bound / ms))
                    print(json.dumps(rows[-1]), flush=True)
                del want
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke

    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    built = build(VARIANTS, os.path.join(ROOT, "build", "k1_variants"))
    calls = {name: caller(lib) for name, (lib, _) in built.items()}
    rows = measure(calls, (chip_smoke.B, 2 * chip_smoke.B), (2, 4))
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
