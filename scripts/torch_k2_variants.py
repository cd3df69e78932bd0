"""Time K2 (svision_tpu_torch/csrc/pool_lrn.cu), or its backward
(csrc/pool_lrn_backward.cu), against other builds of it, in turns, on one
CUDA GPU.

Run from the repository root on the machine with the card:

    python3 scripts/torch_k2_variants.py [--out FILE]
        [--source-only] [--backward [--batch 64]]

A variant is a copy of pool_lrn.cu with some of kConsumerWarps, kMaxSlots
and kMaxBlocksPerSm replaced, built as it is or under scripts/k2_variants.cu
(other ways to feed the same consumer code: a ring filled with 16-byte
cp.async, or no staging at all) with that file's -D flags. Every variant is
built by nvcc, all at once, into build/k2_variants/ (the backward's into
build/k2_backward_variants/). At both tails and in both dtypes (batch 128)
each must be bit-equal (bf16) or within 1e-5 relative (f32) to the plain
version. Its time is the cold-L2 median of 50
single launches (chip_smoke.spread_ms), taken in the order A B ... B A and
averaged. --source-only times the shipped source alone.

--backward builds pool_lrn_backward.cu instead, with kMinBlocks (the
blocks an SM must hold, which caps a thread's registers) replaced
(BACKWARD_VARIANTS). At both tails and in both dtypes, at --batch, each
must equal the plain version (dx within 1e-5 of its largest entry in f32,
1e-2 in bf16); its time is the mean of 20 back-to-back launches with the
queue held (chip_smoke.time_ms) of the C entry point alone (no
bias-gradient sum), in the order A B ... B A and averaged, the plain
version's beside it. Every variant's ptxas register and spill lines are
printed and kept.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALT = os.path.join(ROOT, "scripts", "k2_variants.cu")
# name: (built under k2_variants.cu, pool_lrn.cu's constants replaced,
# -D flags)
VARIANTS = {
    "ring": (False, {}, ()),
    "cp.async, depth 2, 2 blocks/SM": (
        True, {}, ("-DK2_CP_ASYNC", "-DK2_DEPTH=2", "-DK2_BLOCKS=2")),
    "cp.async, depth 2, 2 blocks/SM, 12 warps": (
        True, {"kConsumerWarps": 12},
        ("-DK2_CP_ASYNC", "-DK2_DEPTH=2", "-DK2_BLOCKS=2")),
    "direct, 8 warps": (True, {}, ("-DK2_DIRECT", "-DK2_BLOCKS=8")),
    "direct, 4 warps": (True, {"kConsumerWarps": 4},
                        ("-DK2_DIRECT", "-DK2_BLOCKS=16")),
}
# the same for pool_lrn_backward.cu
BACKWARD_VARIANTS = {
    "2 blocks/SM": (False, {}, ()),
    "3 blocks/SM": (False, {"kMinBlocks": 3}, ()),
    "4 blocks/SM": (False, {"kMinBlocks": 4}, ()),
}


def build(variants: dict, build_dir: str, source: str = "pool_lrn.cu") -> dict:
    """{name: (library, ptxas report by kernel)}, every nvcc started
    together."""
    import chip_smoke
    from svision_tpu_torch.ops import _kernels
    with open(os.path.join(_kernels._CSRC, source)) as f:
        src = f.read()
    procs = {}
    for i, (name, (alt, consts, defines)) in enumerate(variants.items()):
        d = os.path.join(build_dir, str(i))
        os.makedirs(d, exist_ok=True)
        text = src
        for const, val in consts.items():
            text, k = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {val};", text)
            assert k == 1, f"{const} not found once in {source}"
        with open(os.path.join(d, source), "w") as f:
            f.write(text)
        cu = ALT if alt else os.path.join(d, source)
        lib = os.path.join(d, "libk2.so")
        procs[name] = (subprocess.Popen(
            [_kernels._nvcc(), *_kernels._FLAGS, f"-I{d}", *defines,
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
    """K2's C entry point in lib, called as the wrapper calls it."""
    import torch
    from svision_tpu_torch.ops import _kernels
    fn = ctypes.CDLL(lib).svt_bias_relu_pool_lrn
    fn.argtypes = _kernels.ENTRIES["svt_bias_relu_pool_lrn"][1]
    fn.restype = ctypes.c_int

    def call(x, b):
        n, h, w, c = x.shape
        out = torch.empty((n, (h - 3) // 2 + 1, (w - 3) // 2 + 1, c),
                          dtype=x.dtype, device=x.device)
        err = fn(x.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c,
                 int(x.dtype == torch.bfloat16), int(b.dtype == torch.bfloat16),
                 _kernels.stream_of(x))
        assert err == 0, f"{lib}: CUDA error {err}"
        return out
    return call


def backward_caller(lib: str):
    """The backward's C entry point in lib, called as the wrapper calls
    it: (dx, per-row bias partials)."""
    import torch
    from svision_tpu_torch.ops import _kernels
    fn = ctypes.CDLL(lib).svt_bias_relu_pool_lrn_backward
    fn.argtypes = _kernels.ENTRIES["svt_bias_relu_pool_lrn_backward"][1]
    fn.restype = ctypes.c_int

    def call(x, b, dy):
        n, h, w, c = x.shape
        dx = torch.empty_like(x)
        part = torch.empty((n * dy.shape[1], c), device=x.device)
        err = fn(x.data_ptr(), b.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), n, h, w, c, int(x.dtype == torch.bfloat16),
                 int(b.dtype == torch.bfloat16), _kernels.stream_of(x))
        assert err == 0, f"{lib}: CUDA error {err}"
        return dx, part
    return call


def measure_forward(calls: dict) -> list:
    import torch
    import chip_smoke
    from svision_tpu_torch.ops.fused_pool_lrn import bias_relu_pool_lrn_plain
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for h, c, tail in ((55, 96, "conv1"), (27, 256, "conv2")):
        x32 = torch.randn((chip_smoke.B, h, h, c), generator=gen, device=dev) * 2
        bias32 = torch.randn((c,), generator=gen, device=dev)
        for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x, bias = x32.to(dt), bias32.to(dt)
            want = bias_relu_pool_lrn_plain(x, bias).float()
            for name, call in calls.items():
                got = call(x, bias).float()
                ok = (torch.equal(got, want) if kind == "bf16" else
                      bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-6).all()))
                assert ok, f"variant {name} {tail} {kind} disagrees"
            xs = [x] + [x.clone() for _ in range(3)]
            med = {name: [] for name in calls}
            for name in list(calls) + list(calls)[::-1]:
                med[name].append(chip_smoke.spread_ms(
                    [lambda xi=xi, f=calls[name]: f(xi, bias) for xi in xs])["median"])
            for name in calls:
                rows.append(dict(variant=name, tail=tail, dtype=kind,
                                 cold_median_ms=sum(med[name]) / 2,
                                 turns_ms=med[name]))
                print(json.dumps(rows[-1]), flush=True)
            del xs
    return rows


def measure_backward(calls: dict, batch: int) -> list:
    import torch
    import chip_smoke
    from svision_tpu_torch.ops.fused_pool_lrn import (
        bias_relu_pool_lrn_backward_plain as plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for h, c, tail in ((55, 96, "conv1"), (27, 256, "conv2")):
        ho = (h - 3) // 2 + 1
        x32 = torch.randn((batch, h, h, c), generator=gen, device=dev) * 2
        b32 = torch.randn((c,), generator=gen, device=dev)
        dy32 = torch.randn((batch, ho, ho, c), generator=gen, device=dev)
        for dt, kind, tol in ((torch.bfloat16, "bf16", 1e-2),
                              (torch.float32, "f32", 1e-5)):
            x, b, dy = x32.to(dt), b32.to(dt), dy32.to(dt)
            want, _ = plain(x, b, dy)
            for name, call in calls.items():
                got, _ = call(x, b, dy)
                err = (got.float() - want.float()).abs().max().item()
                assert err <= tol * want.float().abs().max().item(), \
                    f"variant {name} {tail} {kind}: {err}"
            t = {name: [] for name in calls}
            for name in list(calls) + list(calls)[::-1]:
                t[name].append(chip_smoke.time_ms(lambda: calls[name](x, b, dy)))
            plain_ms = chip_smoke.time_ms(lambda: plain(x, b, dy), reps=5)
            for name in calls:
                rows.append(dict(variant=name, tail=tail, dtype=kind,
                                 batch=batch, ms=sum(t[name]) / 2,
                                 turns_ms=t[name], plain_ms=plain_ms))
                print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--source-only", action="store_true",
                    help="only the shipped source")
    ap.add_argument("--backward", action="store_true",
                    help="the backward kernel's variants")
    ap.add_argument("--batch", type=int, default=64,
                    help="the backward's batch")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke

    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    if args.backward:
        variants, source = BACKWARD_VARIANTS, "pool_lrn_backward.cu"
        build_dir, bind = "k2_backward_variants", backward_caller
    else:
        variants, source = VARIANTS, "pool_lrn.cu"
        build_dir, bind = "k2_variants", caller
    if args.source_only:
        name = next(iter(variants))
        variants = {name: variants[name]}
    built = build(variants, os.path.join(ROOT, "build", build_dir), source)
    ptxas = {name: report for name, (_, report) in built.items()}
    print(json.dumps(ptxas, indent=1), flush=True)
    calls = {name: bind(lib) for name, (lib, _) in built.items()}
    rows = (measure_backward(calls, args.batch) if args.backward
            else measure_forward(calls))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(nvidia_smi=smi, variants=rows, ptxas=ptxas), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
