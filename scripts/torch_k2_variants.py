"""Time K2 (svision_tpu_torch/csrc/pool_lrn.cu) against other builds of it,
in turns, on one CUDA GPU.

Run from the repository root on the machine with the card:

    python3 scripts/torch_k2_variants.py [--out FILE]
        [--source-only]

A variant is a copy of pool_lrn.cu with some of kConsumerWarps, kMaxSlots
and kMaxBlocksPerSm replaced, built as it is or under scripts/k2_variants.cu
(other ways to feed the same consumer code: a ring filled with 16-byte
cp.async, or no staging at all) with that file's -D flags. Every variant is
built by nvcc, all at once, into build/k2_variants/. At both tails and in
both dtypes (batch 128) each must be bit-equal (bf16) or within 1e-5
relative (f32) to the plain version. Its time is the cold-L2 median of 50
single launches (chip_smoke.spread_ms), taken in the order A B ... B A and
averaged. --source-only times the shipped source alone.
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


def build(variants: dict, build_dir: str) -> dict:
    """{name: library}, every nvcc started together."""
    from svision_tpu_torch.ops import _kernels
    with open(os.path.join(_kernels._CSRC, "pool_lrn.cu")) as f:
        src = f.read()
    procs = {}
    for i, (name, (alt, consts, defines)) in enumerate(variants.items()):
        d = os.path.join(build_dir, str(i))
        os.makedirs(d, exist_ok=True)
        text = src
        for const, val in consts.items():
            text, k = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {val};", text)
            assert k == 1, f"{const} not found once in pool_lrn.cu"
        with open(os.path.join(d, "pool_lrn.cu"), "w") as f:
            f.write(text)
        cu = ALT if alt else os.path.join(d, "pool_lrn.cu")
        lib = os.path.join(d, "libk2.so")
        procs[name] = (subprocess.Popen(
            [_kernels._nvcc(), *_kernels._FLAGS, f"-I{d}", *defines,
             "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        assert proc.returncode == 0, f"variant {name} did not build:\n{out}"
        libs[name] = lib
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--source-only", action="store_true",
                    help="only the shipped source")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from svision_tpu_torch.ops.fused_pool_lrn import bias_relu_pool_lrn_plain

    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    variants = {"ring": VARIANTS["ring"]} if args.source_only else VARIANTS
    calls = {name: caller(lib) for name, lib in build(
        variants, os.path.join(ROOT, "build", "k2_variants")).items()}
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(nvidia_smi=smi, variants=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
