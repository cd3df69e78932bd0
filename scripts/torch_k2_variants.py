"""Time K2 (svision_tpu_torch/csrc/pool_lrn.cu), or its backward
(csrc/pool_lrn_backward.cu), against other builds of it, in turns, on one
CUDA GPU.

Run from the repository root on the machine with the card:

    python3 scripts/torch_k2_variants.py [--out FILE]
        [--source-only] [--backward [--batch 64] [--parent DIR]]

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

--backward builds pool_lrn_backward.cu instead, with the ring path's
kConsumerWarps, kMaxSlots, kMaxBlocksPerSm and kV (channels a thread)
replaced (BACKWARD_VARIANTS).
--parent DIR adds the checkout DIR's pool_lrn_backward.cu as the variant
'parent' (its wrapper summed the kernel's per-row bias partials with
torch: 'parent + bias sum' times that too). Copies of the shipped source
and of the parent's with one part of the work cut (DIAGNOSTICS, wrong
outputs on purpose: not checked) split their times. At both tails and in
both dtypes, at --batch, each checked variant must equal the plain version (dx within
1e-5 of its largest entry in f32, 1e-2 in bf16; the shipped design's db
likewise); its time is the mean of 20 back-to-back launches with the queue
held (chip_smoke.time_ms) of the C entry point, in the order A B ... B A
and averaged, beside the package's wrapper and the plain version. Every
variant's ptxas register and spill lines are printed and kept.
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
# the same for pool_lrn_backward.cu (never built under k2_variants.cu)
BACKWARD_VARIANTS = {
    "15 warps, 6 slots, 1 block/SM": (False, {}, ()),
    "13 warps": (False, {"kConsumerWarps": 13}, ()),
    "11 warps": (False, {"kConsumerWarps": 11}, ()),
    "8 slots": (False, {"kMaxSlots": 8}, ()),
    "4 channels a thread, 23 warps": (False, {"kV": 4, "kConsumerWarps": 23},
                                      ()),
    "7 warps, 2 blocks/SM": (False, {"kConsumerWarps": 7,
                                     "kMaxBlocksPerSm": 2}, ()),
    "4 slots": (False, {"kMaxSlots": 4}, ()),
    "3 slots": (False, {"kMaxSlots": 3}, ()),
}
# copies of pool_lrn_backward.cu, the shipped one ("shipped") or the
# parent's, with one part of the work cut: {name: (source, {line:
# replacement})}. Their outputs are wrong on purpose and not checked.
DIAGNOSTICS = {
    "diagnostic: without the gather": ("shipped", {
        "    if (j >= row0 && tid < active) {\n":
        "    if (false) {\n"}),
    "diagnostic: without dp (p stored)": ("shipped", {
        "    store_dp(D, plane, at, d);\n":
        "    store_dp(D, plane, at, p);\n"}),
    "diagnostic: one tap, not the maxima": ("shipped", {
        "      window_max(r, wo, C, c0, b, p, arg);\n":
        "      load_vec(r[1] + (2 * wo + 1) * C + c0, p);\n"
        "      for (int i = 0; i < kV; ++i) arg[i] = 4;\n"}),
    "diagnostic: parent without row ho-1": ("parent", {
        "  for (int slot = ho > 0 ? 0 : 1; slot < 2; ++slot) {\n":
        "  for (int slot = 1; slot < 2; ++slot) {\n"}),
    "diagnostic: parent without the mask's read of x": ("parent", {
        "    load_vec(x + at, xv);\n":
        "    for (int i = 0; i < kV; ++i) xv[i] = 1.f;\n"}),
}


def build(variants: dict, build_dir: str, source: str = "pool_lrn.cu",
          parent: str = None, diagnostics: dict = None) -> dict:
    """{name: (library, ptxas report by kernel)}, every nvcc started
    together. A variant is (under k2_variants.cu, constants replaced, -D
    flags); with parent, a checkout, also 'parent', built from its source;
    and the diagnostics (of the shipped source, or of the parent's)."""
    diagnostics = diagnostics or {}
    import chip_smoke
    from svision_tpu_torch.ops import _kernels
    with open(os.path.join(_kernels._CSRC, source)) as f:
        src = f.read()
    texts = {}
    for name, (alt, consts, defines) in variants.items():
        text = src
        for const, val in consts.items():
            text, k = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {val};", text)
            assert k == 1, f"{const} not found once in {source}"
        texts[name] = (text, ALT if alt else None, defines, _kernels._CSRC)
    origins = {"shipped": (src, _kernels._CSRC)}
    if parent:
        pdir = os.path.join(parent, "svision_tpu_torch", "csrc")
        with open(os.path.join(pdir, source)) as f:
            origins["parent"] = (f.read(), pdir)
        texts["parent"] = (origins["parent"][0], None, (), pdir)
    for name, (origin, edits) in diagnostics.items():
        text, inc = origins[origin]
        for line, repl in edits.items():
            assert text.count(line) == 1, f"{name}: {line!r} moved"
            text = text.replace(line, repl)
        texts[name] = (text, None, (), inc)
    procs = {}
    for i, (name, (text, alt, defines, inc)) in enumerate(texts.items()):
        d = os.path.join(build_dir, str(i))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, source), "w") as f:
            f.write(text)
        cu = alt or os.path.join(d, source)
        lib = os.path.join(d, "libk2.so")
        procs[name] = (subprocess.Popen(
            [_kernels._nvcc(), *_kernels._FLAGS, f"-I{d}", f"-I{inc}",
             *defines, "-o", lib, cu],
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
    it: (dx, db)."""
    import torch
    from svision_tpu_torch.ops import _kernels
    fn = ctypes.CDLL(lib).svt_bias_relu_pool_lrn_backward
    fn.argtypes = _kernels.ENTRIES["svt_bias_relu_pool_lrn_backward"][1]
    fn.restype = ctypes.c_int

    def call(x, b, dy):
        n, h, w, c = x.shape
        dx, db = torch.empty_like(x), torch.empty_like(b)
        scratch = torch.empty(n * dy.shape[1] * c + 4, device=x.device)
        err = fn(x.data_ptr(), b.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 db.data_ptr(), scratch.data_ptr(), n, h, w, c,
                 int(x.dtype == torch.bfloat16),
                 int(b.dtype == torch.bfloat16), _kernels.stream_of(x))
        assert err == 0, f"{lib}: CUDA error {err}"
        return dx, db
    return call


def entry_arity(source: str) -> int:
    """Parameters of the backward's C entry point in a source's text."""
    head = source.split("svt_bias_relu_pool_lrn_backward(", 1)[1]
    return head.split(")", 1)[0].count(",") + 1


def parent_caller(lib: str, with_sum: bool):
    """The C entry point in lib of a parent whose kernel wrote
    per-output-row bias partials (12 parameters): (dx, partials), or
    with_sum (dx, db) summed as its wrapper did."""
    import torch
    from svision_tpu_torch.ops import _kernels
    fn = ctypes.CDLL(lib).svt_bias_relu_pool_lrn_backward
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    fn.restype = ctypes.c_int

    def call(x, b, dy):
        n, h, w, c = x.shape
        dx = torch.empty_like(x)
        part = torch.empty((n * dy.shape[1], c), device=x.device)
        err = fn(x.data_ptr(), b.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), n, h, w, c, int(x.dtype == torch.bfloat16),
                 int(b.dtype == torch.bfloat16), _kernels.stream_of(x))
        assert err == 0, f"{lib}: CUDA error {err}"
        return (dx, part.sum(0).to(b.dtype)) if with_sum else (dx, part)
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
        bias_relu_pool_lrn_backward as wrapper,
        bias_relu_pool_lrn_backward_plain as plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    timed = dict(calls, wrapper=wrapper)
    rows = []
    for h, c, tail in ((55, 96, "conv1"), (27, 256, "conv2")):
        ho = (h - 3) // 2 + 1
        x32 = torch.randn((batch, h, h, c), generator=gen, device=dev) * 2
        b32 = torch.randn((c,), generator=gen, device=dev)
        dy32 = torch.randn((batch, ho, ho, c), generator=gen, device=dev)
        for dt, kind, tol in ((torch.bfloat16, "bf16", 1e-2),
                              (torch.float32, "f32", 1e-5)):
            x, b, dy = x32.to(dt), b32.to(dt), dy32.to(dt)
            want, want_db = plain(x, b, dy)
            bound, by = chip_smoke.least(*chip_smoke.stage(
                "bias_relu_pool_lrn_backward", kind, batch, tail))
            checks = {}
            for name, call in timed.items():
                if name.startswith("diagnostic"):
                    continue
                got, db = call(x, b, dy)
                err = (got.float() - want.float()).abs().max().item()
                assert err <= tol * want.float().abs().max().item(), \
                    f"variant {name} {tail} {kind}: {err}"
                if db.shape == want_db.shape:
                    db_err = (db.float() - want_db.float()).abs().max().item()
                    assert db_err <= tol * want_db.float().abs().max().item(), \
                        f"variant {name} {tail} {kind}: db {db_err}"
                checks[name] = dict(max_abs_err=err,
                                    bit_equal=bool(torch.equal(got, want)))
            t = {name: [] for name in timed}
            for name in list(timed) + list(timed)[::-1]:
                t[name].append(chip_smoke.time_ms(lambda: timed[name](x, b, dy)))
            plain_ms = chip_smoke.time_ms(lambda: plain(x, b, dy), reps=5)
            for name in timed:
                ms = sum(t[name]) / 2
                rows.append(dict(variant=name, tail=tail, dtype=kind,
                                 batch=batch, ms=ms, turns_ms=t[name],
                                 bound_ms=bound, bound_by=by,
                                 bound_fraction=bound / ms, plain_ms=plain_ms,
                                 **checks.get(name, {})))
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
    ap.add_argument("--parent", help="with --backward: a checkout whose "
                    "pool_lrn_backward.cu is timed as the variant 'parent'")
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
    parent = os.path.abspath(args.parent) if args.parent else None
    diagnostics = {}
    if args.backward and not args.source_only:
        diagnostics = {name: d for name, d in DIAGNOSTICS.items()
                       if d[0] == "shipped" or parent}
    built = build(variants, os.path.join(ROOT, "build", build_dir), source,
                  parent if args.backward else None, diagnostics)
    ptxas = {name: report for name, (_, report) in built.items()}
    print(json.dumps(ptxas, indent=1), flush=True)
    calls = {name: bind(lib) for name, (lib, _) in built.items()
             if name in variants or diagnostics.get(name, ("",))[0] == "shipped"}
    if args.backward and parent:
        with open(os.path.join(parent, "svision_tpu_torch", "csrc",
                               source)) as f:
            old_abi = entry_arity(f.read()) == 12
        for name, (lib, _) in built.items():
            if name == "parent" or diagnostics.get(name, ("",))[0] == "parent":
                calls[name] = (parent_caller(lib, with_sum=False) if old_abi
                               else backward_caller(lib))
        if old_abi:
            calls["parent + bias sum"] = parent_caller(built["parent"][0],
                                                       with_sum=True)
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
