"""On-GPU smoke test of the PyTorch/CUDA port (svision_tpu_torch).

Run from the repository root on a machine with one CUDA GPU (sm_90a, the
CUDA toolkit's nvcc on PATH or under /usr/local/cuda):

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit on any check:
  1. build the hand-written kernels from svision_tpu_torch/csrc/ with nvcc
     (and K3 without its dark-step skip, as a yardstick), check that the
     bf16 K3 runs on tensor cores (HGMMA in its SASS), and build the native
     BAM decoder the CLI reads with;
  2. hold each kernel against its plain PyTorch version on the card, at the
     engine's batch of 128 and in both dtypes, and time both; K1 also on
     fit_device's fragmented four segments an image, and checked at
     batches of 1 and 129 and on an all-dark batch; K3 also on an all-dark
     batch, bf16 at batches of 1, 129 and 8,192, f32 at 1, 129 and 4,096
     and on a densely lit batch, with the route K3 f32 replaced in the
     card's exact step (K1's images, then conv1 through cuDNN) timed
     beside it;
     K2's backward kernel at the training batch of 64 and at 1 and 129,
     both tails, both dtypes, on random and on tie-heavy inputs, and a
     CUDA graph of it replayed against its eager call; the endpoints
     kernel bit for bit against its plain version and the host's numpy
     at a batch and at a chunk of the engine's batches, timed beside the
     host's numpy;
  3. run the InferenceEngine in both numeric modes: its CUDA graphs bit for
     bit against its eager step at 1, 128, 129, 17 x 128 + 5, chunk + 20
     batches and 8,192 specs, images/s graphed and eager, and 8,192 specs
     against an all-plain engine built and captured with its kernels
     swapped for their plain versions; the exact step's two routes (the
     engine's, K3 in f32 into the folded network, and K1's images into
     the unfolded one) against the CPU exact engine on those specs; then
     profile one call in each mode,
     graphed and eager (device time by kernel, idle share);
  4. drive the CLI path (svision_tpu_torch.cli.run_pipeline) on a
     synthetic genome + BAM with seeded random weights, in the default bf16
     mode and with --exact, counting kernel launches in each run, and hold
     the --exact VCF against the same run on the CPU; then each optional
     mode of CLI_MODES (-c, --qname, -t 2, --graph, --graph on complex
     events, --hash, --mechanism, --cluster, --contig, --resume twice) with
     --exact on the card and on the CPU, every VCF of the two output trees
     equal outside QUAL (QUAL within +/-15) and every other file byte for
     byte, and once in the default mode on the card;
 4b. install a copy of the tree offline (pip install --no-deps
     --no-build-isolation --no-index --prefix) into a scratch prefix and
     run the installed svision-tpu-torch command on the card, in the
     default mode and with --exact, from outside the checkout with the
     prefix's site-packages alone on PYTHONPATH and an empty HOME: its
     kernels build cold from the installed sources into
     ~/.cache/svision-tpu/kernels (nothing under site-packages or in the
     checkout's build/kernels), and each VCF equals phase 4's of its mode
     byte for byte;
  5. serve: a warm default-mode server (svision_tpu_torch.serve) in this
     process answers three concurrent socket clients, two requests each, on
     phase 4's sample and a two-chromosome one; every VCF must equal a
     standalone CLI run's byte for byte, and every request's launches must
     be launches per batch x batches; then `python -m
     svision_tpu_torch.serve` answers one request over stdin;
  6. shard the two-chromosome sample: 2 shards + --merge_shards in this
     process, two --coordinator processes with disjoint out dirs, and a
     two-sample cohort in 2 shard processes, each VCF byte-equal to its
     1-shard run (and --mesh 2 where two GPUs are visible);
  7. train (svision_tpu_torch.models.train): one f32 step on the card
     against the same step on the CPU; a graphed step against the eager
     step from the same state (fit's and fit_device's), and replays that
     draw new dropout masks; eight bf16 steps with a falling loss; training
     images/s of fit and fit_device (graphed), the image path with
     fragmented segments too, every trainer's step holding 2 K2 launches
     and 2 of its backward a step (a 2 x 2 DP x TP grid: on each cell);
     the bf16 s2d fit_device step profiled, graphed and eager (K2's share
     by kernel name); the DP x TP step in f64 against one device (over
     the visible GPUs, or a 2 x 2 grid of one GPU's replicas); the DP x TP
     step's CUDA graphs against eager twins, with new dropout masks, the
     host's calls a step and fit(mesh=)'s launches, on one GPU's replicas
     and on four GPUs where visible; and a mini closed loop
     (build_dataset, fit_device, evaluate) whose weights go through phase
     4's CLI;
  8. run the engine's other modes (raster='compare', 'einsum' and 'pallas'
     in bf16 and int8, and the unfolded bf16 network, fast=False) on phase
     3's 8,192 specs: each mode's graph replays bit for bit against its
     eager step, its launches per batch x batches, against an all-plain
     engine, the three rasters of one network against each other bit for
     bit, each mode against phase 3's engines, images/s graphed and eager,
     and the graph memory; then profile the 'pallas' engines;
  9. run the port's tools: scripts/torch_e2e_bench.py at 1 x 1 Mb (its VCF
     truvari-scored against itself, f1 1.0), scripts/torch_roofline.py
     at batch 128 (the default step, then the exact step by its two routes
     with --exact), the graft entry's fused step (__graft_entry_torch__)
     against its CPU run (at the bf16 bar on the bar's weights; on its
     default weights the f32 network on both, and the card's bf16 within
     the CPU's own bf16-to-f32 departure), and dryrun_multichip(1);
 10. V-MoE-B/16 at its published widths (the benchmark's configuration and
     fitted weights): the four MoE kernels (route, dispatch, bias-GELU,
     combine) against their plain versions at the engine's batch of 128
     on skewed routing with an empty expert and on even routing, timed
     against their bounds and beside a PyTorch call each; then the engine
     on those weights, its launch counts zeroed: graphs bit for bit
     against the eager step on 8,192 specs, launches per batch x batches,
     every routed row in the experts' histogram, images/s graphed.
Launches count kernels executed: a graph replay adds the launches its
capture held (svision_tpu_torch/graphs.py), and every run of phases 3-8
and 10 holds them to launches per batch or step x the batches or steps run, and
the endpoints kernel's per dispatch x the dispatches run (in phase 9, the
engine's runs; the others' are counted).
Then it prints one {"kernels": [...]} line, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}.
`--report PATH` also writes the full report (every variant, the profile) as
JSON to PATH.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from svision_tpu_torch.timing import (  # noqa: E402
    held_queue, nvidia_smi, random_specs, time_ms)

B = 128                      # the engine's batch
# back-to-back calls of a plain version of K1 or K3, which launches tens of
# ops a call: 20 calls of them outlast the device sleep of held_queue
PLAIN_REPS = 5
# the benchmark's configuration whose `model` the kernels' work is counted
# on, and its names of this file's dtypes
CONFIG = "svision-alexnet-bf16"
PRECISION = {"bf16": "bfloat16", "f32": "float32"}
REPORT = {}
# phase 3's engine outputs on its 8,192 specs, by mode, for phase 8
PREDS = {}


def log(msg: str) -> None:
    print(msg, flush=True)


DEGENERATE = [
    [0, 0, 5, 6, 1, 10, 10, 10, 11, 1, 227, 227],     # two points
    [3, 3, 0, 227, 1, 0, 200, 7, 8, 1, 227, 227],     # vert + horiz
    [0, 226, 0, 227, 1, 226, 0, 0, 227, 0, 227, 227],  # diagonals fwd/rev
    [0, 300, 200, 500, 1, 0, 5, 0, 6, 1, 300, 500],   # clipped
    [0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2],             # sentinel pad row
]


def spread_ms(fns, reps: int = 50) -> dict:
    """min / median / max device time in ms of reps single launches, each
    between its own pair of CUDA events, the queue held. Launch i calls
    fns[i % len(fns)]: one function reads warm caches, several on distinct
    buffers that together exceed the 50 MB L2 read a cold one."""
    import statistics
    import torch
    for f in fns:
        f()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    with held_queue() as info:
        for i, (a, b) in enumerate(ev):
            a.record()
            fns[i % len(fns)]()
            b.record()
    t = [a.elapsed_time(b) for a, b in ev]
    return dict(min=min(t), median=statistics.median(t), max=max(t),
                host_us_per_launch=info["host_ms"] / reps * 1e3)


def host_clock_ms(fn, reps: int = 10) -> float:
    """Mean host-clock ms per call over reps calls run back to back,
    synchronized at both ends, after two warm-up calls: for work bound by
    its host dispatch, such as a training step (several hundred launches),
    which a held queue cannot time: its launches fill the queue behind the
    sleep, and the host blocks."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def best_rate(eng, specs, calls: int = 3) -> float:
    """Images/s of a warmed-up engine on specs: the best of `calls` timed
    predict_specs calls (host clock)."""
    best = 0.0
    for _ in range(calls):
        t0 = time.perf_counter()
        eng.predict_specs(specs)
        best = max(best, specs.shape[0] / (time.perf_counter() - t0))
    return best


def bench_model() -> dict:
    """The network's widths as the benchmark counts them: the `model` of
    its configuration CONFIG (benchmark/configs)."""
    from benchmark import spec
    return spec.config(spec.load(), CONFIG)["model"]


def stage(kernel: str, kind: str, rows: int, tail: str = None,
          lit_macs: int = 0):
    """((bytes, FLOPs), the peak they are read against) of one launch of a
    kernel on rows images, as benchmark/work.py counts them: K1
    (render_raster, two segments an image), K2 (bias_relu_pool_lrn) and its
    backward after `tail`, K3 (conv1_fused_raster) with lit_macs, conv1's
    multiply-accumulates over the images' lit pixels (lit_macs())."""
    from benchmark import work
    m, dtype = bench_model(), PRECISION[kind]
    if kernel == "render_raster":
        return work.k1_stage(m, rows, dtype), "float32"
    if kernel == "bias_relu_pool_lrn":
        return work.k2_stage(m, rows, tail, dtype), "float32"
    if kernel == "bias_relu_pool_lrn_backward":
        return work.k2_backward_stage(m, rows, tail, dtype), "float32"
    return work.k3_stage(m, rows, dtype, lit_macs), dtype


def least(work_of, peak: str):
    """(least time in ms, what bounds it) of (bytes, FLOPs) on this card:
    benchmark/work.py's least_s, the bytes over the memory rate against the
    FLOPs over peaks.json's peak of `peak` ('bfloat16' tensor cores,
    'float32' CUDA cores)."""
    import torch
    from benchmark import work
    nbytes, flops = work_of
    card = torch.cuda.get_device_name()
    s = work.least_s(nbytes, flops, card, peak)
    by_bytes = s == work.least_s(nbytes, 0, card, peak)
    return s * 1e3, "bytes" if by_bytes else "operations"


def k1_least(seg, raster, kind: str):
    """least() of one K1 launch on the endpoints seg into raster: the
    benchmark's count at two segments an image; at other counts, which
    it has none of, the bytes of these tensors."""
    if seg[0].shape[1] == 2:
        return least(*stage("render_raster", kind, seg[0].shape[0]))
    return least((sum(t.nbytes for t in (*seg, raster)), 0), "float32")


def lit_macs(ep, vis, rev) -> int:
    """conv1's multiply-accumulates over the lit pixels of these images:
    benchmark/work.py's conv1_lit_macs of their plain raster, in blocks of
    1,024 images."""
    from benchmark import work
    from svision_tpu_torch.ops import rasterize
    m = bench_model()
    return sum(work.conv1_lit_macs(rasterize.render_raster(
        ep[i:i + 1024], vis[i:i + 1024], rev[i:i + 1024]), m)
        for i in range(0, ep.shape[0], 1024))


# ---------------------------------------------------------------------------
# phase 1: builds
# ---------------------------------------------------------------------------

K3_SKIP_LINE = "        if (!((steps >> s) & 1)) continue;\n"


def start_dense_k3_build(build_dir: str):
    """Start nvcc on a copy of csrc/conv1_raster.cu without the line that
    skips dark K steps: the same kernel multiplying every K step, the
    yardstick for that skip. Returns (process, library path)."""
    from svision_tpu_torch.ops import _kernels
    with open(os.path.join(_kernels._CSRC, "conv1_raster.cu")) as f:
        src = f.read()
    assert src.count(K3_SKIP_LINE) == 1, "K3's dark-step skip line moved"
    os.makedirs(build_dir, exist_ok=True)
    for name in _kernels._HEADERS:
        with open(os.path.join(_kernels._CSRC, name)) as f, \
                open(os.path.join(build_dir, name), "w") as g:
            g.write(f.read())
    cu = os.path.join(build_dir, "conv1_raster_dense.cu")
    with open(cu, "w") as f:
        f.write(src.replace(K3_SKIP_LINE, ""))
    lib = os.path.join(build_dir, "libconv1_raster_dense.so")
    proc = subprocess.Popen([_kernels._nvcc(), *_kernels._FLAGS, "-o", lib, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, lib


def ptxas_by_kernel(log_path: str) -> dict:
    """{kernel: [register line, spill line]} from a ptxas -v log."""
    out, name = {}, None
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name and ("registers" in line or "spill" in line):
                out.setdefault(name, []).append(line.strip())
    return out


def hgmma_count(lib: str) -> int:
    """HGMMA (wgmma) instructions in a library's SASS, from cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    return sum(" HGMMA." in l for l in sass.splitlines())


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel of the engine's path for its plain PyTorch version
    (they then run on the card as torch ops), and the trainers' K2 and its
    backward for autograd through K2's plain version. A CUDA graph
    captured before the swap still holds the kernels: build and capture an
    engine or a step inside."""
    from svision_tpu_torch.infer import engine
    from svision_tpu_torch.models import alexnet, int8, train
    from svision_tpu_torch.ops import (endpoints, fused_conv1, fused_pool_lrn,
                                       rasterize)
    saved = (engine.conv1_fused_raster, engine.render_images,
             engine.render_raster_kernel, engine.specs_endpoints,
             alexnet.bias_relu_pool_lrn, int8.bias_relu_pool_lrn,
             train.bias_relu_pool_lrn_autograd)
    engine.conv1_fused_raster = fused_conv1.conv1_fused_raster_plain
    engine.specs_endpoints = endpoints.specs_endpoints_plain
    engine.render_images = rasterize.render_images
    engine.render_raster_kernel = rasterize.render_raster
    alexnet.bias_relu_pool_lrn = fused_pool_lrn.bias_relu_pool_lrn_plain
    int8.bias_relu_pool_lrn = fused_pool_lrn.bias_relu_pool_lrn_plain
    train.bias_relu_pool_lrn_autograd = fused_pool_lrn.bias_relu_pool_lrn_plain
    try:
        yield
    finally:
        (engine.conv1_fused_raster, engine.render_images,
         engine.render_raster_kernel, engine.specs_endpoints,
         alexnet.bias_relu_pool_lrn, int8.bias_relu_pool_lrn,
         train.bias_relu_pool_lrn_autograd) = saved


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at B=128
# ---------------------------------------------------------------------------

def k3_from(lib: str):
    """K3's C entry point in another build of csrc/conv1_raster.cu, called
    like the wrapper (bf16 only)."""
    import ctypes
    import torch
    from svision_tpu_torch.ops import _kernels
    fn = ctypes.CDLL(lib).svt_conv1_fused_raster
    fn.argtypes = _kernels.ENTRIES["svt_conv1_fused_raster"][1]
    fn.restype = ctypes.c_int

    def call(ep, vis, rev, w):
        out = torch.empty((ep.shape[0], 55, 55, 96), dtype=w.dtype,
                          device=ep.device)
        err = fn(ep.data_ptr(), vis.data_ptr(), rev.data_ptr(), w.data_ptr(),
                 out.data_ptr(), ep.shape[0], 1, _kernels.stream_of(ep))
        assert err == 0, f"{lib}: launch failed with CUDA error {err}"
        return out
    return call


def fragments(ep, vis, rev):
    """fit_device's fragmented four segments an image from two
    (train.fragment_endpoints_torch, seeded)."""
    import torch
    from svision_tpu_torch.models import train
    return train.fragment_endpoints_torch(
        ep, vis, rev, torch.Generator(device=ep.device).manual_seed(1),
        split_prob=0.5)


def check_k1(seg, dt, kind: str, what: str):
    """K1 against the plain raster, bit for bit: (raster, max abs error)."""
    import torch
    from svision_tpu_torch.ops import raster_kernel, rasterize
    got = raster_kernel.render_raster(*seg, dtype=dt)
    want = rasterize.render_raster(*seg, dtype=dt)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, want), \
        f"K1 {kind} S={seg[0].shape[1]} {what}: raster differs ({err})"
    return got, err


def check_kernels(params, dense_k3) -> dict:
    import torch
    import torch.nn.functional as F
    from svision_tpu_torch.infer.engine import exact_f32
    from svision_tpu_torch.models.alexnet import fold_conv1_params
    from svision_tpu_torch.ops import fused_conv1, rasterize
    from svision_tpu_torch.ops import raster_kernel

    dev = torch.device("cuda")
    specs = np.concatenate([random_specs(B - len(DEGENERATE), seed=1),
                            np.array(DEGENERATE, np.int64)])
    ep, vis, rev = (torch.from_numpy(a).to(dev)
                    for a in rasterize.specs_to_endpoints(specs))
    out = {}

    # K1: bit-exact in both dtypes, on the candidates' two segments and on
    # fit_device's fragmented four (train.fragment_endpoints_torch), timed
    # at B; then at batches 1 and 129 (image bases at other 16-byte
    # phases, a ragged grid) and on an all-dark batch, checked only
    variants = []
    for seg in ((ep, vis, rev), fragments(ep, vis, rev)):
        for dt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            got, err = check_k1(seg, dt, kind, "B=128")
            segs = seg[0].shape[1]
            b, by = k1_least(seg, got, kind)
            ms = time_ms(lambda: raster_kernel.render_raster(*seg, dtype=dt))
            variants.append(dict(
                dtype=kind, segs=segs, batch=B, shape=list(got.shape),
                max_abs_err=err, ms=ms,
                plain_ms=time_ms(lambda: rasterize.render_raster(*seg, dtype=dt),
                                 reps=PLAIN_REPS),
                bound_ms=b, bound_by=by, bound_fraction=b / ms))
            log(f"K1 render_raster {kind} S={segs}: bit-exact, {variants[-1]}")
    for n in (1, 129):
        specs = random_specs(n, seed=4)
        k = min(n, len(DEGENERATE))
        specs[:k] = np.array(DEGENERATE, np.int64)[:k]
        two = tuple(torch.from_numpy(a).to(dev)
                    for a in rasterize.specs_to_endpoints(specs))
        for seg in (two, fragments(*two)):
            for dt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                _, err = check_k1(seg, dt, kind, f"B={n}")
                variants.append(dict(dtype=kind, segs=seg[0].shape[1],
                                     batch=n, max_abs_err=err))
    for seg in ((ep, torch.zeros_like(vis), rev),
                fragments(ep, torch.zeros_like(vis), rev)):
        for dt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            got, err = check_k1(seg, dt, kind, "all-dark")
            assert got.count_nonzero().item() == 0, f"K1 {kind}: all-dark != 0"
            variants.append(dict(dtype=kind, segs=seg[0].shape[1], batch=B,
                                 case="all-dark", max_abs_err=err))
    log("K1 render_raster: bit-exact at B=1 and 129 and all-dark, S=2 and 4")
    out["render_raster"] = variants

    out["bias_relu_pool_lrn"] = check_pool_lrn()
    out["bias_relu_pool_lrn_backward"] = check_pool_lrn_backward()
    out["specs_endpoints"] = check_endpoints()

    # K3: f32 within 1e-4 of max|out|, bf16 within 1e-2 of max|out|
    w32 = torch.from_numpy(fold_conv1_params(params)["conv1/weights"]).to(dev)
    lit = rasterize.render_raster_s2d(ep, vis, rev, dtype=torch.float32)
    macs = lit_macs(ep, vis, rev)
    variants = []
    for dt, kind, tol in ((torch.bfloat16, "bf16", 1e-2),
                          (torch.float32, "f32", 1e-4)):
        w = w32.to(dt).contiguous()
        with exact_f32():
            got = fused_conv1.conv1_fused_raster(ep, vis, rev, w)
            want = fused_conv1.conv1_fused_raster_plain(ep, vis, rev, w)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            assert err <= tol * scale, f"K3 {kind}: {err} > {tol} * {scale}"
            dark = fused_conv1.conv1_fused_raster(
                torch.zeros_like(ep), torch.zeros_like(vis), rev, w)
            assert dark.count_nonzero().item() == 0, f"K3 {kind}: all-dark != 0"
            # the work this run's data needs: the lit pixels' only (the
            # raster is built on chip, so dark pixels need no work); the
            # dense implicit GEMM, [N*55*55, 432] x [432, 96], is kept as
            # context
            (moved, flops), peak = stage("conv1_fused_raster", kind, B,
                                         lit_macs=macs)
            b, by = least((moved, flops), peak)
            dense_b = least((moved, 2.0 * got.numel() * 432), peak)[0]
            raster = rasterize.render_raster_s2d(ep, vis, rev, dtype=dt)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            r_nchw = raster.permute(0, 3, 1, 2)
            variants.append(dict(
                dtype=kind, shape=list(got.shape), max_abs_err=err,
                max_abs_out=scale,
                ms=time_ms(lambda: fused_conv1.conv1_fused_raster(ep, vis, rev, w)),
                plain_ms=time_ms(lambda: fused_conv1.conv1_fused_raster_plain(ep, vis, rev, w),
                                 reps=PLAIN_REPS),
                bound_ms=b, bound_by=by, dense_gemm_bound_ms=dense_b,
                lit_fraction=lit.count_nonzero().item() / lit.numel(),
                cudnn_conv2d_on_s2d_raster_ms=time_ms(
                    lambda: F.conv2d(r_nchw, w_oihw))))
            if kind == "f32":
                variants[-1].update(k3_f32_checks(params, (ep, vis, rev), w))
        if kind == "bf16":
            variants[-1].update(k3_bf16_checks(dense_k3, (ep, vis, rev), w,
                                               lit, got))
        log(f"K3 conv1_fused_raster {kind}: ok, {variants[-1]}")
    out["conv1_fused_raster"] = variants
    return out


def check_endpoints() -> list:
    """The endpoints kernel at a batch and at a chunk of the engine's
    batches (random specs, the degenerate ones first): bit for bit against
    its plain version on the card and against the host's numpy
    (rasterize.specs_to_endpoints), timed against the bytes it moves (the
    benchmark counts no such stage), beside its plain version and the
    host's numpy on the host clock, the work it took off the host."""
    import torch
    from svision_tpu_torch.infer.engine import CHUNK
    from svision_tpu_torch.ops import endpoints, rasterize
    variants = []
    for n in (CHUNK * B, B):         # the main path's chunk a card first
        specs = random_specs(n, seed=5)
        specs[:len(DEGENERATE)] = np.array(DEGENERATE, np.int64)
        x = torch.from_numpy(specs).cuda()
        got = endpoints.specs_endpoints(x)
        plain = endpoints.specs_endpoints_plain(x)
        host = rasterize.specs_to_endpoints(specs)
        torch.cuda.synchronize()
        for g, p, h in zip(got, plain, host):
            assert torch.equal(g, p) and np.array_equal(g.cpu().numpy(), h), \
                f"endpoints at {n} rows differ from the plain version"
        b, by = least((sum(t.nbytes for t in (x, *got)), 0), "float32")
        ms = time_ms(lambda: endpoints.specs_endpoints(x))
        t0 = time.perf_counter()
        for _ in range(20):
            rasterize.specs_to_endpoints(specs)
        variants.append(dict(
            dtype="int64", rows=n, shape=list(x.shape), max_abs_err=0, ms=ms,
            plain_ms=time_ms(lambda: endpoints.specs_endpoints_plain(x),
                             reps=PLAIN_REPS),
            host_numpy_ms=(time.perf_counter() - t0) / 20 * 1e3,
            bound_ms=b, bound_by=by, bound_fraction=b / ms))
        log(f"specs_endpoints at {n} rows: bit-exact, {variants[-1]}")
    return variants


def check_pool_lrn(cold_buffers: int = 4) -> list:
    """K2 at both tails and in both dtypes, B=128: f32 within 1e-5
    relative and bf16 within one bf16 ulp of the plain version. Times: the
    mean of back-to-back launches (ms), and the spread of single launches
    with warm caches (one input) and with a cold L2 (cold_buffers inputs
    in turn). A torch copy_ that moves the kernel's byte count (half read,
    half written), timed cold the same way, is context for the memory rate
    reached; nothing on the port's path calls it. Then the split form the
    bf16 network takes at each tail (models/alexnet.py: conv1's writes two
    channel halves, conv2's reads two): bit-equal to the joined launch,
    timed the same way, against the same bound."""
    import torch
    from svision_tpu_torch.ops import fused_pool_lrn
    dev = torch.device("cuda")
    k2, plain = (fused_pool_lrn.bias_relu_pool_lrn,
                 fused_pool_lrn.bias_relu_pool_lrn_plain)
    gen = torch.Generator(device=dev).manual_seed(2)
    variants = []
    for h, c, tail in ((55, 96, "conv1"), (27, 256, "conv2")):
        x32 = torch.randn((B, h, h, c), generator=gen, device=dev) * 2
        bias32 = torch.randn((c,), generator=gen, device=dev)
        for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x, bias = x32.to(dt), bias32.to(dt)
            got = k2(x, bias)
            want = plain(x, bias)
            torch.cuda.synchronize()
            g, w = got.float(), want.float()
            err = (g - w).abs().max().item()
            if kind == "f32":
                ok = ((g - w).abs() <= 1e-5 * w.abs() + 1e-6).all().item()
            else:
                ulp = torch.pow(2.0, torch.floor(torch.log2(
                    w.abs().clamp_min(2.0 ** -126))) - 7)
                ok = ((g - w).abs() <= ulp).all().item()
            assert ok, f"K2 {tail} {kind}: max abs err {err}"
            (moved, flops), peak = stage("bias_relu_pool_lrn", kind, B, tail)
            b, by = least((moved, flops), peak)
            xs = [x] + [x.clone() for _ in range(cold_buffers - 1)]
            src = [torch.empty(moved // 2, dtype=torch.uint8, device=dev)
                   for _ in range(cold_buffers)]
            dst = torch.empty_like(src[0])
            variants.append(dict(
                tail=tail, dtype=kind, shape=list(x.shape), max_abs_err=err,
                bit_equal=bool(torch.equal(got, want)),
                ms=time_ms(lambda: k2(x, bias)),
                warm_ms=spread_ms([lambda: k2(x, bias)]),
                cold_ms=spread_ms([lambda xi=xi: k2(xi, bias) for xi in xs]),
                plain_ms=time_ms(lambda: plain(x, bias)),
                bound_ms=b, bound_by=by, bytes_moved=moved,
                context_copy_cold_ms=spread_ms(
                    [lambda s=s: dst.copy_(s) for s in src])))
            log(f"K2 bias_relu_pool_lrn {tail} {kind}: ok, {variants[-1]}")
            del xs, src, dst
            if tail == "conv1":
                form, ins, halves = "halves_out", [x] * cold_buffers, True
            else:
                form, halves = "halves_in", False
                ins = [tuple(t.contiguous() for t in xi.chunk(2, dim=-1))
                       for xi in [x] + [x.clone()
                                        for _ in range(cold_buffers - 1)]]
            split = k2(ins[0], bias, out_halves=halves)
            torch.cuda.synchronize()
            assert torch.equal(torch.cat(split, dim=-1) if halves else split,
                               got), f"K2 {tail} {kind} {form}: not bit-equal"
            variants.append(dict(
                tail=tail, dtype=kind, form=form, shape=list(x.shape),
                bit_equal_to_joined=True, max_abs_err=err,
                ms=time_ms(lambda: k2(ins[0], bias, out_halves=halves)),
                warm_ms=spread_ms([lambda: k2(ins[0], bias,
                                              out_halves=halves)]),
                cold_ms=spread_ms([lambda xi=xi: k2(xi, bias,
                                                    out_halves=halves)
                                   for xi in ins]),
                bound_ms=b, bound_by=by, bytes_moved=moved))
            log(f"K2 bias_relu_pool_lrn {tail} {kind} {form}: ok, "
                f"{variants[-1]}")
            del ins, split
    return variants


def tie_heavy(x):
    """x with the ties of a raster's blank regions: the top half one
    constant, and in the rest the first third of the columns a copy of the
    second (repeated patches)."""
    h, w = x.shape[1:3]
    x = x.clone()
    x[:, : h // 2] = 0.5
    x[:, h // 2:, : w // 3] = x[:, h // 2:, w // 3: 2 * (w // 3)]
    return x


def check_pool_lrn_backward() -> list:
    """K2's backward kernel at both tails and in both dtypes, at the
    training batch TRAIN_B and at 1 and 129 (runs that start mid-image and
    cross images), on random inputs and on tie_heavy ones: dx against the
    plain version, f32 within 1e-5 of the largest entry with the same
    positions receiving a gradient, bf16 within 1e-2; the bias gradient
    (summed in the kernel) within 1e-5 (f32) / 1e-2 (bf16) of its largest
    entry; whether dx is bit-equal. At TRAIN_B on random inputs: the
    wrapper's time and the plain version's, each the mean of back-to-back
    launches, the queue held, and a CUDA graph of the wrapper replayed
    twice, equal to the eager call bit for bit. The bound counts x, the
    bias and dy read once and dx and the bias gradient written once. No
    single PyTorch call computes this function (library_ms null)."""
    import torch
    from svision_tpu_torch.ops import fused_pool_lrn
    dev = torch.device("cuda")
    k, plain = (fused_pool_lrn.bias_relu_pool_lrn_backward,
                fused_pool_lrn.bias_relu_pool_lrn_backward_plain)
    gen = torch.Generator(device=dev).manual_seed(5)
    variants = []
    for h, c, tail in ((55, 96, "conv1"), (27, 256, "conv2")):
        ho = (h - 3) // 2 + 1
        for n in (TRAIN_B, 1, 129):
            x32 = torch.randn((n, h, h, c), generator=gen, device=dev) * 2
            b32 = torch.randn((c,), generator=gen, device=dev)
            dy32 = torch.randn((n, ho, ho, c), generator=gen, device=dev)
            for case, xc in (("random", x32), ("ties", tie_heavy(x32))):
                for dt, kind, tol in ((torch.bfloat16, "bf16", 1e-2),
                                      (torch.float32, "f32", 1e-5)):
                    x, b, dy = xc.to(dt), b32.to(dt), dy32.to(dt)
                    dx, db = k(x, b, dy)
                    want_dx, want_db = plain(x, b, dy)
                    torch.cuda.synchronize()
                    err = (dx.float() - want_dx.float()).abs().max().item()
                    scale = want_dx.float().abs().max().item()
                    db_err = (db.float() - want_db.float()).abs().max().item()
                    db_scale = want_db.float().abs().max().item()
                    same = bool(torch.equal(dx != 0, want_dx != 0))
                    where = f"K2 backward {tail} {kind} {case} B={n}"
                    assert err <= tol * scale, f"{where}: dx {err} > {tol} * {scale}"
                    assert db_err <= tol * db_scale, f"{where}: db {db_err}"
                    assert same or kind == "bf16", f"{where}: other positions"
                    v = dict(tail=tail, dtype=kind, case=case, batch=n,
                             shape=list(x.shape), max_abs_err=err,
                             max_abs_dx=scale, db_max_abs_err=db_err,
                             same_positions=same,
                             bit_equal=bool(torch.equal(dx, want_dx)))
                    if case == "random" and n == TRAIN_B:
                        v.update(backward_timing(k, plain, x, b, dy, dx, db,
                                                 kind, tail))
                    variants.append(v)
                    log(f"{where} ({REPORT['device']['nvidia_smi']}): ok, {v}")
    return variants


def backward_timing(k, plain, x, b, dy, dx, db, kind, tail) -> dict:
    """The backward's wrapper and plain times and bound at one input (of
    dtype kind, after tail), and a CUDA graph of the wrapper replayed twice
    against its eager (dx, db)."""
    import torch
    (moved, flops), peak = stage("bias_relu_pool_lrn_backward", kind,
                                 x.shape[0], tail)
    bnd, by = least((moved, flops), peak)
    ms = time_ms(lambda: k(x, b, dy))
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k(x, b, dy)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        gdx, gdb = k(x, b, dy)
    replays = []
    for _ in range(2):
        gdx.zero_()
        gdb.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(bool(torch.equal(gdx, dx) and torch.equal(gdb, db)))
    assert all(replays), f"K2 backward graph replays {replays} != eager"
    del graph
    return dict(ms=ms, plain_ms=time_ms(lambda: plain(x, b, dy),
                                        reps=PLAIN_REPS),
                bound_ms=bnd, bound_by=by, bound_fraction=bnd / ms,
                bytes_moved=moved, library_ms=None,
                graph_replays_bit_equal=replays)


def k3_bf16_checks(dense_k3, seg, w, lit, got) -> dict:
    """K3 bf16 beyond batch 128: other batch sizes against the plain
    version (the ragged split over the SMs and a partial last wave), the
    share of K steps that hold a lit value, and the kernel timed in turns
    against its copy without the dark-step skip (which must agree bit for
    bit)."""
    import torch
    from svision_tpu_torch.ops import fused_conv1, rasterize
    dev = w.device
    out = {}
    # a K step is one image channel at one tap over an 8 x 8 output tile
    n = lit.shape[0]
    pad = torch.zeros((n, 58, 58, 48), device=dev)
    pad[:, :57, :57] = lit
    lit_steps = sum((pad[:, dr:dr + 56, dc:dc + 56]
                     .reshape(n, 7, 8, 7, 8, 3, 16).amax(dim=(2, 4, 6)) > 0)
                    .sum().item() for dr in range(3) for dc in range(3))
    out["lit_kstep_fraction"] = lit_steps / (n * 49 * 27)

    dense = dense_k3(*seg, w)
    torch.cuda.synchronize()
    assert torch.equal(dense, got), "K3 bf16: the dense copy disagrees"
    t = [time_ms(lambda: f(*seg, w)) for f in
         (fused_conv1.conv1_fused_raster, dense_k3, dense_k3,
          fused_conv1.conv1_fused_raster)]
    out.update(ms_in_turns=(t[0] + t[3]) / 2, dense_ms=(t[1] + t[2]) / 2)

    batches = []
    for b in (1, 129, 8192):
        specs = random_specs(b, seed=5)
        k = min(b, len(DEGENERATE))
        specs[:k] = np.array(DEGENERATE, np.int64)[:k]
        ep, vis, rev = (torch.from_numpy(a).to(dev)
                        for a in rasterize.specs_to_endpoints(specs))
        y = fused_conv1.conv1_fused_raster(ep, vis, rev, w)
        err = scale = 0.0
        for i in range(0, b, 1024):       # the plain version in chunks
            want = fused_conv1.conv1_fused_raster_plain(
                ep[i:i + 1024], vis[i:i + 1024], rev[i:i + 1024], w).float()
            err = max(err, (y[i:i + 1024].float() - want).abs().max().item())
            scale = max(scale, want.abs().max().item())
        assert err <= 1e-2 * scale, f"K3 bf16 B={b}: {err} > 1e-2 * {scale}"
        batches.append(dict(
            batch=b, max_abs_err=err, max_abs_out=scale,
            ms=time_ms(lambda: fused_conv1.conv1_fused_raster(ep, vis, rev, w),
                       reps=5 if b > B else 20)))
        del y
    out["batches"] = batches
    return out


def k3_f32_checks(params, seg, w) -> dict:
    """K3 f32 beyond batch 128, under exact_f32(): batches of 1, 129 and
    4,096 (the striped items' ragged split over the SMs) and a densely lit
    batch (timing.diagonal_specs: 3-4x the lit terms of random specs),
    each within 1e-4 of the plain version's largest output, the dense one
    and 4,096 timed; and the route K3 f32 replaced in the card's exact
    step, timed: K1's f32 images, then conv1 11x11/4 through cuDNN as
    AlexNet.forward runs it (NCHW weights on channels_last input, with
    cuDNN's layout conversions), no bias."""
    import torch
    from svision_tpu_torch.models.alexnet import AlexNet
    from svision_tpu_torch.ops import fused_conv1, rasterize
    from svision_tpu_torch.ops.raster_kernel import render_images
    from svision_tpu_torch.timing import diagonal_specs
    dev = w.device
    model = AlexNet.from_params(params, device=dev)
    out = dict(k1_cudnn_route_ms=time_ms(lambda: model._conv(
        model.conv1, render_images(*seg).permute(0, 3, 1, 2), bias=False)))
    batches = []
    for b, case in ((1, "random"), (129, "random"), (4096, "random"),
                    (B, "dense")):
        if case == "dense":
            specs = diagonal_specs(b, seed=0)
        else:
            specs = random_specs(b, seed=5)
            k = min(b, len(DEGENERATE))
            specs[:k] = np.array(DEGENERATE, np.int64)[:k]
        ep, vis, rev = (torch.from_numpy(a).to(dev)
                        for a in rasterize.specs_to_endpoints(specs))
        y = fused_conv1.conv1_fused_raster(ep, vis, rev, w)
        err = scale = 0.0
        for i in range(0, ep.shape[0], 1024):   # the plain version in chunks
            want = fused_conv1.conv1_fused_raster_plain(
                ep[i:i + 1024], vis[i:i + 1024], rev[i:i + 1024], w)
            err = max(err, (y[i:i + 1024] - want).abs().max().item())
            scale = max(scale, want.abs().max().item())
        assert err <= 1e-4 * scale, \
            f"K3 f32 B={b} {case}: {err} > 1e-4 * {scale}"
        batches.append(dict(batch=b, case=case, max_abs_err=err,
                            max_abs_out=scale))
        if b >= B:
            batches[-1]["ms"] = time_ms(
                lambda: fused_conv1.conv1_fused_raster(ep, vis, rev, w),
                reps=5 if b > B else 20)
            batches[-1]["bound_ms"] = least(*stage(
                "conv1_fused_raster", "f32", b,
                lit_macs=lit_macs(ep, vis, rev)))[0]
        del y
    out["batches"] = batches
    return out


# ---------------------------------------------------------------------------
# phase 3: the engine against an all-plain engine
# ---------------------------------------------------------------------------

def eager_rate(eng, specs, calls: int = 3) -> float:
    """best_rate of the engine's eager step on the card, the reference its
    graphs are held to."""
    import types
    import torch

    def predict(x):
        with torch.inference_mode():
            return eng._predict(x, graphed=False)
    return best_rate(types.SimpleNamespace(predict_specs=predict), specs,
                     calls)


def check_engine(params) -> dict:
    """Phase 3, in both modes: the warm-up's captures (time, memory), K2's
    inputs on the engine's path, graph replays bit-equal to the eager step
    at n = 1, 128, 129, a short tail (17 x 128 + 5), a long one (chunk +
    20 batches) and 8,192, images/s graphed and eager, and the engine
    against an all-plain engine, which is built and captured inside
    plain_kernels() so its graphs hold the plain versions."""
    import torch
    from svision_tpu_torch.infer.engine import InferenceEngine

    from svision_tpu_torch.models import alexnet

    specs = random_specs(8192, seed=3)
    out = {}
    for mode, bf16 in (("bf16", True), ("exact", False)):
        eng = InferenceEngine(params, batch_size=B, bf16=bf16)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        # the graphs' private pools stay reserved through empty_cache
        torch.cuda.empty_cache()
        graph_bytes = torch.cuda.memory_reserved() - reserved
        # K2 copies nothing: both of its inputs on the engine's path (conv1's
        # and conv2's outputs, NHWC; conv2's two halves on the split route)
        # must already be contiguous
        k2, seen = alexnet.bias_relu_pool_lrn, []

        def recording(x, b, out_halves=False):
            xs = x if isinstance(x, tuple) else (x,)
            seen.append(([tuple(t.shape) for t in xs],
                         all(t.is_contiguous() for t in xs)))
            return k2(x, b, out_halves=out_halves)
        alexnet.bias_relu_pool_lrn = recording
        try:
            with torch.inference_mode():
                eng._predict(specs[:B], graphed=False)
        finally:
            alexnet.bias_relu_pool_lrn = k2
        assert len(seen) == 2 and all(c for _, c in seen), \
            f"{mode} engine: K2 inputs (shape, contiguous) {seen}"
        sizes = (1, B, B + 1, 17 * B + 5, (eng.chunk + 20) * B, 8192)
        with counted() as run:
            for n in sizes:
                x = random_specs(n, seed=n)
                gp, gs = eng.predict_specs(x)
                with torch.inference_mode():
                    ep, es = eng._predict(x, graphed=False)
                assert np.array_equal(gp, ep) and np.array_equal(gs, es), \
                    f"{mode} engine: graphs differ from the eager step at n={n}"
        hold_launches(f"engine {mode}", "default" if bf16 else "exact", run,
                      warmups=0)
        p, s = eng.predict_specs(specs)
        PREDS[mode] = (p, s)
        best = best_rate(eng, specs)
        eager = eager_rate(eng, specs)
        plan = dict(chunk=eng.chunk, tail=eng.tail)
        del eng
        torch.cuda.empty_cache()
        with plain_kernels():
            plain = InferenceEngine(params, batch_size=B, bf16=bf16)
            plain.warmup()
            pp, ps = plain.predict_specs(specs)
            t0 = time.perf_counter()
            plain.predict_specs(specs)
            plain_rate = specs.shape[0] / (time.perf_counter() - t0)
            del plain
        agree = float((p == pp).mean())
        soft_err = float(np.abs(s - ps).max())
        if bf16:
            assert agree >= 0.99, f"bf16 engine: argmax agreement {agree}"
        else:
            assert agree == 1.0, f"exact engine: argmax agreement {agree}"
            assert soft_err <= 1e-4, f"exact engine: softmax err {soft_err}"
            out["exact_routes"] = exact_routes(params, specs, p, s)
        assert np.isfinite(s).all() and ((s > 0) & (s <= 1)).all()
        out[mode] = dict(images_per_s=best, eager_images_per_s=eager,
                         plain_images_per_s=plain_rate,
                         **plan, warmup_s=warmup_s,
                         graph_reserved_bytes=graph_bytes,
                         graphs_equal_eager_at=list(sizes),
                         launches=run["launches"], batches=run["batches"],
                         k2_inputs_contiguous=seen,
                         argmax_agreement=agree, max_softmax_err=soft_err,
                         n=int(specs.shape[0]), batch=B)
        log(f"engine {mode} ({REPORT['device']['nvidia_smi']}): {out[mode]}")
        torch.cuda.empty_cache()
    return out


def exact_routes(params, specs, p, s) -> dict:
    """The exact step's two routes on the card against the CPU exact engine
    (the JAX engine's unfolded form) on the same specs: the engine's (the
    fused route, K3 in f32 into the folded network; its outputs p, s) and
    K1 and cuDNN (K1's f32 images into the unfolded f32 network), run
    eagerly batch by batch under exact_f32(). Both must agree on every
    argmax; each route's softmax departure from the CPU is recorded beside
    them."""
    import torch
    from svision_tpu_torch.infer.engine import InferenceEngine, exact_f32
    from svision_tpu_torch.models.alexnet import AlexNet
    from svision_tpu_torch.ops import rasterize
    from svision_tpu_torch.ops.raster_kernel import render_images
    t0 = time.perf_counter()
    cpu = InferenceEngine(params, batch_size=B, bf16=False, device="cpu")
    cp, cs = cpu.predict_specs(specs)
    cpu_s = time.perf_counter() - t0
    model = AlexNet.from_params(params, device="cuda")
    ep, vis, rev = (torch.from_numpy(a).cuda()
                    for a in rasterize.specs_to_endpoints(specs))
    kp, ks = [], []
    with torch.inference_mode(), exact_f32():
        for i in range(0, specs.shape[0], B):
            logits = model(render_images(ep[i:i + B], vis[i:i + B],
                                         rev[i:i + B], dtype=torch.float32))
            kp.append(logits.argmax(dim=1))
            ks.append(torch.softmax(logits, dim=1).amax(dim=1))
    kp, ks = torch.cat(kp).cpu().numpy(), torch.cat(ks).cpu().numpy()
    out = dict(cpu_s=cpu_s, n=int(specs.shape[0]),
               engine_vs_cpu=agreement(p, s, cp, cs),
               k1_cudnn_vs_cpu=agreement(kp, ks, cp, cs),
               k1_cudnn_vs_engine=agreement(kp, ks, p, s))
    for route, soft in (("engine", s), ("k1_cudnn", ks)):
        d = np.abs(soft - cs)
        out[f"{route}_vs_cpu"]["specs_over_1e-5"] = int((d > 1e-5).sum())
    log(f"exact routes against the CPU exact engine: {out}")
    assert out["engine_vs_cpu"]["argmax_agreement"] == 1.0, out
    assert out["k1_cudnn_vs_cpu"]["argmax_agreement"] == 1.0, out
    return out


def profile_engine(params, modes=(("bf16", {}), ("exact", dict(bf16=False))),
                   eager: bool = True, n: int = 2048) -> dict:
    """Device time per batch, its ten longest operations, and the device's
    idle share, for one call of n specs in each mode (name, engine
    arguments), through the graphs (predict_specs; CUPTI traces the
    kernels inside a replay) and, with eager, through the eager step: the
    benchmark's trace (benchmark/devtrace.py), whose window runs from a
    synchronize to a synchronize and whose busy time is the union of the
    device's kernels, copies and sets. The profiler's own overhead widens
    the idle share."""
    import torch
    from benchmark import devtrace
    from svision_tpu_torch.infer.engine import InferenceEngine

    specs = random_specs(n, seed=4)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for mode, kw in modes:
        eng = InferenceEngine(params, batch_size=B, **kw)
        eng.warmup()
        for how, graphed in (("", True), ("_eager", False))[:1 + eager]:
            def call():
                with torch.inference_mode():
                    eng._predict(specs, graphed=graphed)
            call()
            trace = devtrace.profile(call, [dev])
            wall_ms, busy_ms = trace.window_s * 1e3, trace.busy_s * 1e3
            batches = n // B
            out[mode + how] = dict(
                wall_ms_per_batch=wall_ms / batches,
                device_ms_per_batch=busy_ms / batches,
                idle_share=trace.idle_pct() / 100,
                top_kernels_ms_per_batch={
                    k: v * 1e3 / batches
                    for k, v in trace.breakdown()["device_ops"]})
            log(f"profile {mode}{how}: {wall_ms / batches:.3f} ms/batch wall, "
                f"{busy_ms / batches:.3f} ms/batch on the device, idle share "
                f"{out[mode + how]['idle_share']:.3f}")
        del eng
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: the engine's other modes
# ---------------------------------------------------------------------------

def check_modes(params) -> dict:
    """Phase 8: each of MODES on phase 3's 8,192 specs. Its graph replays
    bit-equal to its eager step, launches per batch x batches, images/s
    graphed and eager, the memory its graphs keep, and an all-plain engine
    built and captured inside plain_kernels() (argmax agreement >= 0.99).
    Across modes: the three rasters of one network give the same bits;
    bf16 agrees with phase 3's s2d engine (K3, argmax >= 0.99), int8 with
    it at test_int8.py's bar (>= 0.9), the unfolded bf16 network and the
    s2d one with phase 3's exact engine (>= 0.95, the bf16 bar of
    tests/test_torch_engine.py)."""
    import torch
    from svision_tpu_torch.infer.engine import InferenceEngine

    specs = random_specs(8192, seed=3)
    out = {}
    for mode, (kw, k1) in MODES.items():
        t_mode = time.perf_counter()
        eng = InferenceEngine(params, batch_size=B, **kw)
        assert eng.raster == kw.get("raster", "compare" if eng.int8
                                    else "s2d"), (mode, eng.raster)
        assert eng.compute_dtype == (torch.int8 if "int8" in kw
                                     else torch.bfloat16), mode
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        graph_bytes = torch.cuda.memory_reserved() - reserved
        with counted() as run:
            p, s = eng.predict_specs(specs)
            with torch.inference_mode():
                ep, es = eng._predict(specs, graphed=False)
        assert np.array_equal(p, ep) and np.array_equal(s, es), \
            f"{mode} engine: graphs differ from the eager step"
        hold_launches(f"engine {mode}", mode, run, warmups=0)
        assert np.isfinite(s).all() and ((s > 0) & (s <= 1)).all(), mode
        rate = best_rate(eng, specs)
        eager = eager_rate(eng, specs, calls=2)
        del eng
        torch.cuda.empty_cache()
        with plain_kernels():
            plain = InferenceEngine(params, batch_size=B, **kw)
            plain.warmup()
            pp, ps = plain.predict_specs(specs)
            del plain
        torch.cuda.empty_cache()
        agree = float((p == pp).mean())
        assert agree >= 0.99, f"{mode} engine vs all-plain: argmax {agree}"
        PREDS[mode] = (p, s)
        out[mode] = dict(
            images_per_s=rate, eager_images_per_s=eager, warmup_s=warmup_s,
            graph_reserved_bytes=graph_bytes, launches=run["launches"],
            batches=run["batches"], k1_dtype=k1,
            plain_argmax_agreement=agree,
            plain_max_softmax_err=float(np.abs(s - ps).max()),
            plain_bit_equal=bool(np.array_equal(p, pp)
                                 and np.array_equal(s, ps)),
            seconds=time.perf_counter() - t_mode, n=int(specs.shape[0]),
            batch=B, **kw)
        log(f"engine {mode} ({REPORT['device']['nvidia_smi']}): {out[mode]}")

    for net in ("bf16", "int8"):
        first = PREDS[f"{net}_compare"]
        for kind in ("einsum", "pallas"):
            p, s = PREDS[f"{net}_{kind}"]
            assert np.array_equal(p, first[0]) and np.array_equal(s, first[1]), \
                f"{net}: the {kind} raster's outputs differ from compare's"
    # bf16 against f32 is held to tests/test_torch_engine.py's bf16 bar
    bars = (("bf16_compare", "bf16", 0.99), ("int8_compare", "bf16", 0.9),
            ("unfolded_bf16", "exact", 0.95), ("bf16", "exact", 0.95))
    agreement = {}
    for mode, ref, bar in bars:
        a = float((PREDS[mode][0] == PREDS[ref][0]).mean())
        agreement[f"{mode}_vs_{ref}"] = a
        assert a >= bar, f"{mode} vs phase 3's {ref} engine: argmax {a} < {bar}"
    out["agreement"] = agreement
    log(f"phase 8 agreement: {agreement}; compare, einsum and pallas "
        "bit-equal in bf16 and in int8")
    out["profile"] = profile_engine(
        params, modes=[(m, MODES[m][0]) for m in ("bf16_pallas",
                                                  "int8_pallas")],
        eager=False)
    return out


# ---------------------------------------------------------------------------
# phase 4: the CLI path
# ---------------------------------------------------------------------------

def _split_qual(line: str):
    f = line.rstrip("\n").split("\t")
    qual = float(f[5])
    f[5] = "QUAL"
    return "\t".join(f), qual


def _records(path: str):
    return [l for l in open(path) if not l.startswith("#") and l.strip()]


# launches per batch of each mode's device step, on each device of the
# engine; the endpoints kernel's are per dispatch (PER_DISPATCH)
# and K2's calls in a split form (the bf16 network's two a batch; a CPU
# engine counts them too, and the CPU runs here are exact)
PER_BATCH = {
    "default": {"render_raster": 0, "bias_relu_pool_lrn": 2,
                "bias_relu_pool_lrn_backward": 0, "conv1_fused_raster": 1,
                "specs_endpoints": 0, "bias_relu_pool_lrn_halves": 2},
    "exact": {"render_raster": 0, "bias_relu_pool_lrn": 2,
              "bias_relu_pool_lrn_backward": 0, "conv1_fused_raster": 1,
              "specs_endpoints": 0, "bias_relu_pool_lrn_halves": 0},
    "cpu": {"render_raster": 0, "bias_relu_pool_lrn": 0,
            "bias_relu_pool_lrn_backward": 0, "conv1_fused_raster": 0,
            "specs_endpoints": 0, "bias_relu_pool_lrn_halves": 0}}
# the V-MoE's kernel wrappers (ops/moe.py): no AlexNet step launches them
MOE_WRAPPERS = ("moe_route", "moe_dispatch", "moe_bias_gelu", "moe_combine")
for per_batch in PER_BATCH.values():
    per_batch.update(dict.fromkeys(MOE_WRAPPERS, 0))
# phase 8's modes: engine arguments, and K1's dtype where it runs
MODES = {
    "bf16_compare": (dict(raster="compare"), None),
    "bf16_einsum": (dict(raster="einsum"), None),
    "bf16_pallas": (dict(raster="pallas"), "bf16"),
    "int8_compare": (dict(int8=True), None),     # 's2d' becomes 'compare'
    "int8_einsum": (dict(int8=True, raster="einsum"), None),
    "int8_pallas": (dict(int8=True, raster="pallas"), "bf16"),
    "unfolded_bf16": (dict(fast=False), "f32"),
}
PER_BATCH.update({mode: {"render_raster": int(k1 is not None),
                         "bias_relu_pool_lrn": 2,
                         "bias_relu_pool_lrn_backward": 0,
                         "conv1_fused_raster": 0, "specs_endpoints": 0,
                         "bias_relu_pool_lrn_halves": 0 if "int8" in mode
                         else 2, **dict.fromkeys(MOE_WRAPPERS, 0)}
                  for mode, (_, k1) in MODES.items()})
# phase 10's V-MoE engine: K1 in bf16 and each MoE kernel once a sparse
# layer (6 in V-MoE-B/16) a batch
PER_BATCH["vmoe"] = {**dict.fromkeys(PER_BATCH["cpu"], 0), "render_raster": 1,
                     **dict.fromkeys(MOE_WRAPPERS, 6)}
# launches per dispatch of each mode, on each device of the engine: the
# endpoints of the dispatch's rows, at the head of the replica's step
PER_DISPATCH = {mode: {"specs_endpoints": int(mode != "cpu")}
                for mode in PER_BATCH}


def kernel_wrappers() -> dict:
    from svision_tpu_torch import graphs
    return {w.__name__: w for w in graphs.kernel_wrappers()}


def warmup_batches(cpu: bool = False) -> int:
    """The batches an engine's warmup() runs with the default plan: one
    eager sentinel batch, and on the card one replay of the single-batch
    graph and, under tail 'full', one of the full-chunk graph."""
    from svision_tpu_torch.infer import engine
    if cpu:
        return 1
    return 2 + (engine.CHUNK if engine.TAIL == "full" and engine.CHUNK > 1
                else 0)


@contextlib.contextmanager
def counted():
    """Count the block's kernel launches, every count set to 0 on entry,
    and the batches and dispatches the engine ran (each call's plan, graph
    replays and eager steps alike), those of a warm-up apart from the real
    ones. Yields a dict that holds "batches" and "dispatches" and gets
    "launches" and "wall_s" (host clock) on exit."""
    from svision_tpu_torch.infer.engine import InferenceEngine
    wrappers = kernel_wrappers()
    out = {"batches": {"warmup": 0, "real": 0},
           "dispatches": {"warmup": 0, "real": 0}}
    warming = threading.local()
    predict, warmup = InferenceEngine._predict, InferenceEngine.warmup

    def counting_predict(self, specs, graphed):
        kind = "warmup" if getattr(warming, "on", False) else "real"
        chunks, singles = self.plan(len(specs))
        out["batches"][kind] += sum(chunks) + singles
        out["dispatches"][kind] += len(chunks) + singles
        return predict(self, specs, graphed)

    def flagged_warmup(self):
        warming.on = True
        try:
            warmup(self)
        finally:
            warming.on = False

    InferenceEngine._predict = counting_predict
    InferenceEngine.warmup = flagged_warmup
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    try:
        yield out
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = {k: w.launches for k, w in wrappers.items()}
    finally:
        InferenceEngine._predict = predict
        InferenceEngine.warmup = warmup


def hold_launches(name: str, mode: str, run: dict, warmups: int,
                  devices: int = 1) -> None:
    """A run's launches equal (launches per batch x batches + launches per
    dispatch x dispatches) x devices, with `warmups` warm-up batches among
    the batches."""
    b, d = run["batches"], run["dispatches"]
    assert b["warmup"] == warmups and b["real"] >= 1, f"{name}: batches {b}"
    want = {k: (v * (b["warmup"] + b["real"])
                + PER_DISPATCH[mode].get(k, 0) * (d["warmup"] + d["real"]))
            * devices for k, v in PER_BATCH[mode].items()}
    assert run["launches"] == want, \
        f"{name}: launches {run['launches']} != {want}"


def mesh_devices(spec: str = "auto", device: str = "cuda") -> int:
    """The number of devices a --mesh flag gives the engine."""
    from svision_tpu_torch.parallel.mesh import resolve_mesh
    return len(resolve_mesh(spec, device) or (device,))


def make_fixtures(params, work: str) -> dict:
    """Seeded weights and four synthetic samples: phase 4's (chr1 150 kb,
    DEL/INS/INV), a two-chromosome one (chr1 150 kb and chr2 100 kb, one
    event on each) on a genome whose chr1 is phase 4's chr1, and the
    complex-event and contig samples of phase 4's optional modes (those of
    tests/test_torch_cli_modes.py)."""
    from svision_tpu_torch import sim
    from svision_tpu_torch.models.checkpoint import save_params
    fx = {k: os.path.join(work, f) for k, f in (
        ("genome", "ref.fa"), ("bam", "sample.bam"), ("weights", "w.npz"),
        ("genome2", "ref2.fa"), ("bam2", "two.bam"),
        ("genome_complex", "complex.fa"), ("bam_complex", "complex.bam"),
        ("genome_contig", "contig.fa"), ("bam_contig", "contig.bam"))}
    seqs = sim.make_genome(fx["genome"], {"chr1": 150000}, seed=7)
    sim.make_sv_bam(fx["bam"], seqs, seed=7, support=8,
                    events=[("DEL", "chr1", 20000, 300),
                            ("INS", "chr1", 60000, 220),
                            ("INV", "chr1", 100000, 400)])
    seqs2 = sim.make_genome(fx["genome2"], {"chr1": 150000, "chr2": 100000},
                            seed=7)
    assert seqs2["chr1"] == seqs["chr1"]
    sim.make_sv_bam(fx["bam2"], seqs2, seed=11, support=8,
                    events=[("DEL", "chr1", 40000, 300),
                            ("INS", "chr2", 50000, 220)])
    seqs = sim.make_genome(fx["genome_complex"], {"chr1": 200000}, seed=21)
    sim.make_sv_bam(fx["bam_complex"], seqs, seed=21, support=8,
                    events=[("INV+DEL", "chr1", 60000, 300),
                            ("DEL+INS", "chr1", 140000, 400)])
    # one DEL on two haplotype contigs: --contig's min_support 1 still needs
    # two signatures to pass the partition gate
    seqs = sim.make_genome(fx["genome_contig"], {"chr1": 120000}, seed=5)
    sim.make_sv_bam(fx["bam_contig"], seqs, seed=5, support=2,
                    events=[("DEL", "chr1", 40000, 400)])
    save_params(params, fx["weights"])
    return fx


# phase 4's optional modes: mode -> (sample, arguments, runs into one output
# directory), as in tests/test_torch_cli_modes.py
CLI_MODES = {
    "region": ("plain", ["-c", "chr1"], 1),
    "qname": ("plain", ["--qname"], 1),
    "threads": ("plain", ["-t", "2"], 1),
    "graph": ("plain", ["--graph"], 1),
    "graph_complex": ("complex", ["--graph"], 1),
    "hash": ("plain", ["--hash"], 1),
    "mechanism": ("plain", ["--mechanism"], 1),
    "cluster": ("plain", ["--cluster", "--qname"], 1),
    "contig": ("contig", ["--contig"], 1),
    "resume": ("plain", ["--resume"], 2),
}


# make_fixtures' samples: the keys of their BAM and genome, -n and -s
SAMPLES = {"plain": ("bam", "genome", "synthsample", "3"),
           "complex": ("bam_complex", "genome_complex", "csvsample", "3"),
           "contig": ("bam_contig", "genome_contig", "asm", "5")}


def vcf_qual_delta(got: str, want: str) -> float:
    """Hold a card's VCF to its CPU twin: headers and every non-QUAL byte
    equal, QUAL within +/-15. Returns the largest QUAL difference."""
    head_g = [l for l in open(got) if l.startswith("#")]
    head_w = [l for l in open(want) if l.startswith("#")]
    assert head_g == head_w, f"VCF headers differ: {got}, {want}"
    rg, rw = _records(got), _records(want)
    assert len(rg) == len(rw), (got, len(rg), len(rw))
    max_dq = 0.0
    for g, w in zip(rg, rw):
        gg, gq = _split_qual(g)
        ww, wq = _split_qual(w)
        assert gg == ww, f"non-QUAL fields differ:\n{w}{g}"
        assert abs(gq - wq) <= 15.0, f"QUAL beyond +/-15:\n{w}{g}"
        max_dq = max(max_dq, abs(gq - wq))
    return max_dq


def output_tree(outdir: str) -> dict:
    """relative path -> absolute path of every file and directory under a
    CLI output directory, the timestamped run logs left out."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(outdir):
        for f in dirnames + [f for f in filenames
                             if not (f.startswith("SVision_")
                                     and f.endswith(".log"))]:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, outdir)] = path
    return out


def hold_tree(got_dir: str, want_dir: str) -> dict:
    """A card's output tree against its CPU twin: the same files; every VCF
    by vcf_qual_delta, every other file byte for byte."""
    got, want = output_tree(got_dir), output_tree(want_dir)
    assert sorted(got) == sorted(want), \
        f"output files differ: {sorted(got)} != {sorted(want)}"
    vcfs, others, max_dq = 0, 0, 0.0
    for rel, path in sorted(want.items()):
        if os.path.isdir(path):
            assert os.path.isdir(got[rel]), f"{rel}: not a directory"
        elif rel.endswith(".vcf"):
            max_dq = max(max_dq, vcf_qual_delta(got[rel], path))
            vcfs += 1
        else:
            same_bytes(got[rel], path, rel)
            others += 1
    return dict(vcfs=vcfs, other_files=others, max_qual_delta=max_dq)


def check_cli(fx: dict, work: str) -> dict:
    from svision_tpu_torch import cli

    def run(name, mode, extra, sample="plain", outdir=None):
        """One run_pipeline call, its launch counts held to launches per
        batch x batches, with the warm-up batches counted apart."""
        bam, genome, sample_name, support = SAMPLES[sample]
        args = ["-o", os.path.join(work, outdir or name), "-b", fx[bam],
                "-g", fx[genome], "-m", fx["weights"], "-n", sample_name,
                "-s", support, *extra]
        with counted() as r:
            vcf = cli.run_pipeline(cli.parse_arguments(args))
        recs = _records(vcf)
        assert recs, f"{name}: VCF has no records"
        cpu = "cpu" in extra
        hold_launches(name, "cpu" if cpu else mode, r,
                      warmups=warmup_batches(cpu),
                      devices=1 if cpu else mesh_devices())
        log(f"cli {name}: {len(recs)} records, {r['wall_s']:.3f} s, batches "
            f"{r['batches']}, launches {r['launches']}")
        return vcf, dict(r, records=len(recs))

    out = {}
    default_vcf, out["default"] = run("gpu_default", "default", [])
    gpu_vcf, out["exact"] = run("gpu_exact", "exact", ["--exact"])
    out["vcf"] = {"default": default_vcf, "exact": gpu_vcf}
    cpu_vcf, out["exact_cpu"] = run("cpu_exact", "exact",
                                    ["--exact", "--device", "cpu"])
    n = len(_records(gpu_vcf))
    max_dq = vcf_qual_delta(gpu_vcf, cpu_vcf)
    out["exact_gpu_vs_cpu_max_qual_delta"] = max_dq
    log(f"cli --exact GPU vs CPU: {n} records equal outside QUAL, "
        f"max QUAL delta {max_dq}")

    # the optional modes: --exact on the card and on the CPU, each output
    # tree held to its twin, and once in the default mode on the card
    out["modes"], out["runs"] = {}, {}
    t_modes = time.perf_counter()
    for mode, (sample, extra, runs) in CLI_MODES.items():
        t0 = time.perf_counter()
        got = {}
        for kind, numeric, flags, times in (
                ("exact", "exact", ["--exact"], runs),
                ("exact_cpu", "exact", ["--exact", "--device", "cpu"], runs),
                ("default", "default", [], 1)):
            for i in range(times):
                key = f"{mode}_{kind}" + (f"_{i + 1}" if times > 1 else "")
                _, got[key] = run(key, numeric, extra + flags, sample,
                                  outdir=f"{mode}_{kind}")
        held = hold_tree(os.path.join(work, f"{mode}_exact"),
                         os.path.join(work, f"{mode}_exact_cpu"))
        out["modes"][mode] = dict(held, wall_s=time.perf_counter() - t0,
                                  runs=got)
        out["runs"].update({f"cli_{k}": v for k, v in got.items()
                            if "_cpu" not in k})
        log(f"cli {mode}: --exact card vs CPU: {held['vcfs']} VCFs equal "
            f"outside QUAL (max QUAL delta {held['max_qual_delta']}), "
            f"{held['other_files']} other files equal byte for byte; "
            f"{out['modes'][mode]['wall_s']:.1f} s")
    out["modes_s"] = time.perf_counter() - t_modes
    log(f"cli optional modes: {out['modes_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 4b: the installed command
# ---------------------------------------------------------------------------

# what an install copies: the packaging files and both packages
INSTALL_TREE = ("pyproject.toml", "setup.py", "svision_tpu",
                "svision_tpu_torch")


def install_copy(root: str) -> dict:
    """Install a copy of the tree offline into <root>/prefix. setuptools
    writes build/ and an egg-info into the directory it installs from, so
    it installs from a copy (<root>/src, build/, __pycache__ and *.so left
    out) and the checkout gains nothing. Returns the prefix's bin and
    site-packages, an empty HOME and the install's seconds."""
    import glob
    import shutil
    src, prefix, home = (os.path.join(root, d)
                         for d in ("src", "prefix", "home"))
    os.makedirs(src)
    os.makedirs(home)
    for name in INSTALL_TREE:
        path = os.path.join(ROOT, name)
        if os.path.isdir(path):
            shutil.copytree(path, os.path.join(src, name),
                            ignore=shutil.ignore_patterns(
                                "build", "__pycache__", "*.so"))
        else:
            shutil.copy(path, os.path.join(src, name))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps",
                        "--no-build-isolation", "--no-index", "--no-cache-dir",
                        "--prefix", prefix, src], capture_output=True,
                       text=True, env=dict(os.environ, HOME=home), timeout=300)
    install_s = time.perf_counter() - t0
    assert p.returncode == 0, f"pip install failed:\n{p.stdout}{p.stderr}"
    (site,) = glob.glob(os.path.join(prefix, "lib", "python*",
                                     "site-packages"))
    return dict(bin=os.path.join(prefix, "bin"), site=site, home=home,
                install_s=install_s)


def check_installed(fx: dict, work: str, vcfs: dict) -> dict:
    """Phase 4b: install the tree into a scratch prefix and run the
    installed svision-tpu-torch on the card, from outside the checkout
    with PYTHONPATH the prefix's site-packages alone and an empty HOME (a
    cold kernel cache), once in the default mode and once with --exact on
    phase 4's sample and weights. The package resolves to the prefix, the
    kernel libraries of the installed sources are built into
    HOME/.cache/svision-tpu/kernels and nowhere else, and each VCF equals
    phase 4's in-process VCF of its mode byte for byte."""
    import glob
    root = os.path.join(work, "installed")
    inst = install_copy(root)
    log(f"install: {inst['install_s']:.3f} s")
    env = dict(os.environ, PYTHONPATH=inst["site"], HOME=inst["home"])
    checkout_kernels = os.path.join(ROOT, "build", "kernels")
    before = sorted(os.listdir(checkout_kernels))
    code = ("import json, svision_tpu_torch; "
            "from svision_tpu_torch.ops import _kernels as k; "
            "print(json.dumps([svision_tpu_torch.__file__, k._BUILD, "
            "[k._lib_path(s) for s in k.SOURCES]]))")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    pkg, build, libs = json.loads(p.stdout)
    assert pkg == os.path.join(inst["site"], "svision_tpu_torch",
                               "__init__.py"), f"installed run imports {pkg}"
    cache = os.path.join(inst["home"], ".cache", "svision-tpu", "kernels")
    assert build == cache and not os.path.exists(cache), build
    assert all(os.path.dirname(lib) == cache for lib in libs), libs

    bam, genome, name, support = SAMPLES["plain"]
    out = dict(install_s=inst["install_s"])
    for mode, flags in (("default", []), ("exact", ["--exact"])):
        outdir = os.path.join(root, mode)
        argv = [os.path.join(inst["bin"], "svision-tpu-torch"), "-o", outdir,
                "-b", fx[bam], "-g", fx[genome], "-m", fx["weights"],
                "-n", name, "-s", support, *flags]
        t0 = time.perf_counter()
        p = subprocess.run(argv, cwd=root, env=env, capture_output=True,
                           text=True, timeout=600)
        wall = time.perf_counter() - t0
        assert p.returncode == 0, \
            f"installed {mode} run exited {p.returncode}:\n{p.stderr[-3000:]}"
        (vcf,) = glob.glob(os.path.join(outdir, "*.vcf"))
        same_bytes(vcf, vcfs[mode], f"installed {mode} VCF")
        out[f"{mode}_wall_s"] = wall
        log(f"installed svision-tpu-torch {' '.join(flags) or '(default)'}: "
            f"{len(_records(vcf))} records, VCF equal to phase 4's byte for "
            f"byte, {wall:.3f} s")
    missing = [lib for lib in libs if not os.path.exists(lib)]
    assert not missing, f"kernel libraries not built into the cache: {missing}"
    # the cold build: from the cache directory's creation (its parent's
    # mtime) to the last library's ptxas log, written once every nvcc ended
    out["cold_build_s"] = (
        max(os.path.getmtime(lib + ".log") for lib in libs)
        - os.path.getmtime(os.path.dirname(cache)))
    assert not os.path.exists(os.path.join(inst["site"], "build")), \
        "the installed run built under site-packages"
    assert sorted(os.listdir(checkout_kernels)) == before, \
        "the installed run built into the checkout"
    log(f"installed kernels: {len(libs)} libraries built into the cache "
        f"cold in {out['cold_build_s']:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phases 5 and 6: serving, sharding, cohorts
# ---------------------------------------------------------------------------

def same_bytes(got: str, want: str, what: str) -> None:
    with open(got, "rb") as g, open(want, "rb") as w:
        a, b = g.read(), w.read()
    assert a == b, f"{what}: {got} differs from {want}"


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(argvs, logs, timeout: float = 300.0) -> float:
    """Start every argv at once from the checkout's root and wait for all;
    fail with the end of the log of any that exits non-zero. Returns the
    wall time in s. Every process is gone on return."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    files = [open(p, "w") for p in logs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(a, stdout=f, stderr=subprocess.STDOUT,
                              cwd=ROOT, env=env) for a, f in zip(argvs, files)]
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    for p, path in zip(procs, logs):
        with open(path) as f:
            tail = f.read()[-3000:]
        assert p.returncode == 0, f"{p.args} exited {p.returncode}:\n{tail}"
    return wall


@contextlib.contextmanager
def working_dir(path: str):
    """chdir for the block: a Unix socket's path is limited to 107 bytes,
    so the server binds a name relative to its directory."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def check_serve(fx: dict, work: str, cold_wall_s: float) -> dict:
    """Phase 5: one warm default-mode server in this process on the
    two-chromosome genome, three concurrent socket clients with two
    requests each (phase 4's sample and the two-chromosome one), every
    reply's VCF byte-equal to a standalone CLI run and every request's
    launches held; then `python -m svision_tpu_torch.serve` once over
    stdin."""
    import socket
    from svision_tpu_torch import cli, serve

    samples = {"A": fx["bam"], "B": fx["bam2"]}
    base = ["-g", fx["genome2"], "-m", fx["weights"], "-s", "3"]
    nd = mesh_devices()
    out = {"runs": {}}
    solo = {}
    for s, bam in samples.items():
        with counted() as r:
            solo[s] = cli.run_pipeline(cli.parse_arguments(
                ["-o", os.path.join(work, f"solo_{s}"), "-b", bam,
                 "-n", f"S{s}", *base]))
        hold_launches(f"cli {s}", "default", r, warmups=warmup_batches(),
                      devices=nd)
        assert _records(solo[s]), f"standalone {s}: VCF has no records"
        out["runs"][f"cli_{s}"] = r
        log(f"cli on the two-chromosome genome, sample {s}: "
            f"{len(_records(solo[s]))} records, {r['wall_s']:.3f} s, "
            f"launches {r['launches']}")
    out["solo"] = solo

    requests = []
    handle = serve.handle_request

    def counted_handle(req, ns, engine):
        with counted() as r:
            rep = handle(req, ns, engine)
        requests.append(dict(r, id=req.get("id")))
        return rep

    with working_dir(work):
        ns = serve.parse_arguments([*base, "--socket", "svs.sock"])
        t0 = time.perf_counter()
        engine = serve.build_engine(ns)
        out["ready_s"] = time.perf_counter() - t0
        serve.handle_request = counted_handle

        def run_server():
            # its banner goes to stderr: stdout carries this script's lines
            with contextlib.redirect_stdout(sys.stderr):
                serve.serve_socket(ns, engine, "svs.sock")

        server = threading.Thread(target=run_server, daemon=True)
        try:
            server.start()

            def connect():
                for _ in range(600):
                    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    try:
                        conn.connect("svs.sock")
                        return conn
                    except OSError:
                        conn.close()
                        time.sleep(0.05)
                raise AssertionError("the socket server never listened")

            replies = {t: [] for t in range(3)}

            def client(t):
                conn = connect()
                with conn, conn.makefile("r", encoding="utf-8") as f:
                    for i, s in enumerate("AB" if t % 2 == 0 else "BA"):
                        req = {"bam": samples[s], "sample": f"S{s}",
                               "out": os.path.join(work, f"srv{t}_{i}"),
                               "id": f"{t}:{i}:{s}"}
                        conn.sendall((json.dumps(req) + "\n").encode())
                    replies[t].extend(json.loads(f.readline())
                                      for _ in range(2))

            clients = [threading.Thread(target=client, args=(t,))
                       for t in range(3)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=300)
                assert not c.is_alive(), "a socket client hung"
            conn = connect()
            with conn, conn.makefile("r", encoding="utf-8") as f:
                conn.sendall(b'{"cmd": "shutdown"}\n')
                assert json.loads(f.readline()) == {"ok": True, "bye": True}
            server.join(timeout=60)
            assert not server.is_alive(), "the socket server did not stop"
        finally:
            serve.handle_request = handle
    del engine

    for t, reps in replies.items():
        assert [r.get("id")[:3] for r in reps] == [f"{t}:0", f"{t}:1"], reps
        for r in reps:
            assert r["ok"], r
            same_bytes(r["vcf"], solo[r["id"][-1]], f"served {r['id']}")
    assert len(requests) == 6, requests
    for r in requests:
        hold_launches(f"request {r['id']}", "default", r, warmups=0,
                      devices=nd)
    out["requests"] = requests
    out["runs"]["serve"] = dict(
        launches={k: sum(r["launches"][k] for r in requests)
                  for k in PER_BATCH["default"]},
        batches={k: sum(r["batches"][k] for r in requests)
                 for k in ("warmup", "real")})
    walls = ", ".join(f"{r['id']} {r['wall_s']:.3f} s" for r in requests)
    log(f"serve: ready in {out['ready_s']:.3f} s; warm requests {walls}; "
        f"phase 4's cold CLI run {cold_wall_s:.3f} s")

    # the module's own entry point over stdin
    errlog = os.path.join(work, "serve_stdin.log")
    with open(errlog, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "svision_tpu_torch.serve", *base],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
            text=True, cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2"))
        watchdog = threading.Timer(300, proc.kill)
        watchdog.start()
        try:
            t0 = time.perf_counter()
            line = proc.stdout.readline()
            out["subprocess_ready_s"] = time.perf_counter() - t0

            def ask(req):
                proc.stdin.write(json.dumps(req) + "\n")
                proc.stdin.flush()
                return json.loads(proc.stdout.readline())

            assert line, f"no banner:\n{open(errlog).read()[-3000:]}"
            banner = json.loads(line)
            assert banner == {"ready": True, "pid": proc.pid}, banner
            t0 = time.perf_counter()
            rep = ask({"bam": samples["B"], "sample": "SB", "id": "stdin",
                       "out": os.path.join(work, "srv_stdin")})
            out["subprocess_request_s"] = time.perf_counter() - t0
            assert rep["ok"] and rep["id"] == "stdin", rep
            same_bytes(rep["vcf"], solo["B"], "served over stdin")
            assert ask({"cmd": "ping"}) == {"ok": True, "pong": True}
            assert ask({"cmd": "shutdown"}) == {"ok": True, "bye": True}
            assert proc.wait(timeout=60) == 0, "serve exited non-zero"
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    log(f"serve over stdin (subprocess): ready in "
        f"{out['subprocess_ready_s']:.3f} s, one request "
        f"{out['subprocess_request_s']:.3f} s, VCF equal, exit 0")
    return out


def check_shards(fx: dict, work: str, solo: dict) -> dict:
    """Phase 6, on the two-chromosome sample: two shards and a merge in
    this process, two --coordinator processes with disjoint out dirs, and a
    two-sample cohort in 2 shards as two processes, each VCF byte-equal to
    its 1-shard run; --mesh 2 where the machine has two GPUs."""
    import torch
    from svision_tpu_torch import cli
    from svision_tpu_torch.parallel import cohort

    base = ["-b", fx["bam2"], "-g", fx["genome2"], "-m", fx["weights"],
            "-n", "SB", "-s", "3"]
    nd = mesh_devices()
    out = {"runs": {}}
    shard_dir = os.path.join(work, "shards")
    t_all = time.perf_counter()
    for k in (0, 1):
        with counted() as r:
            frag = cli.run_pipeline(cli.parse_arguments(
                ["-o", shard_dir, *base, "--num_shards", "2",
                 "--shard_id", str(k)]))
        assert frag == os.path.join(shard_dir, "predict_results"), frag
        hold_launches(f"shard {k}", "default", r, warmups=warmup_batches(),
                      devices=nd)
        out["runs"][f"shard{k}"] = r
    with counted() as r:
        merged = cli.run_pipeline(cli.parse_arguments(
            ["-o", shard_dir, *base, "--merge_shards"]))
    assert r["batches"] == {"warmup": 0, "real": 0} and \
        not any(r["launches"].values()), f"merge ran the engine: {r}"
    out["two_shards_in_process_s"] = time.perf_counter() - t_all
    same_bytes(merged, solo["B"], "2 shards + merge")
    log(f"shards: 2 shards + merge in this process "
        f"{out['two_shards_in_process_s']:.3f} s (1-shard run "
        f"{REPORT['serve']['runs']['cli_B']['wall_s']:.3f} s), VCF equal; "
        f"launches {out['runs']['shard0']['launches']} / "
        f"{out['runs']['shard1']['launches']}")

    coord = f"127.0.0.1:{free_port()}"
    dirs = [os.path.join(work, f"coord{k}") for k in (0, 1)]
    out["coordinator_s"] = run_procs(
        [[sys.executable, "-m", "svision_tpu_torch.cli", "-o", dirs[k], *base,
          "--num_shards", "2", "--shard_id", str(k), "--coordinator", coord]
         for k in (0, 1)],
        [os.path.join(work, f"coord{k}.log") for k in (0, 1)])
    same_bytes(os.path.join(dirs[0], "SB.svision.s3.vcf"), solo["B"],
               "--coordinator")
    assert not os.path.exists(os.path.join(dirs[1], "SB.svision.s3.vcf"))
    log(f"shards: two --coordinator processes sharing the GPUs "
        f"{out['coordinator_s']:.3f} s, VCF equal")

    samples = {"A": fx["bam"], "B": fx["bam2"]}
    one = os.path.join(work, "cohort1")
    os.makedirs(one)
    with counted() as r:
        cohort1 = cohort.run_cohort(samples, cli.RunOptions(
            out_path=one, genome=fx["genome2"], model_path=fx["weights"],
            min_support=3).normalized())
    hold_launches("cohort 1 shard", "default", r, warmups=warmup_batches(),
                  devices=nd)
    out["runs"]["cohort_1shard"] = r
    assert _records(cohort1), "cohort VCF has no records"
    two = os.path.join(work, "cohort2")
    out["cohort_2_processes_s"] = run_procs(
        [[sys.executable, "-m", "svision_tpu_torch.parallel.cohort",
          "-o", two, "-g", fx["genome2"], "-m", fx["weights"], "--samples",
          *[f"{n}={p}" for n, p in samples.items()], "-s", "3",
          "--num-shards", "2", "--shard-id", str(k)] for k in (0, 1)],
        [os.path.join(work, f"cohort2_{k}.log") for k in (0, 1)])
    same_bytes(os.path.join(two, "cohort.svision.s3.vcf"), cohort1,
               "2-shard cohort")
    log(f"cohort: 1 shard {r['wall_s']:.3f} s, 2 shard processes "
        f"{out['cohort_2_processes_s']:.3f} s, VCF equal "
        f"({len(_records(cohort1))} sites)")

    if torch.cuda.device_count() > 1:
        with counted() as r:
            vcf = cli.run_pipeline(cli.parse_arguments(
                ["-o", os.path.join(work, "mesh2"), *base, "--mesh", "2"]))
        hold_launches("--mesh 2", "default", r, warmups=warmup_batches(),
                      devices=2)
        same_bytes(vcf, solo["B"], "--mesh 2")
        out["runs"]["mesh2"] = r
        log(f"--mesh 2: VCF equal, launches {r['launches']}")
    else:
        log("--mesh 2: one GPU visible, so the multi-GPU engine was not run "
            "on the card")
    return out


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------

GPU = "cuda"                 # phase 7's device
TRAIN_B = 64                 # the training batch of the rates and profile
MESH_B = 32                  # the DP x TP graph check's global batch
RATE_STEPS = 12              # steps per epoch of each rate run


def _per_step(k1: int, tails: int) -> dict:
    """Launches a step: K1 k1 times, K2 and its backward once per
    bias/ReLU/pool/LRN tail (two per conv stack)."""
    return {"render_raster": k1, "bias_relu_pool_lrn": tails,
            "bias_relu_pool_lrn_backward": tails, "conv1_fused_raster": 0,
            "specs_endpoints": 0, "bias_relu_pool_lrn_halves": 0,
            **dict.fromkeys(MOE_WRAPPERS, 0)}


# launches per step of each training run, and per batch of evaluate; the
# DP x TP step on its 2 x 2 grid runs the conv stack on every cell
PER_STEP = {
    "fit": _per_step(1, 2),
    "fit_device_image": _per_step(1, 2),
    "fit_device_image_noise": _per_step(1, 2),
    "fit_device_s2d": _per_step(0, 2),
    "fit_mesh": _per_step(1, 2 * 4),
    "evaluate": {"render_raster": 1, "bias_relu_pool_lrn": 2,
                 "bias_relu_pool_lrn_backward": 0, "conv1_fused_raster": 0,
                 "specs_endpoints": 0, "bias_relu_pool_lrn_halves": 0,
                 **dict.fromkeys(MOE_WRAPPERS, 0)}}


def labeled(n: int, seed: int):
    """n random specs with labels 0-4."""
    return random_specs(n, seed=seed), np.arange(n, dtype=np.int32) % 5


@contextlib.contextmanager
def counted_steps(name: str, kind: str, steps: int):
    """Count the block's kernel launches (every count set to 0 on entry)
    and hold them to PER_STEP[kind] x steps on exit. Yields a dict that
    gets "launches" and "wall_s" (host clock, synchronized)."""
    import torch
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = {"batches": {"steps": steps}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield out
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {k: w.launches for k, w in wrappers.items()}
    want = {k: v * steps for k, v in PER_STEP[kind].items()}
    assert out["launches"] == want, \
        f"{name}: launches {out['launches']} != {want}"


def check_train_step(params) -> dict:
    """One f32 step (clip 1, lr 5e-3, keep_prob 1) at batch 32 on the card
    and on the CPU from the same weights and images: the loss within 1e-4
    relative, each gradient within 1e-2 of its largest entry, each
    parameter after the update within 1e-4 of its largest value plus 1e-2
    of its largest update; every parameter has a gradient."""
    import torch
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import AlexNet, params_to_numpy
    specs, labels = labeled(32, seed=8)
    res = {}
    for dev in ("cpu", GPU):
        model = AlexNet.trainable(params, device=dev)
        _, step = train.make_train_step(model, learning_rate=5e-3,
                                        clip_norm=1.0, keep_prob=1.0)
        images = train.specs_to_images(specs, device=dev)
        t0 = time.perf_counter()
        loss = float(step(images, torch.from_numpy(labels).to(dev),
                          torch.Generator(device=dev).manual_seed(0)))
        step_s = time.perf_counter() - t0
        named = dict(model.named_parameters())
        missing = [k for k, v in named.items() if v.grad is None]
        assert len(named) == 16 and not missing, f"{dev}: no grad {missing}"
        res[dev] = (loss, params_to_numpy(named),
                    params_to_numpy({k: v.grad for k, v in named.items()}),
                    step_s)
        del model, step, named
    (lc, pc, gc, sc), (lg, pg, gg, sg) = res["cpu"], res[GPU]
    out = dict(loss_cpu=lc, loss_gpu=lg, loss_rel_err=abs(lg - lc) / abs(lc),
               cpu_step_s=sc, first_gpu_step_s=sg, grad_rel_err={},
               param_err_over_tol={})
    assert out["loss_rel_err"] <= 1e-4, f"train step: loss {lg} vs {lc}"
    for k in pc:
        out["grad_rel_err"][k] = float(np.abs(gg[k] - gc[k]).max()
                                       / np.abs(gc[k]).max())
        assert out["grad_rel_err"][k] <= 1e-2, f"train step: grad {k}"
        p0 = np.asarray(params[k], np.float32)
        tol = (1e-4 * np.abs(pc[k]).max() + 1e-2 * np.abs(pc[k] - p0).max())
        out["param_err_over_tol"][k] = float(np.abs(pg[k] - pc[k]).max() / tol)
        assert out["param_err_over_tol"][k] <= 1.0, f"train step: param {k}"
    log(f"train step f32 B=32, GPU vs CPU: loss {lg} vs {lc}, worst grad "
        f"rel err {max(out['grad_rel_err'].values()):.3g}, worst param "
        f"err/tol {max(out['param_err_over_tol'].values()):.3g}; all 16 "
        "parameters have gradients")
    return out


def eager_twin(model, opt, make):
    """A second trainer in model's state: the same parameters and momentum
    buffers; make(twin) -> (optimizer, step) builds its eager step."""
    import copy
    twin = copy.deepcopy(model)
    twin_opt, step = make(twin)
    for p, q in zip(model.parameters(), twin.parameters()):
        twin_opt.state[q]["momentum_buffer"] = \
            opt.state[p]["momentum_buffer"].clone()
    return twin, step


def check_graph_steps(params) -> dict:
    """One graphed training step against the eager step from the same
    weights, momentum and batch, at keep_prob 1 without augmentation:
    make_train_step (f32, the image path: fit's step) and make_device_step
    (bf16 s2d: fit_device's whole step). Each trainer first takes its
    graphs.WARMUP_STEPS eager steps; then two eager twins of its state
    (eager_twin) and the trainer's first replay take the same step. The
    loss within 1e-6 relative and every parameter within 1e-6 of its
    largest entry; the report says what differed, beside what the two
    eager twins differ by (max-pool's backward on the card adds with
    atomics, so eager steps are not bit-reproducible). Then replays at
    keep_prob 0.5 on one batch with a zero learning rate draw new dropout
    masks: every loss differs. The eager twins' steps also count the
    copies BiasReluPoolLRN makes of a non-contiguous NHWC view."""
    import torch
    from svision_tpu_torch import graphs
    from svision_tpu_torch.models import train
    from svision_tpu_torch.ops.fused_pool_lrn import BiasReluPoolLRN
    from svision_tpu_torch.models.alexnet import AlexNet, params_to_numpy
    from svision_tpu_torch.ops import rasterize
    dev = torch.device(GPU)
    steps = graphs.WARMUP_STEPS + 1
    specs, labels = labeled(32 * steps, seed=13)
    y = torch.from_numpy(labels).long().to(dev)
    seg = [torch.from_numpy(a).to(dev)
           for a in rasterize.specs_to_endpoints(specs)]
    images = train.specs_to_images(specs, device=dev)
    flip = torch.zeros((), dtype=torch.bool, device=dev)

    def image_trainer(model, eager=False):
        opt, step = train.make_train_step(model, learning_rate=5e-3,
                                          clip_norm=1.0, keep_prob=1.0,
                                          eager=eager)
        gen = torch.Generator(device=dev).manual_seed(0)
        return opt, lambda i: step(images[32 * i:32 * (i + 1)],
                                   y[32 * i:32 * (i + 1)], gen)

    def device_trainer(model, eager=False):
        opt, step = train.make_device_step(
            model, *seg, y, torch.Generator(device=dev).manual_seed(0),
            batch_size=32, keep_prob=1.0, compute_dtype=torch.bfloat16,
            augment=False, s2d=True, eager=eager)
        return opt, lambda i: step(
            torch.arange(32 * i, 32 * (i + 1), device=dev), flip)

    out = {}
    for name, make in (("make_train_step_f32_image", image_trainer),
                       ("make_device_step_bf16_s2d", device_trainer)):
        model = AlexNet.trainable(params, device=dev)
        opt, step = make(model)
        for i in range(graphs.WARMUP_STEPS):
            step(i)
        twins = [eager_twin(model, opt, lambda m: make(m, eager=True))
                 for _ in range(2)]
        last = steps - 1
        lg = float(step(last))
        BiasReluPoolLRN.copies = 0
        le = [float(tstep(last)) for _, tstep in twins]
        copies = BiasReluPoolLRN.copies / len(twins)
        pg = params_to_numpy(dict(model.named_parameters()))
        pe = [params_to_numpy(dict(t.named_parameters())) for t, _ in twins]

        def rel(a, b):
            return {k: float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
                    for k in b}
        err, twin_err = rel(pg, pe[0]), rel(pe[1], pe[0])
        out[name] = dict(graphed_loss=lg, eager_losses=le,
                         loss_rel_err=abs(lg - le[0]) / abs(le[0]),
                         bit_equal=lg == le[0] and all(
                             np.array_equal(pg[k], pe[0][k]) for k in pg),
                         param_rel_err=err, eager_twins_param_rel_err=twin_err,
                         pool_lrn_copies_per_eager_step=copies)
        assert out[name]["loss_rel_err"] <= 1e-6, f"{name}: {lg} vs {le}"
        assert max(err.values()) <= 1e-6, f"{name}: parameters {err}"
        log(f"graphed step {name}: loss {lg} (eager {le}), bit-equal "
            f"{out[name]['bit_equal']}, worst parameter rel err "
            f"{max(err.values()):.3g} (eager vs eager "
            f"{max(twin_err.values()):.3g}); BiasReluPoolLRN copies an "
            f"eager step {copies}")
        del model, opt, step, twins

    model = AlexNet.trainable(params, device=dev)
    _, step = train.make_train_step(model, learning_rate=0.0, keep_prob=0.5)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = [float(step(images[:32], y[:32], gen))
              for _ in range(graphs.WARMUP_STEPS + 3)]
    assert len(set(losses)) == len(losses), \
        f"dropout masks repeat across replays: {losses}"
    out["dropout_losses_lr0"] = losses
    log(f"graphed step, keep_prob 0.5, lr 0, one batch: losses {losses}")
    return out


def check_bf16_loss(params) -> dict:
    """Eight bf16 s2d steps on one repeated batch: a falling loss."""
    import torch
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import AlexNet
    from svision_tpu_torch.ops import rasterize
    dev = torch.device(GPU)
    specs, labels = labeled(TRAIN_B, seed=9)
    seg = [torch.from_numpy(a).to(dev)
           for a in rasterize.specs_to_endpoints(specs)]
    x = rasterize.render_raster_s2d(*seg, dtype=torch.bfloat16)
    y = torch.from_numpy(labels).to(dev)
    model = AlexNet.trainable(params, device=dev)
    _, step = train.make_train_step(model, learning_rate=1e-3, clip_norm=1.0,
                                    keep_prob=1.0, compute_dtype=torch.bfloat16,
                                    s2d=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = [float(step(x, y, gen)) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], \
        f"bf16 loss did not fall: {losses}"
    log(f"bf16 s2d, 8 steps on one batch of {TRAIN_B}: loss {losses}")
    return {"losses": losses}


def train_rates(params) -> dict:
    """Training images/s at batch TRAIN_B, each run two epochs of
    RATE_STEPS steps: the rate is the second epoch's (the first warms
    cuDNN up), read from the epoch-end log call, which follows a sync."""
    import torch
    from svision_tpu_torch.models.train import fit, fit_device
    specs, labels = labeled(TRAIN_B * RATE_STEPS, seed=10)
    configs = [("fit_f32", "fit", fit, torch.float32, {}),
               ("fit_bf16", "fit", fit, torch.bfloat16, {}),
               ("fit_device_s2d_f32", "fit_device_s2d", fit_device,
                torch.float32, {"s2d": True}),
               ("fit_device_s2d_bf16", "fit_device_s2d", fit_device,
                torch.bfloat16, {"s2d": True}),
               ("fit_device_image_f32", "fit_device_image", fit_device,
                torch.float32, {"s2d": False}),
               ("fit_device_image_noise_f32", "fit_device_image_noise",
                fit_device, torch.float32, {"s2d": False, "noise_aug": True})]
    out = {}
    for name, kind, fn, dtype, kw in configs:
        stamps = []
        with counted_steps(name, kind, 2 * RATE_STEPS) as r:
            _, hist = fn(params, specs, labels, epochs=2, batch_size=TRAIN_B,
                         compute_dtype=dtype, device=GPU,
                         log=lambda m: stamps.append(time.perf_counter()),
                         **kw)
        assert np.isfinite(hist).all(), f"{name}: loss {hist}"
        r["images_per_s"] = RATE_STEPS * TRAIN_B / (stamps[1] - stamps[0])
        r["history"] = hist
        out[name] = r
        log(f"train rate {name} ({REPORT['device']['nvidia_smi']}): "
            f"{r['images_per_s']:.1f} images/s, launches {r['launches']}")
        torch.cuda.empty_cache()
    return out


def profile_train_step(params) -> dict:
    """fit_device's bf16 s2d step at batch 64 (make_device_step: gather,
    jitter, flip, the plain s2d raster and the train step, dropout on), as
    the graph and as the eager step: each profiled for one step (the
    benchmark's trace, benchmark/devtrace.py: busy time, the idle share,
    the longest device operations, the operations executed, the span from
    the first to the last), its host's launch calls counted in a second
    profiled step (host_calls), and timed back to back by host clock
    (host_clock_ms) and, the graph, by CUDA events with the queue held
    (time_ms: the device's time a step, gaps between its operations
    included). K2's and its backward's kernels, by the names the
    benchmark's rooflines read, give the pool/LRN share of the step. Then
    CUDA-event times, the queue held, of two of its parts: the plain s2d
    raster, and bias/ReLU/pool/LRN forward and backward at the conv1 and
    conv2 tails, through BiasReluPoolLRN (the trainers' route) and through
    the composition of torch ops the trainers ran before it; each part's
    share is of the graphed step's device-busy time."""
    import torch
    from benchmark import devtrace, spec
    from svision_tpu_torch import graphs
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import AlexNet
    from svision_tpu_torch.ops import rasterize
    from svision_tpu_torch.ops.fused_pool_lrn import lrn
    dev = torch.device(GPU, torch.cuda.current_device())
    pool_lrn_names = {
        "forward": spec.metric("k2_roofline.predict").KERNELS,
        "backward": spec.metric("k2_backward_roofline").KERNELS}
    bf = torch.bfloat16
    specs, labels = labeled(TRAIN_B, seed=11)
    seg = [torch.from_numpy(a).to(dev)
           for a in rasterize.specs_to_endpoints(specs)]
    y = torch.from_numpy(labels).to(dev)
    idx = torch.arange(TRAIN_B, device=dev)
    flip = torch.zeros((), dtype=torch.bool, device=dev)
    out = {"batch": TRAIN_B}
    for how, eager in (("graphed", False), ("eager", True)):
        model = AlexNet.trainable(params, device=dev)
        _, step = train.make_device_step(
            model, *seg, y, torch.Generator(device=dev).manual_seed(0),
            batch_size=TRAIN_B, compute_dtype=bf, eager=eager)

        def one():
            return step(idx, flip)
        for _ in range(graphs.WARMUP_STEPS + 2):
            one()
        trace = devtrace.profile(one, [dev])
        prof_ms, busy_ms = trace.window_s * 1e3, trace.busy_s * 1e3
        ops = trace.ops[dev.index]
        pool_lrn, launched = {}, {}
        for part, names in pool_lrn_names.items():
            launched[part], t = trace.kernel_time(names)
            pool_lrn[part] = t * 1e3
        calls = host_calls(one)["by_name"]
        out[how] = dict(
            wall_ms=prof_ms, device_ms=busy_ms,
            idle_share=trace.idle_pct() / 100,
            device_ops_executed=len(ops),
            host_launch_calls=sum(calls.get(k, 0) for k in (
                "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaGraphLaunch")),
            device_span_ms=(max(b for _, _, b in ops)
                            - min(a for _, a, _ in ops)) * 1e3,
            step_wall_ms=host_clock_ms(one),
            # the eager step's 400-odd launches take the host longer than
            # its device time, so the queue cannot be held for it
            step_event_ms=None if eager else time_ms(one, reps=10),
            top_kernels_ms={k: v * 1e3
                            for k, v in trace.breakdown()["device_ops"]},
            pool_lrn_kernels_ms=pool_lrn,
            pool_lrn_kernels_share=sum(pool_lrn.values()) / busy_ms)
        log(f"profile train step bf16 s2d B={TRAIN_B} {how} "
            f"({REPORT['device']['nvidia_smi']}): {prof_ms:.3f} ms wall "
            f"profiled, {busy_ms:.3f} ms on the device, idle share "
            f"{out[how]['idle_share']:.3f}, "
            f"{out[how]['device_ops_executed']} device operations, "
            f"{out[how]['host_launch_calls']} launch calls, first to last "
            f"{out[how]['device_span_ms']:.3f} ms; unprofiled step "
            f"{out[how]['step_wall_ms']:.3f} ms wall, "
            f"{out[how]['step_event_ms']} ms between events, the queue held; "
            f"K2 and its backward {sum(pool_lrn.values()):.3f} ms "
            f"({out[how]['pool_lrn_kernels_share']:.1%} of the busy time): "
            f"{out[how]['pool_lrn_kernels_ms']}")
        assert all(launched.values()), \
            f"profile train step {how}: K2 kernels launched {launched}"
        del model, step
    busy_ms = out["graphed"]["device_ms"]
    raster_ms = time_ms(lambda: rasterize.render_raster_s2d(*seg, dtype=bf),
                        reps=PLAIN_REPS)
    tails, composed = {}, {}
    tgen = torch.Generator(device=dev).manual_seed(3)
    for tail, c, hw in (("conv1", 96, 55), ("conv2", 256, 27)):
        h = torch.randn((TRAIN_B, hw, hw, c), generator=tgen, device=dev).to(
            bf).requires_grad_()
        b = torch.zeros(c, device=dev, dtype=bf, requires_grad=True)
        ho = (hw - 3) // 2 + 1
        g = torch.randn((TRAIN_B, ho, ho, c), generator=tgen,
                        device=dev).to(bf)

        def fwd_bwd(h=h, b=b, g=g):
            train.bias_relu_pool_lrn_autograd(h, b).backward(g)

        def composition(h=h, b=b, g=g):
            p = torch.nn.functional.max_pool2d(
                torch.relu(h.permute(0, 3, 1, 2) + b[:, None, None]), 3, 2)
            lrn(p.permute(0, 2, 3, 1)).backward(g)
        tails[tail] = time_ms(fwd_bwd, reps=5)
        composed[tail] = time_ms(composition, reps=5)
    out.update(s2d_raster_ms=raster_ms, s2d_raster_share=raster_ms / busy_ms,
               bias_relu_pool_lrn_fwd_bwd_ms=tails,
               bias_relu_pool_lrn_share=sum(tails.values()) / busy_ms,
               composition_fwd_bwd_ms=composed)
    log(f"held: plain s2d raster {raster_ms:.3f} ms "
        f"({out['s2d_raster_share']:.1%} of the graphed step's device busy),"
        f" bias/ReLU/pool/LRN fwd+bwd through BiasReluPoolLRN {tails} "
        f"({out['bias_relu_pool_lrn_share']:.1%}), through the torch ops "
        f"the trainers ran before it {composed}")
    return out


def replica_grid():
    """A 2 x 2 training grid whose four cells are all the first GPU."""
    import torch
    dev = torch.device(GPU, 0)
    return ((dev, dev), (dev, dev))


def train_grids() -> dict:
    """The DP x TP grids phase 7 runs: four cells of one GPU, and four
    GPUs when four are visible."""
    import torch
    from svision_tpu_torch.parallel import mesh as M
    grids = {"cuda0_x4": replica_grid()}
    if torch.cuda.device_count() >= 4:
        grids["gpus_2x2"] = M.make_train_mesh(2, 2, device=GPU)
    return grids


def mesh_twin(cells, optimizers, make):
    """A second DP x TP trainer in the state of (cells, optimizers): the
    same parameters and momentum buffers; make(cells) -> (optimizers,
    step) builds its step."""
    twin = tuple(tuple({k: t.detach().clone().requires_grad_(True)
                        for k, t in cell.items()} for cell in row)
                 for row in cells)
    twin_opts, step = make(twin)
    for c, opt in optimizers.items():
        for p, q in zip(opt.param_groups[0]["params"],
                        twin_opts[c].param_groups[0]["params"]):
            twin_opts[c].state[q]["momentum_buffer"] = \
                opt.state[p]["momentum_buffer"].clone()
    return twin, step


def host_calls(fn, sync=None) -> dict:
    """One call of fn profiled (torch.profiler): the CUDA API calls the
    host made, by name, and their total. sync() waits for the devices fn
    uses (default: the current one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync = sync or torch.cuda.synchronize
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith("cu") and "Synchronize" not in e.key}
    return {"total": sum(calls.values()), "by_name": calls}


def check_mesh_graph_steps(params) -> dict:
    """The DP x TP step (make_mesh_train_step, 2 x 2, fc6/fc7 split) as
    CUDA graphs, on four cells of one GPU and, when four are visible, on
    four GPUs. As check_graph_steps: graphs.WARMUP_STEPS eager steps (f32,
    batch MESH_B, clip 1, lr 5e-3, keep_prob 1), then the first replay against
    two eager twins (eager=True) from the same parameters and momentum:
    the loss within 1e-6 relative and every parameter within 1e-6 of its
    largest entry, beside the twins' own spread; replays at keep_prob 0.5
    on one batch with lr 0 draw new masks (every loss differs); fit(mesh=)
    over WARMUP_STEPS + 2 steps holds its launches to PER_STEP["fit_mesh"];
    and, on one GPU, the host's CUDA calls and wall ms per step, eager and
    replayed. The eager twins' steps count BiasReluPoolLRN's copies."""
    import torch
    from svision_tpu_torch import graphs
    from svision_tpu_torch.models import train
    from svision_tpu_torch.ops.fused_pool_lrn import BiasReluPoolLRN
    from svision_tpu_torch.parallel import mesh as M
    steps = graphs.WARMUP_STEPS + 1
    b = MESH_B
    specs, labels = labeled(b * (steps + 1), seed=14)
    out = {}
    for name, grid in train_grids().items():
        dev0 = grid[0][0]
        images = train.specs_to_images(specs, device=dev0)
        y = torch.from_numpy(labels).long().to(dev0)
        gens = {d: torch.Generator(device=d).manual_seed(0)
                for row in grid for d in row}

        def trainer(cells, eager=False, **kw):
            return train.make_mesh_train_step(
                cells, **{**dict(learning_rate=5e-3, clip_norm=1.0,
                                 keep_prob=1.0, eager=eager), **kw})

        def batch(i):
            return images[b * i:b * (i + 1)], y[b * i:b * (i + 1)], gens

        cells = M.shard_params_tp(params, grid)
        opts, step = trainer(cells)
        for i in range(graphs.WARMUP_STEPS):
            step(*batch(i))
        twins = [mesh_twin(cells, opts, lambda c: trainer(c, eager=True))
                 for _ in range(2)]
        assert not any(t.pieces.graphed for _, t in twins)
        last = steps - 1
        lg = float(step(*batch(last)))
        # fwd and bwd on each of 4 cells, a head a row, reduce on the two
        # owners (cells (0, 0) and (0, 1)), update on each cell
        pieces = step.pieces
        assert len(pieces.graphs) == 16 and pieces.replaying, \
            f"mesh {name}: {len(pieces.graphs)} graphs"
        BiasReluPoolLRN.copies = 0
        le = [float(tstep(*batch(last))) for _, tstep in twins]
        copies = BiasReluPoolLRN.copies / len(twins)
        pg = M.gather_params(cells)
        pe = [M.gather_params(t) for t, _ in twins]

        def rel(a, b):
            return {k: float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
                    for k in b}
        err, twin_err = rel(pg, pe[0]), rel(pe[1], pe[0])
        r = dict(graphed_loss=lg, eager_losses=le,
                 loss_rel_err=abs(lg - le[0]) / abs(le[0]),
                 bit_equal=lg == le[0] and all(
                     np.array_equal(pg[k], pe[0][k]) for k in pg),
                 param_rel_err=err, eager_twins_param_rel_err=twin_err,
                 graphs=len(pieces.graphs),
                 pool_lrn_copies_per_eager_step=copies)
        assert r["loss_rel_err"] <= 1e-6, f"mesh {name}: {lg} vs {le}"
        assert max(err.values()) <= 1e-6, f"mesh {name}: parameters {err}"
        log(f"graphed DP x TP step on {name}: loss {lg} (eager {le}), "
            f"bit-equal {r['bit_equal']}, worst parameter rel err "
            f"{max(err.values()):.3g} (eager vs eager "
            f"{max(twin_err.values()):.3g}); BiasReluPoolLRN copies an "
            f"eager step {copies}")
        if name == "cuda0_x4":
            twin_step = twins[0][1]
            r["host_calls_eager"] = host_calls(lambda: twin_step(*batch(0)))
            r["host_calls_graphed"] = host_calls(lambda: step(*batch(0)))
            r["step_wall_ms_eager"] = host_clock_ms(
                lambda: twin_step(*batch(0)))
            r["step_wall_ms_graphed"] = host_clock_ms(lambda: step(*batch(0)))
            log(f"DP x TP step on {name}, host CUDA calls a step: eager "
                f"{r['host_calls_eager']['total']}, graphed "
                f"{r['host_calls_graphed']['total']}; wall "
                f"{r['step_wall_ms_eager']:.3f} / "
                f"{r['step_wall_ms_graphed']:.3f} ms")
        del cells, opts, step, twins, pieces

        cells = M.shard_params_tp(params, grid)
        _, step = trainer(cells, learning_rate=0.0, keep_prob=0.5)
        losses = [float(step(*batch(0)))
                  for _ in range(graphs.WARMUP_STEPS + 3)]
        assert len(set(losses)) == len(losses), \
            f"mesh {name}: dropout masks repeat across replays: {losses}"
        r["dropout_losses_lr0"] = losses
        del cells, step

        fit_steps = graphs.WARMUP_STEPS + 2
        with counted_steps(f"fit mesh {name}", "fit_mesh", fit_steps) as run:
            _, hist = train.fit(params, specs[:b * fit_steps],
                                labels[:b * fit_steps], epochs=1,
                                batch_size=b, mesh=grid)
        assert np.isfinite(hist).all(), f"fit mesh {name}: {hist}"
        run["history"] = hist
        r["fit"] = run
        out[name] = r
        log(f"DP x TP on {name}: replays at keep_prob 0.5, lr 0: losses "
            f"{losses}; fit(mesh=) {fit_steps} steps, loss {hist}, launches "
            f"{run['launches']}")
        torch.cuda.empty_cache()
    return out


def check_dp_tp(params) -> dict:
    """The DP x TP step (model axis 2) against the one-device step, both
    computing in f64, which holds the grid's logic (the splits, the
    partial sums, the gradient sums) and not rounding: in f32, half
    batches reach cuBLAS kernels that round fc6's pre-activations
    otherwise, a few flip sign at the ReLU, and fc6's gradient moved 0.9%
    of its largest entry on four H100s. On every visible GPU where there
    are two or more, else on a 2 x 2 grid of one GPU's replicas. Loss
    (from fc8's f32 logits either way) within 1e-6 relative, the (f32)
    gradients within 1e-5 of their largest entry. The kernels take f32 and
    bf16 only, and on the card the trainers raise on f64: both steps run
    inside plain_kernels(), K2's function through autograd of its plain
    version."""
    import torch
    from svision_tpu_torch.models import train
    from svision_tpu_torch.models.alexnet import AlexNet, params_to_numpy
    from svision_tpu_torch.parallel import mesh as M
    n = torch.cuda.device_count()
    grid = (M.make_train_mesh(n // 2, 2, device=GPU) if n >= 2
            else replica_grid())
    dev0 = grid[0][0]
    cells = M.shard_params_tp(params, grid)
    f64 = torch.float64
    specs, labels = labeled(32, seed=12)
    images = train.specs_to_images(specs, device=dev0)
    y = torch.from_numpy(labels).to(dev0)
    gens = {d: torch.Generator(device=d) for row in grid for d in row}
    model = AlexNet.trainable(params, device=dev0)
    with plain_kernels():
        _, mstep = train.make_mesh_train_step(cells, learning_rate=5e-3,
                                              clip_norm=1.0, keep_prob=1.0,
                                              compute_dtype=f64)
        mloss = float(mstep(images, y, gens))
        _, step = train.make_train_step(model, learning_rate=5e-3,
                                        clip_norm=1.0, keep_prob=1.0,
                                        compute_dtype=f64)
        loss = float(step(images, y, torch.Generator(device=dev0)))
    want = params_to_numpy({k: v.grad for k, v in model.named_parameters()})
    got = M.gather_params([[{k: t.grad for k, t in c.items()}
                            for c in cells[0]]])
    err = {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
           for k in want}
    assert abs(mloss - loss) <= 1e-6 * abs(loss), (mloss, loss)
    assert max(err.values()) <= 1e-5, err
    split = tuple(cells[0][0]["fc6.weight"].shape)
    assert split == (4096 // 2, 9216), split
    devices = len({d for row in grid for d in row})
    log(f"DP x TP step on a {len(grid)}x2 grid of {devices} GPU(s): loss "
        f"{mloss} vs {loss}, worst grad rel err {max(err.values()):.3g}, fc6 "
        f"split {split}")
    return {"grid": [len(grid), 2], "devices": devices, "loss": mloss,
            "one_device_loss": loss, "grad_rel_err": err}


def check_trained_cli(fx: dict, work: str) -> dict:
    """The mini closed loop: build_dataset(n_per_type=4), two epochs of
    fit_device (s2d, f32), evaluate, save; the trained weights then go
    through phase 4's CLI once in the default mode, which must write a
    VCF. Every run's launches are held."""
    from svision_tpu_torch import cli
    from svision_tpu_torch.models.alexnet import init_params
    from svision_tpu_torch.models.checkpoint import save_params
    from svision_tpu_torch.models.dataset import build_dataset
    from svision_tpu_torch.models.train import evaluate, fit_device
    out = {"runs": {}}
    t0 = time.perf_counter()
    specs, labels, _ = build_dataset(n_per_type=4, seed=11)
    out["dataset_s"] = time.perf_counter() - t0
    bs = 32
    steps = len(labels) // bs
    with counted_steps("mini loop fit_device", "fit_device_s2d",
                       2 * steps) as r:
        trained, hist = fit_device(init_params(0), specs, labels, epochs=2,
                                   batch_size=bs, seed=1, device=GPU)
    assert np.isfinite(hist).all(), hist
    out["runs"]["train_fit_device_loop"] = r
    batches = -(-len(labels) // 64)
    with counted_steps("evaluate", "evaluate", batches) as r:
        acc = evaluate(trained, specs, labels, device=GPU)
    out["runs"]["train_evaluate"] = r
    weights = os.path.join(work, "trained.npz")
    save_params(trained, weights)
    with counted() as r:
        vcf = cli.run_pipeline(cli.parse_arguments(
            ["-o", os.path.join(work, "trained_cli"), "-b", fx["bam"],
             "-g", fx["genome"], "-m", weights, "-n", "synthsample",
             "-s", "3"]))
    assert os.path.exists(vcf), f"the trained weights' CLI run wrote no {vcf}"
    hold_launches("trained cli", "default", r, warmups=warmup_batches(),
                  devices=mesh_devices())
    out["runs"]["cli_trained"] = r
    out.update(examples=len(labels), history=hist, train_acc=acc,
               vcf_records=len(_records(vcf)))
    log(f"mini closed loop: {len(labels)} examples in "
        f"{out['dataset_s']:.1f} s, fit_device loss {hist}, train acc "
        f"{acc:.3f}, CLI with the trained weights wrote {vcf} "
        f"({out['vcf_records']} records)")
    return out


def check_training(params, fx: dict, work: str) -> dict:
    out, seconds = {}, {}
    for name, check in (("step_vs_cpu", check_train_step),
                        ("graph_steps", check_graph_steps),
                        ("bf16_loss", check_bf16_loss),
                        ("rates", train_rates),
                        ("profile", profile_train_step),
                        ("dp_tp", check_dp_tp),
                        ("mesh_graph_steps", check_mesh_graph_steps),
                        ("mini_loop", lambda p: check_trained_cli(fx, work))):
        t0 = time.perf_counter()
        out[name] = check(params)
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    log(f"phase 7 seconds by check: {seconds}")
    out["runs"] = {f"train_{k}": v for k, v in out["rates"].items()}
    out["runs"].update({f"train_fit_mesh_{k}": v["fit"]
                        for k, v in out["mesh_graph_steps"].items()})
    out["runs"].update(out["mini_loop"]["runs"])
    return out


# ---------------------------------------------------------------------------
# phase 9: the benchmark, accuracy and profiling tools, the graft entry
# ---------------------------------------------------------------------------

def agreement(p, s, want_p, want_s) -> dict:
    """Argmax agreement of two runs, and the max and median difference of
    their selected softmax."""
    d = np.abs(s - want_s)
    return dict(argmax_agreement=float((p == want_p).mean()),
                max_softmax_err=float(d.max()),
                median_softmax_err=float(np.median(d)))


def bar_weights() -> dict:
    """The weights tests/test_torch_engine_modes.py sets its bf16 bar on:
    init_params(0) at half scale with small random biases (at full scale
    bf16 rounding moves the softmax of a near tie by more than the bar)."""
    from svision_tpu_torch.models.alexnet import init_params
    rng = np.random.RandomState(0)
    return {k: (v * np.float32(0.5) if k.endswith("weights")
                else v + rng.normal(0, 0.05, v.shape).astype(np.float32))
            for k, v in init_params(0).items()}


def entry_f32_witness(args, args_c, s, s_c) -> dict:
    """entry()'s default weights (init_params(0) at full scale) give logits
    near 100, so bf16 rounding moves a near tie's max softmax by more than
    the bf16 bar. The witness: the same images (K1 on the card, its plain
    version on the CPU) through the f32 network (TF32 off) on both, held
    to argmax equality and 1e-3 in max softmax; and the card's bf16 max
    softmax (s) no farther from the CPU's (s_c) than the CPU's bf16 is
    from its own f32. Reports the worst spec's top-2 logit gap."""
    import torch
    from svision_tpu_torch.infer.engine import exact_f32
    from svision_tpu_torch.models.alexnet import AlexNet, init_params
    from svision_tpu_torch.ops.raster_kernel import render_images
    logits = []
    for a in (args, args_c):
        _, ep, vis, rev = a
        model = AlexNet.from_params(init_params(0), device=ep.device)
        with torch.inference_mode(), exact_f32():
            logits.append(model(render_images(
                ep, vis, rev, dtype=torch.float32)).cpu())
    (p32, s32), (p32_c, s32_c) = (
        (x.argmax(dim=1).numpy(), torch.softmax(x, dim=1).amax(dim=1).numpy())
        for x in logits)
    f32 = agreement(p32, s32, p32_c, s32_c)
    top2 = torch.topk(logits[1], 2, dim=1).values.numpy()
    worst = int(np.argmax(np.abs(s - s_c)))
    out = dict(f32_card_vs_cpu=f32,
               cpu_bf16_vs_f32_max=float(np.abs(s_c - s32_c).max()),
               card_bf16_vs_f32_max=float(np.abs(s - s32).max()),
               max_abs_logit=float(logits[1].abs().max()),
               worst_spec=dict(index=worst,
                               top2_logit_gap=float(top2[worst, 0]
                                                    - top2[worst, 1]),
                               card_bf16=float(s[worst]),
                               cpu_bf16=float(s_c[worst]),
                               card_f32=float(s32[worst]),
                               cpu_f32=float(s32_c[worst])))
    assert f32["argmax_agreement"] == 1.0 and f32["max_softmax_err"] <= 1e-3, out
    assert float(np.abs(s - s_c).max()) <= out["cpu_bf16_vs_f32_max"], out
    return out


def check_tools(work: str) -> dict:
    """Phase 9: the port's tools on the card, each run's launches counted:
    torch_e2e_bench.py at 1 x 1 Mb (its report printed, its VCF
    truvari-scored against itself: f1 must be 1.0); torch_roofline.py at
    batch 128 (every prefix's time > 0, every section's after K3 too, and
    the FLOPs per image); the graft entry's fused step against its CPU
    run: at the bf16 bar on bar_weights(), and on its default weights
    through entry_f32_witness; and dryrun_multichip(1)."""
    import importlib
    sys.path.append(os.path.join(ROOT, "scripts"))
    import torch_e2e_bench
    import torch_roofline
    from svision_tpu_torch.truvari import bench as truvari_bench
    graft = importlib.import_module("__graft_entry_torch__")
    out, runs, seconds = {}, {}, {}

    t0 = time.perf_counter()
    with counted() as r:
        rep = torch_e2e_bench.main(["--chroms", "1", "--mb", "1", "--keep",
                                    os.path.join(work, "e2e")])
    hold_launches("torch_e2e_bench", "default", r,
                  warmups=warmup_batches(), devices=mesh_devices())
    self_score = truvari_bench(rep["vcf"], rep["vcf"], sizefilt=50)
    assert self_score["base_cnt"] == self_score["comp_cnt"] > 0 \
        and self_score["f1"] == 1.0, self_score
    log(f"e2e VCF against itself: {self_score['comp_cnt']} calls, "
        f"f1 {self_score['f1']}")
    out["e2e"], runs["tools_e2e"] = dict(rep, truvari_self=self_score), r
    seconds["e2e"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with counted() as r:
        roof = torch_roofline.main(["--batch", str(B)])
    secs = roof["sections"]
    assert all(x["cum_ms"] > 0 for x in secs) and all(
        x["section_ms"] > 0 for x in secs[2:]), secs
    assert roof["flops_per_image"] == torch_roofline.stage_flops(
        len(torch_roofline.STAGES) - 1)
    # the default engine's kernels, in the prefixes' replays
    assert all(r["launches"][k] > 0 for k, v in PER_BATCH["default"].items()
               if v), r["launches"]
    log(f"roofline at batch {B}: {roof['flops_per_image']} FLOPs an image")
    out["roofline"], runs["tools_roofline"] = roof, r
    # the exact step by stage, by both routes (K1 and cuDNN; K3 in f32): a
    # measurement, not a main-path run, so its launches stay off the line
    with counted() as r:
        roof = torch_roofline.main(["--batch", str(B), "--exact"])
    assert all(x["cum_ms"] > 0 for x in roof["sections"]), roof["sections"]
    # every kernel of the step; no training, and no endpoints kernel: the
    # step's prefixes take endpoints made on the host
    assert all((r["launches"][k] > 0) == (
        k not in ("bias_relu_pool_lrn_backward", "specs_endpoints",
                  "bias_relu_pool_lrn_halves", *MOE_WRAPPERS))
               for k in r["launches"]), r["launches"]
    out["roofline_exact"] = dict(roof, launches=r["launches"])
    seconds["roofline"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["entry"] = {}
    for weights, params in (("default", None), ("bar", bar_weights())):
        with counted() as r:
            fn, args = graft.entry(params=params)
            p, s = (o.cpu().numpy() for o in fn(*args))
        # one batch of the engine's fast=False step
        assert r["launches"] == PER_BATCH["unfolded_bf16"], r["launches"]
        runs[f"tools_entry_{weights}"] = r
        fn_c, args_c = graft.entry("cpu", params=params)
        p_c, s_c = (o.numpy() for o in fn_c(*args_c))
        assert p.shape == s.shape == (16,) and np.isfinite(s).all()
        out["entry"][weights] = agreement(p, s, p_c, s_c)
        if weights == "default":
            out["entry"]["default_f32"] = entry_f32_witness(
                args, args_c, s, s_c)
    log(f"entry(): card vs CPU {out['entry']}")
    # tests/test_torch_engine_modes.py's bf16 bar, on the weights it was
    # set on; on the default weights the f32 witness is held instead
    bar = out["entry"]["bar"]
    assert (bar["argmax_agreement"] >= 0.9 and bar["max_softmax_err"] <= 0.02
            and bar["median_softmax_err"] <= 0.004), bar
    seconds["entry"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with counted() as r:
        graft.dryrun_multichip(1)
    # the exact and the default engines' kernels
    assert all(r["launches"][k] > 0 for k in r["launches"]
               if PER_BATCH["exact"][k] or PER_BATCH["default"][k]), \
        r["launches"]
    runs["tools_dryrun"] = r
    log(f"dryrun_multichip(1) ok, launches {r['launches']}")
    seconds["dryrun"] = time.perf_counter() - t0

    out["runs"], out["seconds"] = runs, seconds
    log(f"phase 9 seconds by check: {seconds}")
    return out


# ---------------------------------------------------------------------------
# phase 10: V-MoE-B/16
# ---------------------------------------------------------------------------

# the benchmark's V-MoE configuration: its widths, and its weights' seeding
# and fit (benchmark/drivers/engine_vmoe.py)
VMOE_CONFIG = "svision-vmoe-b16-e32-bf16"
MOE_SOURCE = "svision_tpu_torch/csrc/moe.cu"


def vmoe_logits(case: str, t: int, e: int, seed: int = 0):
    """Router logits f32 [t,e] on the card: 'skewed' (nine tenths of the
    tokens on experts 7 and 11, as blank patches route, and expert 5 given
    no row) or 'even' (random)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((t, e), generator=g)
    if case == "skewed":
        x[: t * 9 // 10, 7] += 6.0
        x[: t * 9 // 10, 11] += 5.0
        x[:, 5] = -1e4
    return x.cuda()


def check_moe_kernels(m: dict) -> dict:
    """The four MoE kernels (ops/moe.py) against their plain versions on
    the card at the engine's batch of B images of the V-MoE's widths m,
    on skewed routing with an empty expert and on even routing: the
    route's experts, ranks, bases and offsets bit for bit and its gates
    within f32 rounding of exp and the softmax's sum (2e-6 relative);
    dispatch and combine bit for bit; the bias-GELU within one bf16 step
    (the card's erff and torch's erf may round an f32 apart). Each timed
    (median of spread_ms) against its least time (work_vmoe.route_stages'
    bytes; the route's, latency-bound, its tensors' bytes), beside its
    plain version and one PyTorch call that does part of its work
    (`library`)."""
    import torch
    import torch.nn.functional as F
    from benchmark import work_vmoe
    from benchmark.work_vit import tokens
    from svision_tpu_torch.ops import moe
    t, d, mm = B * tokens(m), m["hidden"], m["mlp"]
    e, k = m["experts"], m["top_k"]
    stages = work_vmoe.route_stages(m, B, "bfloat16")
    g = torch.Generator(device="cpu").manual_seed(1)

    def draw(*shape):
        return torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
    u, y, b1, b2 = draw(t, d), draw(t, d), draw(e, mm), draw(e, d)
    out = {name: [] for name in ("moe_route", "moe_dispatch",
                                 "moe_bias_gelu", "moe_combine")}

    def row(name, case, err, fn, plain, library, lib_name, bound):
        b, by = least(bound, "float32")
        ms = spread_ms([fn])["median"]
        out[name].append(dict(
            dtype="bfloat16", case=case, rows=B, shape=[t, d, mm, e, k],
            max_abs_err=err, ms=ms,
            plain_ms=time_ms(plain, reps=PLAIN_REPS),
            library_ms=spread_ms([library])["median"], library=lib_name,
            bound_ms=b, bound_by=by, bound_fraction=b / ms))
        log(f"{name} ({case}): {out[name][-1]}")

    for case in ("skewed", "even"):
        logits = vmoe_logits(case, t, e)
        rows = torch.zeros(e, dtype=torch.int64, device="cuda")
        got = moe.moe_route(logits, k, rows)
        want_rows = torch.zeros_like(rows)
        want = moe.moe_route_plain(logits, k, want_rows)
        for name, a, w in zip(("top", "gates", "ranks", "bases", "offsets"),
                              got, want):
            if name == "gates":
                torch.testing.assert_close(a, w, rtol=2e-6, atol=1e-30)
            else:
                assert torch.equal(a, w), f"moe_route ({case}): {name}"
        assert torch.equal(rows, want_rows) and int(rows.sum()) == t * k
        if case == "skewed":
            assert int(rows[5]) == 0 and int(rows.max()) > t // 2, rows
        top, gates, ranks, bases, offsets = got
        route_bytes = sum(x.nbytes for x in (logits, *got, rows))
        row("moe_route", case, float((got[1] - want[1]).abs().max()),
            lambda: moe.moe_route(logits, k),
            lambda: moe.moe_route_plain(logits, k),
            lambda: torch.topk(logits, k), "torch.topk", (route_bytes, 0))

        xs, slots = moe.moe_dispatch(u, top, ranks, bases)
        want_xs, want_slots = moe.moe_dispatch_plain(u, top, ranks, bases)
        assert torch.equal(xs, want_xs) and torch.equal(slots, want_slots), \
            f"moe_dispatch ({case})"
        src = torch.empty(t * k, dtype=torch.int64, device="cuda")
        src[slots.reshape(-1).long()] = torch.arange(
            t, device="cuda").repeat_interleave(k)
        row("moe_dispatch", case, 0.0,
            lambda: moe.moe_dispatch(u, top, ranks, bases),
            lambda: moe.moe_dispatch_plain(u, top, ranks, bases),
            lambda: u.index_select(0, src), "torch.index_select",
            stages["dispatch"])

        h = draw(t * k, mm)
        want_h = moe.moe_bias_gelu_plain(h.clone(), b1, offsets)
        got_h = moe.moe_bias_gelu(h.clone(), b1, offsets)
        torch.testing.assert_close(got_h.float(), want_h.float(),
                                   rtol=2 ** -7, atol=1e-30)
        assert float((got_h != want_h).float().mean()) < 1e-3, case
        row("moe_bias_gelu", case,
            float((got_h.float() - want_h.float()).abs().max()),
            lambda: moe.moe_bias_gelu(h, b1, offsets),
            lambda: moe.moe_bias_gelu_plain(h, b1, offsets),
            lambda: F.gelu(h), "torch.nn.functional.gelu",
            stages["bias_gelu"])

        h2 = draw(t * k, d)
        assert torch.equal(moe.moe_combine(y, h2, b2, top, gates, slots),
                           moe.moe_combine_plain(y, h2, b2, top, gates,
                                                 slots)), \
            f"moe_combine ({case})"
        flat = slots.reshape(-1).long()
        row("moe_combine", case, 0.0,
            lambda: moe.moe_combine(y, h2, b2, top, gates, slots),
            lambda: moe.moe_combine_plain(y, h2, b2, top, gates, slots),
            lambda: h2.index_select(0, flat), "torch.index_select",
            stages["combine"])
    return out


def check_vmoe(seed: int = 2_000_001) -> dict:
    """Phase 10: V-MoE-B/16 at its published widths (the benchmark's
    configuration VMOE_CONFIG and its fitted weights of `seed`). The MoE
    kernels against their plain versions (check_moe_kernels); then the
    default engine on those weights, warmed up: its launch counts zeroed,
    a graphed call on 8,192 specs and the eager step on them, bit for bit
    alike, K1 once a batch, each MoE kernel once a sparse layer a batch
    and the endpoints kernel once a dispatch; expert_rows() every routed
    row of the two once (the load on each expert); images/s graphed."""
    import torch
    from benchmark import spec
    from benchmark.drivers import engine_vmoe
    from benchmark.work_vit import tokens
    from svision_tpu_torch.infer.engine import InferenceEngine
    m = spec.config(spec.load(), VMOE_CONFIG)["model"]
    out = {"kernels": check_moe_kernels(m)}
    params = {k: v.cpu().numpy()
              for k, v in engine_vmoe.params(m, seed, torch.device("cuda"))
              .items()}
    t0 = time.perf_counter()
    eng = InferenceEngine(params, batch_size=B)
    assert eng.network == "vmoe_b16" and eng.compute_dtype == torch.bfloat16
    eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    eng.expert_rows()
    specs = random_specs(8192, seed=3)
    with counted() as run:
        p, s = eng.predict_specs(specs)
        with torch.inference_mode():
            ep, es = eng._predict(specs, graphed=False)
    assert np.array_equal(p, ep) and np.array_equal(s, es), \
        "V-MoE engine: graphs differ from the eager step"
    hold_launches("engine vmoe", "vmoe", run, warmups=0)
    rows = eng.expert_rows()
    routed = run["batches"]["real"] * B * tokens(m) * m["top_k"]
    assert rows.shape == (len(m["moe_layers"]), m["experts"])
    assert (rows.sum(1) == routed).all(), (rows.sum(1), routed)
    assert np.isfinite(s).all() and ((s > 0) & (s <= 1)).all()
    rate = best_rate(eng, specs)
    out["engine"] = dict(
        images_per_s=rate, warmup_s=warmup_s, launches=run["launches"],
        batches=run["batches"], k1_dtype="bf16", n=int(specs.shape[0]),
        expert_rows=rows.tolist(),
        load_max_pct=[float(100 * r.max() / r.mean()) for r in rows],
        idle_experts=[int((r == 0).sum()) for r in rows],
        class_split=np.bincount(p, minlength=5).tolist())
    log(f"engine vmoe ({REPORT['device']['nvidia_smi']}): {out['engine']}")
    del eng
    torch.cuda.empty_cache()
    return out


def moe_rows(kernels: dict, runs: dict, build: dict) -> list:
    """The kernels line's rows of the four MoE kernels: each one's
    launches in every main-path run (the V-MoE engine's alone runs them),
    its error against its plain version, and its times and bound on
    skewed routing, the traffic's (phase 10)."""
    rows = []
    for name, variants in kernels.items():
        main = next(v for v in variants if v["case"] == "skewed")
        launches = {run: r["launches"][name] for run, r in runs.items()}
        rows.append(dict(
            name=name, route="cuda", source=MOE_SOURCE, replaces=None,
            launches=sum(launches.values()), launches_by_run=launches,
            batches_by_run={run: r["batches"] for run, r in runs.items()},
            max_abs_err=max(v["max_abs_err"] for v in variants),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], library=main["library"],
            at=dict(dtype=main["dtype"], shape=main["shape"]),
            variants=variants, ptxas=build["ptxas"][MOE_SOURCE],
            note="no TPU kernel: the JAX package runs no mixture of experts"))
    return rows


# ---------------------------------------------------------------------------

def kernel_line(kernels: dict, runs: dict, build: dict) -> dict:
    """The kernels line: each kernel's launches in every main-path run of
    phases 3-9 (runs: name -> {"launches", "batches"}, and "k1_dtype" where
    K1 renders bf16), its error against its plain version, and its times
    and bound at the main path's dtype. K1 has a row per dtype: f32 on the
    exact path, bf16 on the 'pallas' engines of phase 8. K2's backward
    has no TPU kernel of its own: its row names K2's, whose function it
    differentiates (the JAX trainer leaves that gradient to XLA)."""
    info = (
        ("render_raster", "render_raster", "svision_tpu_torch/csrc/raster.cu",
         "svision_tpu/ops/pallas_raster.py:108", "f32", None),
        ("render_raster_bf16", "render_raster",
         "svision_tpu_torch/csrc/raster.cu",
         "svision_tpu/ops/pallas_raster.py:108", "bf16", None),
        ("bias_relu_pool_lrn", "bias_relu_pool_lrn",
         "svision_tpu_torch/csrc/pool_lrn.cu",
         "svision_tpu/ops/fused_pool_lrn.py:76", "bf16", "conv1"),
        ("bias_relu_pool_lrn_backward", "bias_relu_pool_lrn_backward",
         "svision_tpu_torch/csrc/pool_lrn_backward.cu",
         "svision_tpu/ops/fused_pool_lrn.py:76", "bf16", "conv1"),
        ("conv1_fused_raster", "conv1_fused_raster",
         "svision_tpu_torch/csrc/conv1_raster.cu",
         "svision_tpu/ops/fused_conv1.py:155", "bf16", None),
        ("specs_endpoints", "specs_endpoints",
         "svision_tpu_torch/csrc/specs_endpoints.cu", None, "int64", None),
    )
    rows = []
    for row, name, src, replaces, dtype, tail in info:
        main = next(v for v in kernels[name] if v["dtype"] == dtype and "ms" in v
                    and v.get("tail", tail) == tail and v.get("segs", 2) == 2
                    and "form" not in v)
        # K1's launches by the dtype each run renders in
        mine = {run: r for run, r in runs.items()
                if name != "render_raster"
                or (r.get("k1_dtype") or "f32") == dtype}
        launches = {run: r["launches"][name] for run, r in mine.items()}
        errs = [v["max_abs_err"] for v in kernels[name]
                if name != "render_raster" or v["dtype"] == dtype]
        rows.append(dict(
            name=row, route="cuda", source=src, replaces=replaces,
            launches=sum(launches.values()), launches_by_run=launches,
            batches_by_run={run: r["batches"] for run, r in mine.items()},
            max_abs_err=max(errs),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=None, at=dict(dtype=dtype, shape=main["shape"]),
            **{k: main[k] for k in ("warm_ms", "cold_ms") if k in main},
            variants=kernels[name], ptxas=build["ptxas"][src]))
        if name == "conv1_fused_raster":
            rows[-1]["hgmma_in_sass"] = build["k3_hgmma"]
        if name == "specs_endpoints":
            rows[-1]["note"] = (
                "no TPU kernel: the JAX package makes the endpoints on the "
                "host (svision_tpu/ops/rasterize.py:specs_to_endpoints)")
        if name == "bias_relu_pool_lrn_backward":
            rows[-1]["note"] = (
                "the gradient of K2's function; the JAX package has no "
                "backward kernel: its trainer differentiates "
                "svision_tpu/models/train.py:44-47 through XLA")
    return {"kernels": rows}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="write the full JSON report here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import svision_tpu_torch
    pkg = os.path.dirname(os.path.abspath(svision_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        print(f"chip_smoke: svision_tpu_torch resolves to {pkg}, not this "
              "checkout", file=sys.stderr)
        return 1
    from svision_tpu_torch.models.alexnet import init_params
    from svision_tpu_torch.ops import _kernels

    t_all = time.perf_counter()
    smi = nvidia_smi()
    log(f"device: {smi}")
    REPORT["device"] = dict(nvidia_smi=smi, name=torch.cuda.get_device_name(0),
                            torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    dense_proc, dense_lib = start_dense_k3_build(
        os.path.join(ROOT, "build", "k3_dense"))
    try:
        libs = _kernels.build()
    finally:
        dense_log = dense_proc.communicate()[0].decode(errors="replace")
    assert dense_proc.returncode == 0, f"dense K3 build failed:\n{dense_log}"
    build = dict(build_s=time.perf_counter() - t0, ptxas={})
    log(f"phase 1: built {sorted(libs)} and K3 without its dark-step skip "
        f"in {build['build_s']:.1f} s")
    for src, path in sorted(libs.items()):
        # ptxas's register and spill lines, per kernel (the library's name
        # carries a hash of its sources)
        build["ptxas"][f"svision_tpu_torch/csrc/{src}"] = found = \
            ptxas_by_kernel(path + ".log")
        for kernel, lines in found.items():
            for line in lines:
                log(f"  ptxas {src} {kernel}: {line}")
    build["k3_hgmma"] = hgmma_count(libs["conv1_raster.cu"])
    assert build["k3_hgmma"] > 0, "K3: no HGMMA (wgmma) in its SASS"
    log(f"  K3 SASS: {build['k3_hgmma']} HGMMA instructions")
    from svision_tpu_torch.io import native_io
    t0 = time.perf_counter()
    assert native_io.ensure_built(), "the native BAM decoder did not build"
    build["native_io_build_s"] = time.perf_counter() - t0
    log(f"  native BAM decoder built in {build['native_io_build_s']:.1f} s")
    REPORT["build"] = build

    params = init_params(0)
    REPORT["kernels"] = check_kernels(params, k3_from(dense_lib))
    log("phase 2: kernels agree with their plain versions")
    REPORT["engine"] = check_engine(params)
    log("phase 3: engine agrees with the all-plain engine")
    REPORT["profile"] = profile_engine(params)
    with tempfile.TemporaryDirectory() as work:
        fx = make_fixtures(params, work)
        t0 = time.perf_counter()
        REPORT["cli"] = check_cli(fx, work)
        log(f"phase 4: CLI path ok ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        REPORT["installed"] = check_installed(fx, work, REPORT["cli"]["vcf"])
        log(f"phase 4b: the installed command ok "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        REPORT["serve"] = check_serve(fx, work,
                                      REPORT["cli"]["default"]["wall_s"])
        log(f"phase 5: serving ok ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        REPORT["shards"] = check_shards(fx, work, REPORT["serve"]["solo"])
        log(f"phase 6: sharding and cohorts ok "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        REPORT["train"] = check_training(params, fx, work)
        log(f"phase 7: training ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    REPORT["modes"] = check_modes(params)
    log(f"phase 8: the engine's other modes ok "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        REPORT["tools"] = check_tools(work)
    log(f"phase 9: the tools ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    REPORT["vmoe"] = check_vmoe()
    log(f"phase 10: the V-MoE ok ({time.perf_counter() - t0:.1f} s)")
    REPORT["total_s"] = time.perf_counter() - t_all
    log(f"chip_smoke: {REPORT['total_s']:.1f} s in all")

    runs = {f"engine_{k}": REPORT["engine"][k] for k in ("bf16", "exact")}
    runs.update({f"cli_{k}": REPORT["cli"][k] for k in ("default", "exact")})
    runs.update(REPORT["cli"]["runs"])
    runs.update(REPORT["serve"]["runs"])
    runs.update(REPORT["shards"]["runs"])
    runs.update(REPORT["train"]["runs"])
    runs.update({f"engine_{k}": REPORT["modes"][k] for k in MODES})
    runs.update(REPORT["tools"]["runs"])
    runs["engine_vmoe"] = REPORT["vmoe"]["engine"]
    line = kernel_line(REPORT["kernels"], runs, build)
    line["kernels"] += moe_rows(REPORT["vmoe"]["kernels"], runs, build)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(REPORT, f, indent=1)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
