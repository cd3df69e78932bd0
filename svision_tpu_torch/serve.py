"""Persistent calling service: load the model ONCE, serve many requests.

Counterpart of the JAX package's serve.py, on the PyTorch engine. The
reference rebuilds its TF1 graph and restores the checkpoint on every
`SVision` invocation (predict.py:155-189). This module keeps a warm
`InferenceEngine` (weights resident on the GPU, kernels built, cuDNN set
up) in one long-lived process and runs the full calling pipeline per
request, so per-request latency is collection + inference only.

Protocol: one JSON object per line on stdin, one JSON reply per line on
stdout.

    {"bam": "s.bam", "out": "outdir", "sample": "S1"}
    {"bam": "s.bam", "out": "o2", "sample": "S2", "region": "chr1:1-500000",
     "min_support": 3, "args": ["--graph", "--qname"]}

Per-request "args" may NOT change engine-fixed settings (--exact, --device,
--batch_size, --mesh) — those are rejected, not silently ignored.
    {"cmd": "ping"}
    {"cmd": "shutdown"}

Reply: {"ok": true, "vcf": ..., "records": N, "wall_s": T} or
{"ok": false, "error": "..."}; a request's "id" field (any JSON value) is
echoed back in its reply. Requests are processed sequentially (the GPU is
a serial resource). Nothing reaches stdout before the ready banner
{"ready": true, ...}: stdout is the protocol channel.

Concurrent clients: `--socket PATH` serves the same line protocol over a
Unix domain socket. Each connection gets a reader thread; one worker
serializes pipeline execution through a FIFO queue, so requests run in
arrival order and each connection's replies come back in ITS request
order. A malformed line errors only its own connection; "shutdown" (from
any client) drains every request queued before it, replies to each, then
exits — requests racing in after the shutdown see EOF.

Start:  python -m svision_tpu_torch.serve -g ref.fa -m model.npz
        [--batch_size 128] [--mesh auto] [-t 2] [--exact] [--device cpu]
        [--socket PATH]
Without a GPU the server exits before its banner unless given --device cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def build_engine(ns):
    """The warm engine: weights on ns.device (and the --mesh devices),
    kernels built, one sentinel batch run and, on the card, the dispatch
    plan's CUDA graphs captured (InferenceEngine.warmup)."""
    from svision_tpu_torch.infer.engine import InferenceEngine
    from svision_tpu_torch.models.checkpoint import load_params
    from svision_tpu_torch.parallel.mesh import resolve_mesh

    params = load_params(ns.model_path)
    engine = InferenceEngine(params, batch_size=ns.batch_size,
                             bf16=not ns.exact, device=ns.device,
                             devices=resolve_mesh(ns.mesh, ns.device))
    engine.warmup()
    return engine


# request args that would silently disagree with the warm engine's fixed
# configuration — rejected instead of accepted-and-ignored — plus the
# pipeline-mode flags that divert run_pipeline into shard/distributed/
# profiling branches which bypass the warm engine (a --num_shards request
# without --merge_shards would even "succeed" while returning a fragment
# directory instead of a VCF)
_ENGINE_FLAGS = ("--exact", "--device", "--batch_size", "--mesh",
                 "--num_shards", "--shard_id", "--merge_shards",
                 "--coordinator", "--profile")


def handle_request(req: dict, ns, engine) -> dict:
    import logging

    from svision_tpu_torch.cli import parse_arguments, run_pipeline

    t0 = time.perf_counter()
    if req.get("cmd") == "ping":
        return {"ok": True, "pong": True}
    for key in ("bam", "out", "sample"):
        if key not in req:
            return {"ok": False, "error": f"missing field {key!r}"}
    extra = [str(a) for a in req.get("args", [])]
    clash = [f for f in _ENGINE_FLAGS if any(a.startswith(f) for a in extra)]
    if clash:
        return {"ok": False,
                "error": f"{clash} are fixed at server startup (the warm "
                         "engine is built once); restart the server to "
                         "change them"}
    args = ["-o", req["out"], "-b", req["bam"], "-g", ns.genome,
            "-m", ns.model_path, "-n", req["sample"],
            "-s", str(req.get("min_support", ns.min_support)),
            "-t", str(ns.thread_num), "--batch_size", str(ns.batch_size)]
    if req.get("region"):
        args += ["-c", req["region"]]
    args += extra
    options = parse_arguments(args)
    os.makedirs(options.out_path, exist_ok=True)
    # fresh log handlers per request, so each request's pipeline log lands
    # in ITS out dir (basicConfig in run_pipeline is a no-op once the root
    # logger has handlers)
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    # the pipeline prints diagnostics to stdout; stdout is this server's
    # PROTOCOL channel, so route them to stderr
    with contextlib.redirect_stdout(sys.stderr):
        vcf = run_pipeline(options, engine=engine)
    n = sum(1 for line in open(vcf) if not line.startswith("#")) \
        if vcf.endswith(".vcf") else None
    return {"ok": True, "vcf": vcf, "records": n,
            "wall_s": round(time.perf_counter() - t0, 2)}


def _safe_handle(req: dict, ns, engine) -> dict:
    """handle_request with the server's survival guarantees + id echo."""
    try:
        out = handle_request(req, ns, engine)
    except SystemExit as exc:           # pipeline abort (bad BAM, ...)
        out = {"ok": False, "error": f"pipeline exit {exc.code}"}
    except Exception as exc:            # noqa: BLE001 — server must survive
        out = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
    if isinstance(req, dict) and "id" in req:
        out["id"] = req["id"]
    return out


def serve_socket(ns, engine, sock_path: str) -> None:
    """Unix-domain-socket front-end: N concurrent clients, one worker.

    Reader thread per connection -> FIFO queue -> single worker (the GPU
    is a serial resource) -> per-connection reply with a write lock. FIFO
    drain on shutdown gives every earlier-queued request its reply. The
    worker thread runs the engine, whose tensors all name their device, so
    nothing depends on the thread's current CUDA device."""
    import queue
    import socket
    import threading

    q: "queue.Queue" = queue.Queue()
    stop = threading.Event()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    srv.bind(sock_path)
    os.chmod(sock_path, 0o600)
    srv.listen(64)

    def reply(conn, lock, obj):
        data = (json.dumps(obj) + "\n").encode()
        with lock:
            try:
                conn.sendall(data)
            except OSError:
                pass                     # client went away; drop the reply

    def reader(conn):
        lock = threading.Lock()
        with conn, conn.makefile("r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as exc:
                    reply(conn, lock,
                          {"ok": False, "error": f"bad json: {exc}"})
                    continue
                q.put((req, conn, lock))
                if isinstance(req, dict) and req.get("cmd") == "shutdown":
                    break
            # wait for the worker to finish this connection's queued
            # requests before closing the socket (the `with` would cut
            # replies off otherwise); bounded — after a shutdown the
            # worker is gone and the marker is never serviced
            done = threading.Event()
            q.put((None, None, done))
            done.wait(timeout=600)

    def worker():
        while True:
            req, conn, lock = q.get()
            if req is None:
                lock.set()               # connection-drain marker
                continue
            if isinstance(req, dict) and req.get("cmd") == "shutdown":
                reply(conn, lock, {"ok": True, "bye": True})
                stop.set()
                try:                     # unblock the accept loop
                    poke = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    poke.connect(sock_path)
                    poke.close()
                except OSError:
                    pass
                return
            reply(conn, lock, _safe_handle(req, ns, engine))

    wt = threading.Thread(target=worker, daemon=True)
    wt.start()
    print(json.dumps({"ready": True, "pid": os.getpid(),
                      "socket": sock_path}), flush=True)
    try:
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                break
            if stop.is_set():
                conn.close()
                break
            threading.Thread(target=reader, args=(conn,),
                             daemon=True).start()
    finally:
        srv.close()
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass
    wt.join(timeout=5)


def parse_arguments(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="svision-tpu persistent calling service (PyTorch/CUDA)")
    ap.add_argument("-g", dest="genome", type=os.path.abspath, required=True)
    ap.add_argument("-m", dest="model_path", type=os.path.abspath,
                    required=True)
    ap.add_argument("-s", dest="min_support", type=int, default=5)
    ap.add_argument("-t", dest="thread_num", type=int, default=1)
    ap.add_argument("--batch_size", type=int, default=128,
                    help="rows a batch on each --mesh device")
    ap.add_argument("--mesh", default="auto")
    ap.add_argument("--exact", action="store_true",
                    help="f32 reference-faithful numerics (default bf16)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the warm engine (default: %(default)s; "
                         "cpu runs the kernels' plain PyTorch versions)")
    ap.add_argument("--socket", default=None,
                    help="serve the line protocol on a Unix domain socket "
                         "(N concurrent clients) instead of stdin/stdout")
    return ap.parse_args(argv)


def main(argv=None):
    ns = parse_arguments(argv)
    # the engine build prints nothing on purpose; whatever a library might
    # print must not precede the banner on the protocol channel
    with contextlib.redirect_stdout(sys.stderr):
        engine = build_engine(ns)
    if ns.socket:
        serve_socket(ns, engine, ns.socket)
        return
    print(json.dumps({"ready": True, "pid": os.getpid()}), flush=True)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as exc:
            print(json.dumps({"ok": False, "error": f"bad json: {exc}"}),
                  flush=True)
            continue
        if req.get("cmd") == "shutdown":
            print(json.dumps({"ok": True, "bye": True}), flush=True)
            return
        print(json.dumps(_safe_handle(req, ns, engine)), flush=True)


if __name__ == "__main__":
    main()
