"""The port's persistent calling service (svision_tpu_torch/serve.py) on
the CPU: one warm --exact --device cpu engine, many requests. A served VCF
equals the port's own CLI run byte for byte and matches the JAX package's
--exact VCF under test_torch_pipeline's rule; the stdin server keeps its
protocol channel clean and survives bad requests; the socket server serves
concurrent clients in FIFO order; and without a GPU the server exits before
its banner unless asked for the CPU."""
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import jax
import pytest
import torch

from svision_tpu import cli as jax_cli
from svision_tpu.models import alexnet as ja
from svision_tpu_torch import cli as port_cli
from svision_tpu_torch import serve
from svision_tpu_torch import sim
from svision_tpu_torch.models.checkpoint import save_params
from tests.test_torch_pipeline import assert_vcf_match

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def serve_ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    genome = str(root / "ref.fa")
    seqs = sim.make_genome(genome, {"chr1": 90000}, seed=17)
    bams = [str(root / "a.bam"), str(root / "b.bam")]
    sim.make_sv_bam(bams[0], seqs, seed=17, support=7,
                    events=[("DEL", "chr1", 30000, 280)])
    sim.make_sv_bam(bams[1], seqs, seed=18, support=7,
                    events=[("INS", "chr1", 50000, 200)])
    weights = str(root / "w.npz")
    save_params({k: np.asarray(v) for k, v in
                 ja.init_params(jax.random.PRNGKey(0)).items()}, weights)
    ws = dict(root=root, genome=genome, bams=bams, weights=weights)
    # standalone runs: the port's CLI for each BAM, the JAX package's for
    # the first
    ws["cli_vcfs"] = [port_cli.run_pipeline(port_cli.parse_arguments(
        _cli_args(ws, str(root / f"cli{i}"), bam, f"S{i}")
        + ["--device", "cpu"])) for i, bam in enumerate(bams)]
    ws["jax_vcf"] = jax_cli.run_pipeline(jax_cli.parse_arguments(
        _cli_args(ws, str(root / "jax"), bams[0], "S0")))
    return ws


def _cli_args(ws, out, bam, sample):
    return ["-o", out, "-b", bam, "-g", ws["genome"], "-m", ws["weights"],
            "-n", sample, "-s", "3", "--batch_size", "16", "--exact"]


def _serve_args(ws, extra=()):
    return ["-g", ws["genome"], "-m", ws["weights"], "-s", "3",
            "--batch_size", "16", "--exact", *extra]


class StdinServer:
    """python -m svision_tpu_torch.serve over pipes."""

    def __init__(self, args, errlog):
        self.err = open(errlog, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "svision_tpu_torch.serve", *args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.err,
            text=True, cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2"))

    def line(self) -> dict:
        return json.loads(self.proc.stdout.readline())

    def ask(self, req) -> dict:
        self.proc.stdin.write((req if isinstance(req, str)
                               else json.dumps(req)) + "\n")
        self.proc.stdin.flush()
        return self.line()

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.err.close()


@pytest.fixture(scope="module")
def server(serve_ws):
    srv = StdinServer(_serve_args(serve_ws, ["--device", "cpu"]),
                      serve_ws["root"] / "server.err")
    srv.banner = srv.line()        # the first line on stdout
    yield srv
    srv.close()


def test_banner_is_the_first_line(server):
    assert server.banner == {"ready": True, "pid": server.proc.pid}


def test_served_request_matches_cli_and_jax(server, serve_ws, tmp_path):
    rep = server.ask({"bam": serve_ws["bams"][0], "out": str(tmp_path / "r"),
                      "sample": "S0", "id": 7})
    assert rep["ok"] and rep["id"] == 7 and rep["records"] >= 1, rep
    assert open(rep["vcf"]).read() == open(serve_ws["cli_vcfs"][0]).read()
    assert_vcf_match(rep["vcf"], serve_ws["jax_vcf"])


def test_empty_callset_gives_a_clean_error_line(server, serve_ws, tmp_path):
    """The pipeline's 'Empty output in the score file' print goes to
    stderr; stdout carries one JSON error line."""
    rep = server.ask({"bam": serve_ws["bams"][0], "out": str(tmp_path / "e"),
                      "sample": "S", "region": "chr1:1-2000"})
    assert rep["ok"] is False and "exit" in rep["error"]


@pytest.mark.parametrize("args", [
    ["--exact"], ["--device", "cuda"], ["--num_shards", "2"], ["--mesh", "2"],
    ["--batch_size=8"], ["--coordinator", "127.0.0.1:1"]])
def test_engine_flags_are_rejected(server, serve_ws, tmp_path, args):
    rep = server.ask({"bam": serve_ws["bams"][0], "out": str(tmp_path / "f"),
                      "sample": "S", "args": args})
    assert rep["ok"] is False and args[0].split("=")[0] in rep["error"]
    assert not os.path.exists(tmp_path / "f")


def test_bad_requests_leave_the_server_alive(server, serve_ws, tmp_path):
    bad = [server.ask({"bam": "/nope/missing.bam", "out": str(tmp_path / "x"),
                       "sample": "S", "id": "m"}),
           server.ask({"out": str(tmp_path / "y"), "sample": "S"}),
           server.ask("{nonsense")]
    assert all(r["ok"] is False and r["error"] for r in bad), bad
    assert bad[0]["id"] == "m" and "'bam'" in bad[1]["error"]
    good = server.ask({"bam": serve_ws["bams"][1], "out": str(tmp_path / "g"),
                       "sample": "S1"})
    assert good["ok"], good
    assert open(good["vcf"]).read() == open(serve_ws["cli_vcfs"][1]).read()


def test_ping_and_shutdown(server):
    assert server.ask({"cmd": "ping"}) == {"ok": True, "pong": True}
    assert server.ask({"cmd": "shutdown"}) == {"ok": True, "bye": True}
    assert server.proc.wait(timeout=60) == 0


def test_without_gpu_exits_before_the_banner(serve_ws):
    """No --device cpu on a machine without a GPU: a non-zero exit and
    nothing on stdout, rather than a server on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "svision_tpu_torch.serve",
         *_serve_args(serve_ws)], stdin=subprocess.DEVNULL,
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_socket_concurrent_clients(serve_ws, tmp_path, monkeypatch):
    """Three clients with two requests each against one in-process socket
    server: replies in each connection's order with their ids, every VCF
    equal to the standalone run of its BAM, a malformed line erroring only
    its own connection, and a shutdown that drains the request queued
    before it."""
    # a relative socket path: a Unix socket's path is limited to 107 bytes,
    # which a deep temporary directory can exceed
    monkeypatch.chdir(tmp_path)
    sock_path = "svs.sock"
    ns = serve.parse_arguments(_serve_args(
        serve_ws, ["--device", "cpu", "--socket", sock_path]))
    engine = serve.build_engine(ns)
    server = threading.Thread(target=serve.serve_socket,
                              args=(ns, engine, sock_path), daemon=True)
    server.start()

    def connect():
        deadline = time.time() + 30
        while True:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                conn.connect(sock_path)
                return conn, conn.makefile("r", encoding="utf-8")
            except OSError:
                conn.close()
                if time.time() > deadline:
                    raise
                time.sleep(0.05)

    def client(t, results):
        conn, f = connect()
        with conn, f:
            for i in range(2):
                req = {"bam": serve_ws["bams"][(t + i) % 2], "sample":
                       f"S{(t + i) % 2}", "out": str(tmp_path / f"c{t}_{i}"),
                       "id": f"{t}:{i}"}
                conn.sendall((json.dumps(req) + "\n").encode())
            results.extend(json.loads(f.readline()) for _ in range(2))

    results = {t: [] for t in range(3)}
    threads = [threading.Thread(target=client, args=(t, results[t]))
               for t in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    for t in range(3):
        assert [r.get("id") for r in results[t]] == [f"{t}:0", f"{t}:1"]
        for i, r in enumerate(results[t]):
            assert r["ok"], r
            assert open(r["vcf"]).read() == \
                open(serve_ws["cli_vcfs"][(t + i) % 2]).read()

    conn, f = connect()
    with conn, f:
        conn.sendall(b"{nonsense\n")
        assert json.loads(f.readline())["ok"] is False
        conn.sendall((json.dumps({"cmd": "ping", "id": "p"}) + "\n").encode())
        assert json.loads(f.readline()) == {"ok": True, "pong": True,
                                            "id": "p"}
        req = {"bam": serve_ws["bams"][1], "out": str(tmp_path / "fin"),
               "sample": "S1", "id": "fin"}
        conn.sendall((json.dumps(req) + "\n").encode())
        conn.sendall(b'{"cmd": "shutdown"}\n')
        fin = json.loads(f.readline())
        assert fin["ok"] and fin["id"] == "fin", fin
        assert json.loads(f.readline()) == {"ok": True, "bye": True}
    server.join(timeout=60)
    assert not server.is_alive()
    assert not os.path.exists(tmp_path / sock_path)
