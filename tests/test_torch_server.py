"""The port's warm server and the CLI's extras on the CPU: ngstpu's
roundtrip, the same bytes as ngstpu's CLI through the server, ngstpu's
client against the port's server, routing before torch is imported, the
local fallback and NGSTPU_TRACE."""

import contextlib
import io
import json
import os
import pathlib
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest
import torch

from ngstpu.testing.bamfixtures import random_bam
from ngstpu.testing.fixtures import random_fastq
from ngstpu.tools.cli import main as jax_cli
from ngstpu.tools.server import call_server as jax_call_server
from ngstpu_torch.tools import cli
from ngstpu_torch.tools import fastq_count as t_fastq_count
from ngstpu_torch.tools import server as srv

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMING = re.compile(r" at \d+\.\d{3} s$")


class Server:
    """serve() in a thread on a short socket path (AF_UNIX paths hold at
    most 108 bytes, and tmp_path can be longer)."""

    def __init__(self, device: str = "cpu"):
        self.dir = tempfile.mkdtemp(dir="/tmp", prefix="ngt")
        self.sock = os.path.join(self.dir, "s")
        self.thread = threading.Thread(target=srv.serve,
                                       args=(self.sock, device), daemon=True)
        self.thread.start()
        deadline = time.monotonic() + 120
        while not os.path.exists(self.sock):
            assert self.thread.is_alive(), "the server thread died"
            assert time.monotonic() < deadline, "the server never listened"
            time.sleep(0.02)

    def op(self, op: str) -> dict:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(30)
            s.connect(self.sock)
            f = s.makefile("rwb")
            f.write(json.dumps({"op": op}).encode() + b"\n")
            f.flush()
            return json.loads(f.readline())

    def stop(self) -> None:
        if self.thread.is_alive():
            assert self.op("shutdown") == {"rc": 0}
            self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        shutil.rmtree(self.dir, ignore_errors=True)


@pytest.fixture
def server():
    s = Server()
    yield s
    s.stop()


def _call(call, sock, tool, argv, capsysbinary):
    """(rc, stdout bytes, stderr bytes) of one routed call."""
    capsysbinary.readouterr()
    rc = call(sock, tool, argv, timeout=300)
    cap = capsysbinary.readouterr()
    return rc, cap.out, cap.err


def test_server_roundtrip(server, tmp_path, capsysbinary):
    """tests/test_server.py's roundtrip against the port's server: two
    calls, an unknown tool, a missing file, ping, shutdown."""
    p = tmp_path / "x.fq"
    p.write_bytes(random_fastq(100, read_len=50, seed=99))
    outs = []
    for _ in range(2):  # the second call reuses the warm process
        rc, out, _ = _call(srv.call_server, server.sock, "fastq_count",
                           [str(p)], capsysbinary)
        assert rc == 0
        assert out.startswith(str(p).encode()) and b"\t100\t" in out
        outs.append(out)
    assert outs[0] == outs[1]
    rc, _, err = _call(srv.call_server, server.sock, "nope", [], capsysbinary)
    assert rc == 2 and b"unknown tool 'nope'" in err
    rc, _, err = _call(srv.call_server, server.sock, "fastq_count",
                       [str(tmp_path / "missing.fq")], capsysbinary)
    assert rc == 1 and b"missing.fq" in err
    assert server.op("ping") == {"rc": 0}
    assert server.op("shutdown") == {"rc": 0}
    server.thread.join(timeout=30)
    assert not server.thread.is_alive()
    assert not os.path.exists(server.sock)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("served")
    (d / "n.fq").write_bytes(random_fastq(400, 60, seed=2, with_n=True,
                                          dup_frac=0.3))
    random_bam(str(d / "t.bam"), [("chr1", 30_000), ("chr2", 20_000)],
               n_reads=800, seed=7, read_len=100)
    return d


SERVED = {
    "pipeline": ["-i", "IN/n.fq", "-o", "OUT", "-e", "30"],
    "gzfastq_uniq": ["-1", "IN/n.fq"],  # both outputs to stdout
    "bam2depth": ["-W", "-w", "5000", "-o", "OUT", "IN/t.bam"],
}


@pytest.mark.parametrize("tool", list(SERVED))
def test_served_bytes_equal_ngstpu_cli(server, inputs, tool, tmp_path,
                                       monkeypatch, capsysbinary):
    """A tool through the port's server writes the same files, stdout and
    stderr (timings dropped) as ngstpu's CLI run locally."""
    monkeypatch.setenv("NGSTPU_LINK", "device")
    seen = {}
    for side in ("jax", "served"):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        argv = [a.replace("IN", str(inputs)).replace("OUT", str(d / "o"))
                for a in SERVED[tool]]
        if side == "jax":
            capsysbinary.readouterr()
            assert jax_cli([tool, *argv]) == 0
            cap = capsysbinary.readouterr()
            out, err = cap.out, cap.err
        else:
            rc, out, err = _call(srv.call_server, server.sock, tool, argv,
                                 capsysbinary)
            assert rc == 0, err
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
        err_lines = [ln.replace(str(d), "DIR")
                     for ln in err.decode().splitlines()
                     if not TIMING.search(ln)]
        seen[side] = files, out, err_lines
    assert seen["served"] == seen["jax"]
    files, out, _ = seen["served"]
    assert out if tool == "gzfastq_uniq" else files


def test_ngstpu_client_talks_to_port_server(server, inputs, capsysbinary):
    """ngstpu's call_server speaks the same protocol: the same answer as
    the port's client."""
    argv = ["-H", str(inputs / "n.fq")]
    got = _call(jax_call_server, server.sock, "fastq_count", argv,
                capsysbinary)
    want = _call(srv.call_server, server.sock, "fastq_count", argv,
                 capsysbinary)
    assert got[:2] == want[:2] and got[0] == 0
    assert got[1].startswith(b"#Filename")
    assert [ln for ln in got[2].decode().splitlines()
            if not TIMING.search(ln)] == \
        [ln for ln in want[2].decode().splitlines() if not TIMING.search(ln)]
    assert b"Finished at" in got[2]


def test_served_oom_answers_rc1(server, inputs, monkeypatch, capsysbinary):
    """A CUDA out-of-memory error in one request is rc 1 with its message;
    the server answers the next ones."""

    def oom(argv, device="cuda"):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    argv = [str(inputs / "n.fq")]
    with monkeypatch.context() as m:
        m.setattr(t_fastq_count, "main", oom)
        rc, out, err = _call(srv.call_server, server.sock, "fastq_count",
                             argv, capsysbinary)
    assert rc == 1 and out == b""
    assert b"OutOfMemoryError: CUDA out of memory (injected)" in err
    assert server.op("ping") == {"rc": 0}
    rc, out, _ = _call(srv.call_server, server.sock, "fastq_count", argv,
                       capsysbinary)
    assert rc == 0 and b"\t400\t" in out


ROUTED_CHILD = r"""
import sys

BLOCKED = ("torch", "numpy", "jax", "jaxlib", "ngstpu")


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Block())
from ngstpu_torch.tools import cli

sys.exit(cli.main(sys.argv[1:]))
"""


def test_routing_before_torch(server, inputs):
    """A CLI call routed through NGSTPU_SERVER succeeds in a process where
    importing torch (or numpy) raises, and prints the server's answer."""
    argv = ["fastq_count", "-H", str(inputs / "n.fq")]
    env = {**os.environ, "NGSTPU_SERVER": server.sock,
           "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", ROUTED_CHILD, *argv],
                       capture_output=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr.decode()[-4000:]
    local = io.StringIO()
    with contextlib.redirect_stdout(local):
        assert cli.main(["--device", "cpu", *argv]) == 0
    assert r.stdout.decode() == local.getvalue()
    assert r.stdout.startswith(b"#Filename")


def test_unreachable_server_runs_locally(inputs, monkeypatch, capsys):
    """An NGSTPU_SERVER with no server behind it: a local run, and a note
    on stderr."""
    argv = ["--device", "cpu", "fastq_count", str(inputs / "n.fq")]
    assert cli.main(argv) == 0
    want = capsys.readouterr().out
    d = tempfile.mkdtemp(dir="/tmp", prefix="ngt")
    try:
        monkeypatch.setenv("NGSTPU_SERVER", os.path.join(d, "none"))
        assert cli.main(argv) == 0
    finally:
        shutil.rmtree(d)
    got = capsys.readouterr()
    assert got.out == want and "\t400\t" in want
    assert "server unreachable, running locally" in got.err


def test_trace_writes_profile(inputs, tmp_path, monkeypatch, capsys):
    """NGSTPU_TRACE=<dir>: a Chrome trace of torch.profiler in <dir> that
    holds the run's torch ops, and the same stdout as without it."""
    monkeypatch.setenv("NGSTPU_NO_FASTPATH", "1")  # the torch histogram
    argv = ["--device", "cpu", "fastq_count", "-H", str(inputs / "n.fq")]
    assert cli.main(argv) == 0
    want = capsys.readouterr().out
    trace = tmp_path / "trace"
    monkeypatch.setenv("NGSTPU_TRACE", str(trace))
    assert cli.main(argv) == 0
    assert capsys.readouterr().out == want
    files = list(trace.glob("fastq_count.*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]


def test_trace_holds_fastqc_spans(inputs, tmp_path, monkeypatch):
    """NGSTPU_TRACE=<dir> on a local fastqc run: the trace holds the
    program's spans, tool.fastqc and its stages, as user annotations; no
    server.request, since a local run does not go through _run_tool."""
    trace = tmp_path / "trace"
    monkeypatch.setenv("NGSTPU_TRACE", str(trace))
    monkeypatch.setenv("NGSTPU_LINK", "device")
    argv = ["--device", "cpu", "fastqc", str(tmp_path / "r"),
            str(inputs / "n.fq")]
    assert cli.main(argv) == 0
    files = list(trace.glob("fastqc.*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("tool.fastqc") == 1
    for stage in ("parse", "placement", "tile_names1", "modules1", "render1",
                  "dedup", "dup_render", "parse.read1", "modules.stats",
                  "render.png.gc_density", "dedup.key"):
        assert names.count(stage) == 1, stage
    assert "server.request" not in names


def test_serve_without_card_fails():
    """`serve` resolves its device first: asking for cuda without a card
    raises, and nothing listens. Never a CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    d = tempfile.mkdtemp(dir="/tmp", prefix="ngt")
    try:
        sock = os.path.join(d, "s")
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["serve", "--socket", sock])
        assert not os.path.exists(sock)
    finally:
        shutil.rmtree(d)
