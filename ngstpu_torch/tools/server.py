"""Warm-process server: run the port's tools without paying start-up per call.

A cold CLI call pays the torch import, the CUDA context, the native
library's load (or build) and the qc_hist kernel's, and, without
NGSTPU_LINK, a link probe. `serve` pays them once: it resolves its device,
warms those up before it listens, and keeps the link verdict in-process
for its lifetime. CLI calls with NGSTPU_SERVER=<socket> then route over a
unix socket and reuse the warm state.

ngstpu's wire protocol, unchanged: one JSON line request {"tool", "argv",
"cwd"} -> one JSON line response {"rc", "stdout" (base64), "stderr"
(base64)}; {"op": "ping"} and {"op": "shutdown"} answer {"rc": 0}.
Requests are handled one after another (tools are process-global: cwd,
stdout, the device). The protocol carries no environment: the server's
own (NGSTPU_LINK, NGSTPU_PILEUP_MODE, ...) applies to every request.

Importing this module imports no torch: the client side (`call_server`)
runs before the CLI imports anything that does.
"""

from __future__ import annotations

import base64
import io
import json
import os
import socket
import socketserver
import sys
import threading
import time

DEFAULT_SOCKET = "/tmp/ngstpu_torch.sock"


def _run_tool(tool: str, argv: list[str], cwd: str,
              device) -> tuple[int, bytes, bytes]:
    """One request: `tool` run as the CLI runs it on `device`, in `cwd`,
    with stdout and stderr captured, in span server.request (the root of
    the request's spans). A tool's exception gives rc 1 and a message; it
    never reaches the server."""
    from ..utils.timing import request

    with request("server.request", tool) as req:
        rc, out, err = _run_captured(tool, argv, cwd, device)
        if req is not None:
            req.rc = rc
    return rc, out, err


def _run_captured(tool: str, argv: list[str], cwd: str,
                  device) -> tuple[int, bytes, bytes]:
    from .cli import TOOLS, run

    if tool not in TOOLS:
        return 2, b"", f"ngstpu-torch: unknown tool '{tool}'\n".encode()
    out_buf, err_buf = io.BytesIO(), io.BytesIO()
    out_txt = io.TextIOWrapper(out_buf, encoding="utf-8", write_through=True)
    err_txt = io.TextIOWrapper(err_buf, encoding="utf-8", write_through=True)
    old_out, old_err, old_cwd = sys.stdout, sys.stderr, os.getcwd()
    sys.stdout, sys.stderr = out_txt, err_txt
    try:
        os.chdir(cwd)
        rc = run(tool, list(argv), device)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else int(e.code is not None)
    except Exception as e:  # a CUDA OOM included: the server keeps serving
        err_txt.write(f"ngstpu-torch {tool}: {type(e).__name__}: {e}\n")
        rc = 1
    finally:
        try:
            out_txt.flush()
            err_txt.flush()
        except ValueError:
            pass  # a tool closed sys.stdout
        sys.stdout, sys.stderr = old_out, old_err
        os.chdir(old_cwd)
    return rc, out_buf.getvalue(), err_buf.getvalue()


def warm_up(device) -> dict[str, float]:
    """Pays what every cold call pays, once: the CUDA context, the native
    host library and, on a card, the qc_hist kernel's library (each built
    if missing). Returns the seconds each took."""
    import torch

    from ..io import native
    from ..kernels import build

    took = {}
    t0 = time.monotonic()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    took["cuda context"] = time.monotonic() - t0
    t0 = time.monotonic()
    if native.get_lib() is None:
        raise RuntimeError("the native host library did not build or load")
    took["libngsio_torch"] = time.monotonic() - t0
    if device.type == "cuda":
        t0 = time.monotonic()
        build.load("qc_hist")
        took["qc_hist"] = time.monotonic() - t0
    return took


def serve(sock_path: str = DEFAULT_SOCKET, device: str = "cuda") -> None:
    """Listen on `sock_path` until a shutdown request. The device is
    resolved once, before anything else: without the card it names, the
    server fails instead of serving from the CPU."""
    t0 = time.monotonic()
    from ..utils.device import resolve_device

    took = {"torch import": time.monotonic() - t0}
    dev = resolve_device(device)
    took.update(warm_up(dev))
    sys.stderr.write(f"ngstpu-torch server: device {dev}; warm-up "
                     + ", ".join(f"{k} {v:.3f}s" for k, v in took.items())
                     + "\n")
    if os.path.exists(sock_path):
        os.unlink(sock_path)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            line = self.rfile.readline()
            if not line:
                return
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                return
            if req.get("op") == "ping":
                self.wfile.write(b'{"rc": 0}\n')
                return
            if req.get("op") == "shutdown":
                self.wfile.write(b'{"rc": 0}\n')
                threading.Thread(target=srv.shutdown, daemon=True).start()
                return
            rc, out, err = _run_tool(req.get("tool", ""), req.get("argv", []),
                                     req.get("cwd", os.getcwd()), dev)
            self.wfile.write(json.dumps({
                "rc": rc,
                "stdout": base64.b64encode(out).decode(),
                "stderr": base64.b64encode(err).decode(),
            }).encode() + b"\n")

    srv = socketserver.UnixStreamServer(sock_path, Handler)
    sys.stderr.write(f"ngstpu-torch server listening on {sock_path}\n")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        if os.path.exists(sock_path):
            os.unlink(sock_path)


def call_server(sock_path: str, tool: str, argv: list[str],
                timeout: float = 3600.0) -> int | None:
    """Route one tool invocation through a running server: its stdout and
    stderr bytes are written to ours. Returns the exit code, or None if
    the server is unreachable."""
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(timeout)
            s.connect(sock_path)
            f = s.makefile("rwb")
            f.write(json.dumps({"tool": tool, "argv": argv,
                                "cwd": os.getcwd()}).encode() + b"\n")
            f.flush()
            resp = f.readline()
    except OSError:
        return None
    if not resp:
        return None
    r = json.loads(resp)
    sys.stdout.buffer.write(base64.b64decode(r.get("stdout", "")))
    sys.stdout.buffer.flush()
    sys.stderr.buffer.write(base64.b64decode(r.get("stderr", "")))
    sys.stderr.buffer.flush()
    return int(r["rc"])


def main(argv: list[str], device: str = "cuda") -> int:
    sock = DEFAULT_SOCKET
    it = iter(argv)
    for a in it:
        if a == "--socket":
            sock = next(it, DEFAULT_SOCKET)
        elif a in ("-h", "--help"):
            sys.stderr.write("Usage: ngstpu-torch [--device DEV] serve "
                             "[--socket PATH]\n")
            return 1
    serve(sock, device)
    return 0
