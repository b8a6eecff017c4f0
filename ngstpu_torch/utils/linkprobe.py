"""Process-wide host<->device link bandwidth verdict (torch port).

Mirrors ngstpu/utils/linkprobe.py with the same verdict logic and the same
environment: NGSTPU_LINK=host|device overrides, NGSTPU_QC_BW_MIN (MB/s,
default 1000) is the threshold, NGSTPU_LINK_TTL (seconds, default 900) the
cache window. The device kernels are the default; on a link slower than the
threshold the native host paths (threaded QC histogram, bucketed host sort)
win, because they run at several GB/s. One timed host->device copy, made in
a child process that a deadline can kill, decides the first time a
placement-aware op sees a big operand. A probe that fails or stalls raises
instead of voting 'host': a verdict is only ever a measured bandwidth.
"""

from __future__ import annotations

import os
import threading

import numpy as np

_VERDICT: list = []  # [] = unmeasured; ["host"|"device"]
# one probe at a time: threads that count files at once (fastq_count -t,
# fastq_count_kthread -t) wait for the first probe's verdict
_probe_lock = threading.Lock()
# the last verdict probe_link drew: verdict, cached, and for a measured
# one the bytes and seconds of the copy that decided it
LAST_PROBE: dict = {}


def bw_min() -> float:
    return float(os.environ.get("NGSTPU_QC_BW_MIN", "1000")) * 1e6


def link_verdict() -> str | None:
    forced = os.environ.get("NGSTPU_LINK")
    if forced in ("host", "device"):
        return forced
    return _VERDICT[0] if _VERDICT else None


def note_transfer(nbytes: int, seconds: float) -> None:
    """Update the verdict from a REALIZED device-to-host pull (the device
    pileup sweep's, ops/bamops.merged_intervals). A link's throughput can
    swing over time, so a single lucky probe can mis-place every later op;
    every big pull re-votes instead. Small transfers are RTT-dominated and
    ignored, and so is every pull while NGSTPU_LINK forces the verdict."""
    if os.environ.get("NGSTPU_LINK") in ("host", "device"):
        return
    if nbytes < (4 << 20) or seconds <= 0:
        return
    v = "host" if nbytes / seconds < bw_min() else "device"
    _VERDICT.clear()
    _VERDICT.append(v)
    _store_verdict(v)


def _cache_ttl() -> float:
    return float(os.environ.get("NGSTPU_LINK_TTL", "900"))


def _cache_path():
    import pathlib

    return pathlib.Path.home() / ".cache" / "ngstpu_torch" / "linkprobe.json"


def _backend() -> str:
    """torch device type the verdict is measured for (the cache key)."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def _cached_verdict() -> str | None:
    import json
    import time

    try:
        d = json.loads(_cache_path().read_text())
        # a verdict holds only for the backend it was measured on
        ttl = _cache_ttl()
        if d["v"] == "device":
            # a stale 'device' costs more than a stale 'host'
            ttl = ttl / 3.0
        if time.time() - float(d["ts"]) < ttl \
                and d.get("backend") == _backend() \
                and d["v"] in ("host", "device"):
            return d["v"]
    except (OSError, ValueError, KeyError, TypeError):
        pass
    return None


def _store_verdict(v: str) -> None:
    import json
    import time

    try:
        p = _cache_path()
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_name(f".{os.getpid()}.linkprobe")
        tmp.write_text(json.dumps({"v": v, "ts": time.time(),
                                   "backend": _backend()}))
        os.replace(tmp, p)
    except OSError:
        pass


PROBE_SIZES = (1 << 20, 8 << 20)  # bytes: a first look, then confirmation


def _probe_code(dev: str, sizes: tuple, bw: float) -> str:
    """The child's program: warm the device (context, and one device block
    per size for the caching allocator to reuse), then time a host->device
    copy and a 1-byte read back for each size in turn, printing one line of
    seconds each. It stops after the first copy slower than `bw` bytes/s."""
    return (
        "import time, torch\n"
        f"dev = torch.device({dev!r})\n"
        "w = [torch.empty(n, dtype=torch.uint8, device=dev)\n"
        f"     for n in {sizes!r}]\n"
        "w[0][:1].cpu()\n"
        "del w\n"
        f"for n in {sizes!r}:\n"
        "    y = torch.zeros(n, dtype=torch.uint8)\n"
        "    t0 = time.monotonic()\n"
        "    o = y.to(dev)\n"
        "    _ = o[:1].cpu()\n"
        "    dt = max(time.monotonic() - t0, 1e-9)\n"
        "    print(dt, flush=True)\n"
        "    del o\n"
        f"    if n / dt < {bw!r}:\n"
        "        break\n")


def _timed_puts(sizes: tuple, deadline: float) -> list[float]:
    """Seconds for host->device copies of `sizes` bytes of zeros in turn,
    each with a 1-byte read back, stopping after the first one slower than
    the threshold. One child process, which a deadline kills, makes every
    copy: a stalled link never blocks the caller, and the child's start-up
    (torch import, device context) is paid once.

    Raises RuntimeError, with the child's stderr, when the child fails,
    prints no time, stops early without cause or misses `deadline` (+ 20 s
    for its start-up): such a probe measured nothing, and a verdict of
    'host' drawn from it would silently take every operation off the
    card."""
    import subprocess
    import sys

    dev = _backend()
    bw = bw_min()
    limit = deadline + 20.0
    p = subprocess.Popen(
        [sys.executable, "-c", _probe_code(dev, tuple(sizes), bw)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = p.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        raise RuntimeError(
            f"link probe: copies of {list(sizes)} bytes to {dev} did not "
            f"end within {limit:.0f} s; set NGSTPU_LINK=host|device to skip "
            f"the probe\n{err.strip()}") from None
    try:
        if p.returncode != 0:
            raise ValueError(f"exit code {p.returncode}")
        times = [float(t) for t in out.split()]
        if not times or len(times) > len(sizes):
            raise ValueError(f"{len(times)} times for {len(sizes)} copies")
        if len(times) < len(sizes) and sizes[len(times) - 1] / times[-1] >= bw:
            raise ValueError("stopped after a fast copy")
        return times
    except ValueError as e:
        raise RuntimeError(f"link probe child on {dev} failed ({e}); set "
                           "NGSTPU_LINK=host|device to skip the probe\n"
                           f"{err.strip()}") from None


def probe_link(arr: np.ndarray) -> str:
    """Staged link-bandwidth probe; records and returns the verdict.

    A 1MB copy goes first; only a fast-looking result is confirmed at 8MB.
    Operands under 8MB go to the device without a verdict (a timed copy
    that small measures latency, not bandwidth). Only a measured bandwidth
    under NGSTPU_QC_BW_MIN gives 'host'; a probe that fails raises (see
    _timed_puts) and leaves no verdict, in memory or in the cache."""
    import time

    v = link_verdict()
    if v is not None:
        return v
    if arr.nbytes < (8 << 20):
        return "device"
    with _probe_lock:
        v = link_verdict()  # drawn while this thread waited
        if v is not None:
            return v
        v = _cached_verdict()
        if v is not None:
            _VERDICT.append(v)
            LAST_PROBE.update(verdict=v, cached=True)
            return v
        t0 = time.monotonic()
        small, big = PROBE_SIZES
        times = _timed_puts(PROBE_SIZES,
                            deadline=max(16 * small / bw_min(), 10.0)
                            + max(8 * big / bw_min(), 5.0))
        nbytes = PROBE_SIZES[len(times) - 1]
        v = "host" if nbytes / times[-1] < bw_min() else "device"
        _VERDICT.append(v)
        LAST_PROBE.update(verdict=v, cached=False, nbytes=nbytes,
                          seconds=times[-1], wall=time.monotonic() - t0)
        _store_verdict(v)
        return v
