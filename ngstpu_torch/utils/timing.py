"""Stage timing, request spans and the copy counter of the port's tools.

StageTimer prints the reference's `Finished at %.3f s`, computed as
elapsed_microseconds / CLOCKS_PER_SEC (reference fastq_count.c:100-104,236;
on Linux CLOCKS_PER_SEC == 1e6, so the figure is seconds), and keeps its
checkpoints in `stages` for tools/profile_pipeline.py and chip_smoke.py.

Spans. One request (a warm-server call, tools/server.py:_run_tool, or a
local fastqc run) is a tree of spans that share its `call_id`. A span is
(id, parent id, name, start ns, end ns, user CPU s, system CPU s), on
time.monotonic_ns() (CLOCK_MONOTONIC) and getrusage(RUSAGE_SELF). Whether
spans are on is decided once, when the request's root opens: while
NGSTPU_STAGE_JSON is set or a torch.profiler session records (as one
does under tools/cli.py's NGSTPU_TRACE, on a local run). Off, `span()` is
one test of the open request and returns a shared no-op context: nothing
is allocated or recorded. While a profiler records, each span also
enters torch.profiler.record_function under its own name, so the
program's spans sit in the Chrome trace beside the device operations they
launched. A finished request goes into a bounded in-process record, read
with `requests()`. Requests are taken one at a time, as the warm server
takes them.

COUNTS holds process-wide counters, always on: `h2d_bytes`, the bytes of
every host-to-device copy made through utils/device.upload;
`tile_rows_native` and `tile_rows_loop`, the sampled rows whose tile
numbers ops/fastqc.parse_tile_ids read in its native pass and in its
per-name loop. A request's record keeps each counter's change over the
request.
"""

from __future__ import annotations

import collections
import itertools
import os
import resource
import sys
import time

COUNTS: collections.Counter = collections.Counter(
    h2d_bytes=0, tile_rows_native=0, tile_rows_loop=0)

_RECORD: collections.deque = collections.deque(maxlen=4096)
_CALL_IDS = itertools.count(1)
_OPEN = None  # the open request while spans are on, else None


class StageTimer:
    def __init__(self):
        self.begin = time.monotonic()
        self.stages: list[tuple[str, float]] = []

    def elapsed(self) -> float:
        return time.monotonic() - self.begin

    def log(self, fmt: str = "Finished at %.3f s\n") -> None:
        sys.stderr.write(fmt % self.elapsed())

    def checkpoint(self, name: str) -> None:
        self.stages.append((name, self.elapsed()))


def _cpu() -> tuple[float, float]:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime, r.ru_stime


def _profiler_records() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def _record_function(name: str):
    """torch.profiler.record_function(name), not yet entered."""
    import torch

    return torch.profiler.record_function(name)


def _spans_on() -> bool:
    return bool(os.environ.get("NGSTPU_STAGE_JSON")) or _profiler_records()


def requests() -> list[dict]:
    """The last 4096 finished requests, oldest first. Each is a dict:
    call_id (int), tool (str), rc (the exit code the root's opener set,
    else None), spans (tuples as the module docstring says; the root
    first, then by id, which is the order they opened in) and counts (each
    COUNTS key's change over the request)."""
    return list(_RECORD)


class _Off:
    """The context every span returns while spans are off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Request:
    def __init__(self, tool: str):
        self.call_id = next(_CALL_IDS)
        self.tool, self.rc = tool, None
        self.spans: list[tuple] = []
        self.stack: list[int] = []  # ids of the open spans, innermost last
        self.ids = itertools.count(1)
        self.counts0 = dict(COUNTS)
        self.profiling = _profiler_records()

    def push(self) -> tuple[int, int | None]:
        """A new id, opened under the innermost open span."""
        sid = next(self.ids)
        parent = self.stack[-1] if self.stack else None
        self.stack.append(sid)
        return sid, parent

    def close(self, sid: int, parent, name: str, t0: int, t1: int,
              cpu0, cpu1) -> None:
        """Records span `sid` and closes it with whatever opened inside
        it and is still open (a stage still pending at its parent's end
        was never named, and goes unrecorded)."""
        while self.stack and self.stack.pop() != sid:
            pass
        self.spans.append((sid, parent, name, t0, t1,
                           round(cpu1[0] - cpu0[0], 6),
                           round(cpu1[1] - cpu0[1], 6)))

    def finish(self) -> None:
        _RECORD.append(dict(call_id=self.call_id, tool=self.tool, rc=self.rc,
                            spans=sorted(self.spans),
                            counts={k: v - self.counts0.get(k, 0)
                                    for k, v in COUNTS.items()}))


class _Span:
    """One span. Its profiler range is built before the span's clock is
    read and opened right after; the clock is read again right after the
    range closes. A stall inside the profiler's own bookkeeping falls in
    both."""

    __slots__ = ("req", "name", "root", "sid", "parent", "t0", "cpu0", "rf")

    def __init__(self, req: _Request, name: str, root: bool = False):
        self.req, self.name, self.root, self.rf = req, name, root, None

    def __enter__(self) -> _Request:
        global _OPEN
        if self.root:
            _OPEN = self.req
        self.sid, self.parent = self.req.push()
        if self.req.profiling:
            self.rf = _record_function(self.name)
        self.cpu0 = _cpu()
        self.t0 = time.monotonic_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return self.req

    def __exit__(self, *exc) -> bool:
        global _OPEN
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.monotonic_ns()
        self.req.close(self.sid, self.parent, self.name, self.t0, t1,
                       self.cpu0, _cpu())
        if self.root:
            _OPEN = None
            self.req.finish()
        return False


def span(name: str):
    """`with span(name):` a span under the innermost open one (a stage,
    where a StageRusage has one open) of the open request."""
    if _OPEN is None:
        return _OFF
    return _Span(_OPEN, name)


def request(name: str, tool: str):
    """`with request(name, tool) as req:` the root of a request's spans
    (req: the request, whose `rc` the opener may set; None while spans
    are off), or a plain span where a request is open already."""
    if _OPEN is not None:
        return _Span(_OPEN, name)
    if not _spans_on():
        return _OFF
    return _Span(_Request(tool), name, root=True)


class StageRusage:
    """Flat per-stage wall / user-CPU / system-CPU deltas, dumped as one
    JSON line to the file NGSTPU_STAGE_JSON names (ngsbench/ reads the
    last line: every dict-valued key is a stage, in order).

    `checkpoint(name)` ends the stage that ran since the previous
    checkpoint (or since construction). Inside a request, each stage is
    also a span, opened under the span that was innermost at
    construction, so span() inside a stage nests under it; the line then
    carries `call_id` and `spans` (the request's spans closed by then).
    `with stages.stage(name):` is checkpoint(name) at the block's end
    that also enters the profiler's trace for the block."""

    def __init__(self):
        self.stages: dict[str, dict] = {}
        self._req = _OPEN
        self._name = None
        self._rf = None
        self._last = (time.monotonic_ns(), *_cpu())
        if self._req is not None:
            self._pending = self._req.push()

    def checkpoint(self, name: str) -> None:
        t = time.monotonic_ns()
        self._end(name, t, *_cpu())

    def _end(self, name: str, t: int, u: float, s: float) -> None:
        t0, u0, s0 = self._last
        self.stages[name] = {"wall_s": round((t - t0) / 1e9, 3),
                             "usr_s": round(u - u0, 3),
                             "sys_s": round(s - s0, 3)}
        if self._req is not None:
            sid, parent = self._pending
            self._req.close(sid, parent, name, t0, t, (u0, s0), (u, s))
            self._pending = self._req.push()
        self._last = (t, u, s)

    def stage(self, name: str) -> "StageRusage":
        self._name = name
        return self

    def __enter__(self):
        if self._req is not None and self._req.profiling:
            self._rf = _record_function(self._name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        # the CPU times first: a system call between this stage's end and
        # the next one's profiler range is where the host likes to switch
        # threads, and the next stage starts at this one's end
        cpu = _cpu()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self._end(self._name, time.monotonic_ns(), *cpu)
        return False

    def dump(self, **extra) -> None:
        path = os.environ.get("NGSTPU_STAGE_JSON")
        if not path:
            return
        import json

        payload = dict(self.stages)
        payload.update(extra)
        if self._req is not None:
            payload["call_id"] = self._req.call_id
            payload["spans"] = [list(s) for s in sorted(self._req.spans)]
        try:
            with open(path, "a") as f:
                f.write(json.dumps(payload) + "\n")
        except OSError:
            pass
