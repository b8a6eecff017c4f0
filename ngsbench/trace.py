"""Reads a torch.profiler Chrome trace of the measured window: the device's
activity (kernels, copies, sets), the window's calls, and from them the
busy time, the time per device operation and the idle gaps."""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_PREFIX = "ngsbench.call."


class Trace:
    """Times in microseconds on the profiler's clock. `calls` maps a call's
    index to its (start, end), from the harness's annotation around it;
    `ops` holds every device operation inside the window as (start, end,
    name); `busy` the union of their intervals, merged and sorted."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        self.calls = {}
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if cat == "user_annotation" and name.startswith(CALL_PREFIX):
                self.calls[int(name[len(CALL_PREFIX):])] = (t0, t1)
            elif cat in DEVICE_CATS:
                device.append((t0, t1, name))
        if self.calls:
            self.window = (min(s for s, _ in self.calls.values()),
                           max(e for _, e in self.calls.values()))
        else:
            self.window = (0.0, 0.0)
        lo, hi = self.window
        self.ops = sorted((max(s, lo), min(e, hi), n) for s, e, n in device
                          if e > lo and s < hi)
        self.busy = []
        for s, e, _ in self.ops:
            if self.busy and s <= self.busy[-1][1]:
                self.busy[-1][1] = max(self.busy[-1][1], e)
            else:
                self.busy.append([s, e])

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def op_seconds(self, needle: str) -> float:
        """Seconds of the device operations whose name holds `needle`."""
        return sum(e - s for s, e, n in self.ops if needle in n) / 1e6

    def top_ops(self, k: int = 10) -> list:
        """The k device operations that took most time, with the seconds
        each; kernel names lose their boilerplate (void, at::native::)."""
        by = {}
        for s, e, n in self.ops:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        out = []
        for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]:
            for junk in ("void ", "at::native::", "(anonymous namespace)::",
                         "at::cuda::", "at_cuda_detail::"):
                n = n.replace(junk, "")
            out.append([n[:200], t])
        return out

    def gaps(self) -> list:
        """(start, end) of each idle interval inside the window."""
        lo, hi = self.window
        out, at = [], lo
        for s, e in self.busy:
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if hi > at:
            out.append((at, hi))
        return out

    def idle_by_stage(self, stages: dict, k: int = 10) -> list:
        """Idle seconds by what the host was doing: each gap is split over
        the program's stages of the call it falls in, placed from the
        call's start by their walls (`stages`: call index -> ordered
        {stage: wall seconds}); time outside any stage of a call is the
        call's "dispatch", time between calls "between calls"."""
        spans = []  # (start, end, label) on the trace's clock
        for i, (c0, c1) in sorted(self.calls.items()):
            at = c0
            for name, wall in stages.get(i, {}).items():
                end = min(at + wall * 1e6, c1)
                spans.append((at, end, name))
                at = end
            spans.append((at, c1, "dispatch"))
        by = {}
        for g0, g1 in self.gaps():
            inside = 0.0
            for s, e, name in spans:
                ov = min(e, g1) - max(s, g0)
                if ov > 0:
                    by[name] = by.get(name, 0.0) + ov / 1e6
                    inside += ov
            if g1 - g0 - inside > 0:
                by["between calls"] = by.get("between calls", 0.0) + (
                    g1 - g0 - inside) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]
