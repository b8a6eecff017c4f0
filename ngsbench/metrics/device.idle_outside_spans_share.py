"""device.idle_outside_spans_share: of the time inside the window's calls
in which the device ran nothing (the gaps of the profiler trace within
each call's ngsbench.call.<i> annotation), the share that falls in no
leaf span of the program (a span no other span names as its parent), in
percent. A call's spans go onto the trace's clock by the call's offset:
its annotation's start less its start on the host's clock."""

import bisect

from ngsbench.records import records


def read(ctx):
    recs = records(ctx)
    if recs is None or ctx.trace is None:
        return None
    gaps = ctx.trace.gaps()
    ends = [g1 for _, g1 in gaps]
    idle = outside = 0.0
    for c, r in zip(ctx.calls, recs):
        if c["index"] not in ctx.trace.calls:
            return None
        a0, a1 = ctx.trace.calls[c["index"]]
        off = a0 - c["start"] * 1e6
        parents = {s[1] for s in r["spans"]}
        leaves = []
        for t0, t1 in sorted((s[3] / 1e3 + off, s[4] / 1e3 + off)
                             for s in r["spans"] if s[0] not in parents):
            if leaves and t0 <= leaves[-1][1]:
                leaves[-1][1] = max(leaves[-1][1], t1)
            else:
                leaves.append([t0, t1])
        for g0, g1 in gaps[bisect.bisect_right(ends, a0):]:
            if g0 >= a1:
                break
            g0, g1 = max(g0, a0), min(g1, a1)
            idle += g1 - g0
            outside += g1 - g0 - sum(max(0.0, min(t1, g1) - max(t0, g0))
                                     for t0, t1 in leaves)
    return 100.0 * outside / idle if idle > 0 else None
