"""server.dispatch_ms_per_call: the warm server's own time a call, in ms:
the self time of each window call's server.request span (its duration
less its child tool.* span: tools/server.py:_run_tool's chdir, stream
capture, CLI dispatch and argument parsing), mean over the calls."""


def _records(ctx):
    """Each window call's request record from the program's in-process
    record (ngstpu_torch.utils.timing.requests), matched by its
    server.request span lying inside the call's [start, end] (both on
    CLOCK_MONOTONIC); None where a call has no record or the program
    keeps none."""
    try:
        from ngstpu_torch.utils.timing import requests
    except ImportError:
        return None
    roots = [(r, r["spans"][0]) for r in requests()
             if r["spans"] and r["spans"][0][2] == "server.request"]
    out = []
    for c in ctx.calls:
        lo, hi = c["start"] * 1e9, c["end"] * 1e9
        match = [r for r, s in roots if lo <= s[3] and s[4] <= hi]
        if len(match) != 1:
            return None
        out.append(match[0])
    return out or None


def read(ctx):
    recs = _records(ctx)
    if recs is None:
        return None
    ns = 0
    for r in recs:
        root = r["spans"][0]
        ns += root[4] - root[3] - sum(
            s[4] - s[3] for s in r["spans"]
            if s[1] == root[0] and s[2].startswith("tool."))
    return ns / len(recs) / 1e6
