"""The program's request records of a window's calls, for the readers of
span and counter metrics (metrics/*.py)."""


def records(ctx):
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
