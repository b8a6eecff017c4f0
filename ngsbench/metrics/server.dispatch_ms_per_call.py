"""server.dispatch_ms_per_call: the warm server's own time a call, in ms:
the self time of each window call's server.request span (its duration
less its child tool.* span: tools/server.py:_run_tool's chdir, stream
capture, CLI dispatch and argument parsing), mean over the calls."""

from ngsbench.records import records


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    ns = 0
    for r in recs:
        root = r["spans"][0]
        ns += root[4] - root[3] - sum(
            s[4] - s[3] for s in r["spans"]
            if s[1] == root[0] and s[2].startswith("tool."))
    return ns / len(recs) / 1e6
