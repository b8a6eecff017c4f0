"""copies.h2d_gb_per_s: the bytes the program copied from host to device
(its h2d_bytes counter, summed over the window's calls) over the seconds
of the profiler trace's Memcpy HtoD operations in the window, in 1e9
bytes a second."""

from ngsbench.records import records


def read(ctx):
    recs = records(ctx)
    if recs is None or ctx.trace is None:
        return None
    seconds = ctx.trace.op_seconds("Memcpy HtoD")
    if seconds <= 0:
        return None
    return sum(r["counts"]["h2d_bytes"] for r in recs) / seconds / 1e9
