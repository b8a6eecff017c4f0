"""copies.h2d_bytes_per_read: the bytes the program copied from host to
device (its h2d_bytes counter, each call's change) summed over the
window's calls, over their reads (both mates count)."""

from ngsbench.records import records


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    return (sum(r["counts"]["h2d_bytes"] for r in recs)
            / sum(c["reads"] for c in ctx.calls))
