"""fastqc.png_s_per_mreads: the seconds of fastqc's chart drawing (every
render.png.<chart> span: utils/png.py via tools/fastqc.py) summed over the
window's calls, per million reads."""

from ngsbench.records import records


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    ns = sum(s[4] - s[3] for r in recs for s in r["spans"]
             if s[2].startswith("render.png."))
    return ns / 1e9 / (sum(c["reads"] for c in ctx.calls) / 1e6)
