"""reads_per_s: every FASTQ record of every call in the window (both mates
of a pair count), over the wall from the first call's start to the last
call's end, on the host's clock."""


def read(ctx):
    if not ctx.calls:
        return None
    wall = ctx.calls[-1]["end"] - ctx.calls[0]["start"]
    return sum(c["reads"] for c in ctx.calls) / wall
