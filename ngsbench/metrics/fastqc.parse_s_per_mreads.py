"""fastqc.parse_s_per_mreads: the seconds of fastqc's input parse (the
parse.read1 and parse.read2 spans: io/fastq.py:read_fastq_file, and for a
.fastq.gz io/stream.py's gzip stream, FastqChunkReader and
concat_batches) summed over the window's calls, per million reads."""

from ngsbench.records import records


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    ns = sum(s[4] - s[3] for r in recs for s in r["spans"]
             if s[2] in ("parse.read1", "parse.read2"))
    return ns / 1e9 / (sum(c["reads"] for c in ctx.calls) / 1e6)
