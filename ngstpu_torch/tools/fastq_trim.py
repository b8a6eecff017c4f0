"""fastq_trim: cut reads/qualities to cycle window [start, end).

A copy of ngstpu's tools/fastq_trim.py on the port's host runtime; it has
no device code, and the port's CLI calls it without a device.

Parity target: reference fastq_trim.c. Semantics (fastq_trim.c:67-108):
- -s S (0-based, default 0), -e E (default 400); slice = strncpy(buf+S, E-S)
  so reads shorter than E keep their own tail, reads shorter than S become
  empty.
- name line passes through unchanged; the '+' line is normalized to "+".
- output = outfile + ".trim.fastq" (plain text even for gz input,
  fastq_trim.c:157); '-' -> stdout.
- stderr: "Total_reads: N\\nFinished in %.3f s".
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from ..io.fastq import FastqChunkReader, format_fastq
from ..io.stream import open_output, with_suffix
from ..utils.timing import StageTimer


def trim_batch(batch, start: int, end: int):
    """Host-side padded-slice trim (pure memory movement, no device hop)."""
    lens = batch.lens.astype(np.int64)
    new_lens = np.clip(np.minimum(lens, end) - start, 0, None).astype(np.int32)
    width = max(end - start, 1)
    lmax = batch.seq.shape[1]
    if start >= lmax:
        seq = np.zeros((batch.n, 1), dtype=np.uint8)
        qual = np.zeros((batch.n, 1), dtype=np.uint8)
        new_lens = np.zeros(batch.n, dtype=np.int32)
    else:
        seq = batch.seq[:, start:end]
        qual = batch.qual[:, start:end]
    return seq, qual, new_lens


def main(argv: list[str]) -> int:
    timer = StageTimer()
    infile, outfile, start, end = "-", "-", 0, 400
    opts, _ = getopt.gnu_getopt(argv, "i:o:s:e:vzh?")
    for flag, val in opts:
        if flag == "-i":
            infile = val
        elif flag == "-o":
            outfile = val
        elif flag == "-s":
            start = int(val)
        elif flag == "-e":
            end = int(val)
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    if not argv:
        _usage()
        return 1

    import os

    n = None
    if not os.environ.get("NGSTPU_NO_FASTPATH"):
        n = _trim_fast(infile, outfile, start, end)
    if n is None:
        out = open_output(with_suffix(outfile, ".trim.fastq"))
        n = 0
        for batch in FastqChunkReader(infile):
            seq, qual, lens = trim_batch(batch, start, end)
            out.write(format_fastq(batch.names, batch.name_starts,
                                   batch.name_lens, seq, qual, lens))
            n += batch.n
        if out is not sys.stdout.buffer:
            out.close()
        else:
            out.flush()
    sys.stderr.write(f"Total_reads: {n}\n")
    timer.log("Finished in %.3f s\n")
    return 0


def _trim_fast(infile: str, outfile: str, start: int, end: int) -> int | None:
    """Offset-indexed trim: text assembled straight from the mmap'd bytes
    per chunk, written by the background ring writer (the same machinery
    as tools/pipeline.run_fast). None when the fast path does not apply."""
    from ..io.fastindex import index_fastq, trim_text
    from ..utils.bufpool import get_buffer
    from .emitters import CHUNK_RECORDS, _RingWriter

    ix = index_fastq(infile)
    if ix is None:
        return None
    out = open_output(with_suffix(outfile, ".trim.fastq"))
    B = ix.n
    cl = np.clip(np.minimum(ix.seq_len.astype(np.int64), end) - start,
                 0, None)
    rec = ix.name_len.astype(np.int64) + 1 + cl + 3 + cl + 1
    from .emitters import _RecyclingSink

    # finer chunks than the shared default: more format/write overlap
    # and earlier recycling on mid-sized outputs
    step = CHUNK_RECORDS // 4
    cap = 1
    for lo in range(0, B, step):
        cap = max(cap, int(rec[lo:lo + step].sum()))
    writer = _RingWriter(_RecyclingSink(out, window=64 << 20,
                                        start=128 << 20),
                         ["trim.a", "trim.b", "trim.c"])
    try:
        for lo in range(0, B, step):
            hi = min(lo + step, B)
            name = writer.acquire()
            buf = get_buffer(name, cap)
            total = trim_text(ix, lo, hi, start, end, buf)
            writer.submit(name, buf, total)
    finally:
        writer.close()
        if out is not sys.stdout.buffer:
            out.close()
        else:
            out.flush()
    return B


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch fastq_trim [-i Infile] [-o OUTFILE] [-s start] [-e end] [-h]\n"
        "   [-i Infile]    = Infile. default is stdin\n"
        "   [-o OUTPUT]    = OUTPUT file. default is stdout\n"
        "   [-s Start]     = 0 based start position, default is 0\n"
        "   [-e End]       = 1 based end position, default is 400\n")
