"""gzfastq_mrle: RLE-encode quality strings (experimental codec).

A copy of ngstpu's tools/gzfastq_mrle.py on the port's host runtime; it has
no device code, and the port's CLI calls it without a device.

Parity target: reference gzfastq_mrle.c. Records are processed in INPUT
order (the prepend-list + reversing dump restores it, :171-183; the qsort
is commented out). Per record the encoder writes one length byte (int
truncated to unsigned char, :212) + payload to the output file (which gets
the accidental _sort_by_seq.fq / _sort_by_name.fq suffix, :197), and the
round-tripped decoded quality is printed to stdout as a self-check (:211).
"""

from __future__ import annotations

import getopt
import sys

from ..io.fastq import FastqChunkReader
from ..io.stream import open_output, with_suffix
from ..ops.rle import mrle_decode, mrle_encode
from ..utils.timing import StageTimer


def main(argv: list[str]) -> int:
    timer = StageTimer()
    infile, outfile = "-", "-"
    by_name = by_seq = 0
    if not argv:
        _usage()
        return 1
    opts, _ = getopt.gnu_getopt(argv, "i:o:nsh?")
    for flag, val in opts:
        if flag == "-i":
            infile = val
        elif flag == "-o":
            outfile = val
        elif flag == "-n":
            by_name, by_seq = 1, 0
        elif flag == "-s":
            by_name, by_seq = 0, 1
        elif flag in ("-h", "-?"):
            _usage()
            return 1

    suffix = "_sort_by_name.fq" if (by_name and not by_seq) else "_sort_by_seq.fq"
    out = open_output(with_suffix(outfile, suffix))
    n = 0
    from ..io.native import get_lib
    lib = get_lib()
    import numpy as np
    for batch in FastqChunkReader(infile):
        if lib is not None and batch.n:
            # native batch encode; the stdout self-check round-trips the
            # ORIGINAL qualities (the reference decodes its own encoding,
            # which is lossless, so the bytes are identical)
            enc_buf = np.empty(int(2 * batch.lens.sum() + 2 * batch.n + 16),
                               dtype=np.uint8)
            enc_lens = np.empty(batch.n, dtype=np.int32)
            total = lib.ngs_mrle_encode_rows(
                np.ascontiguousarray(batch.qual),
                np.ascontiguousarray(batch.lens, np.int32),
                batch.n, batch.qual.shape[1], enc_buf, enc_lens)
            if total >= 0:
                from ..io.ragged import flatten_ragged
                flat_q = flatten_ragged(batch.qual, batch.lens)
                # interleave: qual + \n per record
                sizes = batch.lens.astype(np.int64) + 1
                starts = np.zeros(batch.n, np.int64)
                np.cumsum(sizes[:-1], out=starts[1:])
                txt = np.full(int(sizes.sum()), 0x0A, dtype=np.uint8)
                from ..io.ragged import ragged_arange
                dest = np.repeat(starts, batch.lens.astype(np.int64)) + \
                    ragged_arange(batch.lens.astype(np.int64))
                txt[dest] = flat_q
                sys.stdout.buffer.write(txt.tobytes())
                out.write(enc_buf[:total].tobytes())
                n += batch.n
                continue
        for i in range(batch.n):
            q = batch.qual_bytes(i)
            enc = mrle_encode(q)
            dec = mrle_decode(enc, len(q))
            sys.stdout.buffer.write(dec + b"\n")
            out.write(bytes([len(enc) & 0xFF]) + enc)
            n += 1
    if out is not sys.stdout.buffer:
        out.close()
    else:
        out.flush()
    sys.stdout.buffer.flush()
    timer.log("done write file at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch gzfastq_mrle [-i Infile] [-o OUTFILE] [-s|-n] [-h]\n")
