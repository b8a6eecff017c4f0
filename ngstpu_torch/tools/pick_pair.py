"""pick_pair: merge-join two name-sorted FASTQ files into PE/SE outputs.

A copy of ngstpu's tools/pick_pair.py on the port's host runtime; it has
no device code, and the port's CLI calls it without a device.

Parity target: reference pick_pair.c. Names are compared up to the first
space of the read-1 name (:107,111); matched reads go to
{outfile}_1_PE.fq.gz / _2_PE.fq.gz, unmatched to _1_SE.fq.gz / _2_SE.fq.gz
(:98-101), records "%s\\n%s\\n+\\n%s" with the quality line keeping its
newline (:11-20). Quirk preserved: -1 sets the output prefix until -o
overrides (:163-166).

The reference loop (:104-118) is NOT a clean join: it reads one record
from EACH file per outer iteration, advances each side past
smaller-keyed records (to SE), then pairs whatever two records remain —
even if their names differ (e.g. sorted runs that interleave produce
mismatched "pairs"). We port that structure exactly, index-based over
preloaded batches. Two deliberate divergences from C's undefined
behavior: when one file is exhausted mid-iteration the reference
dereferences NULL (SURVEY.md §7) — we guard and keep emitting the
surviving side to the PE file exactly as the no-crash iterations do; and
key equality is exact-to-space rather than C's prefix-of-name1 compare.
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from ..io.fastq import format_fastq, read_fastq_file
from ..io.native import fill_padded
from ..io.stream import ParallelGzipWriter
from ..utils.timing import StageTimer

OUT_CHUNK = 1 << 20


def _match_keys(batch) -> np.ndarray:
    """Per-read fixed-width key: name up to the first space, as |S| bytes."""
    lmax = max(int(batch.name_lens.max(initial=1)), 4)
    padded = fill_padded(batch.names, batch.name_starts, batch.name_lens, lmax)
    # cut at first space
    space = padded == 0x20
    first_space = np.where(space.any(axis=1), space.argmax(axis=1), lmax)
    col = np.arange(lmax)
    padded = padded * (col[None, :] < first_space[:, None])
    return padded.view(f"S{lmax}").ravel()


def _emit(path: str, batch, idx: np.ndarray) -> None:
    out = ParallelGzipWriter(open(path, "wb"))
    for lo in range(0, len(idx), OUT_CHUNK):
        sub = batch.take(idx[lo:lo + OUT_CHUNK])
        out.write(format_fastq(sub.names, sub.name_starts, sub.name_lens,
                               sub.seq, sub.qual, sub.lens))
    out.close()


def _run_fast(read1: str, read2: str, outfile: str,
              timer: StageTimer) -> bool:
    """Offset-indexed merge-join (round-5): both files mmap'd + indexed,
    the reference's quirky pairing loop runs as ONE native walk over the
    name offsets (ngs_pick_pair_join), and each output is assembled
    straight from the raw bytes (take_text) into the parallel libdeflate
    gzip writer. Returns False when the fast path does not apply."""
    from ..io.fastindex import index_fastq, take_text
    from ..io.native import get_lib

    lib = get_lib()
    if lib is None:
        return False
    ix1 = index_fastq(read1, pool="pp.ix1")
    if ix1 is None:
        return False
    ix2 = index_fastq(read2, pool="pp.ix2")
    if ix2 is None:
        return False
    n1, n2 = ix1.n, ix2.n
    pe1 = np.empty(n1, np.int32)
    se1 = np.empty(n1, np.int32)
    pe2 = np.empty(n2, np.int32)
    se2 = np.empty(n2, np.int32)
    counts = np.zeros(4, np.int64)
    lib.ngs_pick_pair_join(
        ix1.data, ix1.name_off, ix1.name_len, n1,
        ix2.data, ix2.name_off, ix2.name_len, n2,
        pe1, se1, pe2, se2, counts)
    for sfx, ix, idx, k in (("_1_PE.fq.gz", ix1, pe1, counts[0]),
                            ("_1_SE.fq.gz", ix1, se1, counts[1]),
                            ("_2_PE.fq.gz", ix2, pe2, counts[2]),
                            ("_2_SE.fq.gz", ix2, se2, counts[3])):
        out = ParallelGzipWriter(open(outfile + sfx, "wb"))
        order = idx[:k].astype(np.int64)
        for lo in range(0, len(order), OUT_CHUNK):
            view, total = take_text(ix, order[lo:lo + OUT_CHUNK], "pp.text")
            # memoryview: the writer buffers by copy; a raw ndarray would
            # hit numpy's broadcasting __radd__ instead of bytearray +=
            out.write(view[:total].data)
        out.close()
    return True


def main(argv: list[str]) -> int:
    timer = StageTimer()
    read1 = read2 = None
    outfile = "out"
    if not argv:
        _usage()
        return 1
    opts, _ = getopt.gnu_getopt(argv, "1:2:o:h?")
    for flag, val in opts:
        if flag == "-1":
            read1 = val
            outfile = val
        elif flag == "-2":
            read2 = val
        elif flag == "-o":
            outfile = val
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    if read1 is None or read2 is None:
        _usage()
        return 1

    import os

    if not os.environ.get("NGSTPU_NO_FASTPATH") \
            and _run_fast(read1, read2, outfile, timer):
        timer.log("Finished load file at %.3f s\n")
        timer.log("Finished  at %.3f s\n")
        return 0
    b1 = read_fastq_file(read1)
    b2 = read_fastq_file(read2)
    k1 = _match_keys(b1).tolist()
    k2 = _match_keys(b2).tolist()
    n1, n2 = len(k1), len(k2)
    pe1, se1, pe2, se2 = [], [], [], []
    i = j = 0
    while True:
        l1 = i if i < n1 else None
        l2 = j if j < n2 else None
        i, j = i + 1, j + 1
        while l1 is not None and l2 is not None and k1[l1] < k2[l2]:
            se1.append(l1)
            l1 = i if i < n1 else None
            i += 1
        while l2 is not None and l1 is not None and k1[l1] > k2[l2]:
            se2.append(l2)
            l2 = j if j < n2 else None
            j += 1
        if l1 is None and l2 is None:
            break
        if l1 is not None:
            pe1.append(l1)
        if l2 is not None:
            pe2.append(l2)

    _emit(outfile + "_1_PE.fq.gz", b1, np.array(pe1, dtype=np.int64))
    _emit(outfile + "_1_SE.fq.gz", b1, np.array(se1, dtype=np.int64))
    _emit(outfile + "_2_PE.fq.gz", b2, np.array(pe2, dtype=np.int64))
    _emit(outfile + "_2_SE.fq.gz", b2, np.array(se2, dtype=np.int64))
    timer.log("Finished load file at %.3f s\n")
    timer.log("Finished  at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch pick_pair [-1 READ1] [-2 READ2] [-o OUTFILE] [-h]\n")
