"""gzfastq_sample: subsample SE/PE FASTQ, bit-exact with the reference.

A copy of ngstpu's tools/gzfastq_sample.py on the port's host runtime; it has
no device code, and the port's CLI calls it without a device.

Parity target: reference gzfastq_sample.c. Two modes:

- `-s FLOAT` (gzfastq_sample.c:280-313): integer part of the argument is a
  seed (transformed through glibc srand/rand, :364-367), fraction part is
  the keep probability. A read is kept iff
  ((X31(nameline) + seed) & 0xffffff) / 0x1000000 < frac (:150-153) — the
  hash covers the whole name line including '@'. Output:
  basename(input).<frac %f>.gz in the CWD.
- `-n N` (:227-278): pass 1 counts reads; a GSL-MT19937(4357) Fisher-Yates
  permutation of [0,n) is built with the exact C draw sequence, the first N
  entries sorted ascending are the selected ordinals. Output:
  basename(input).<N>.gz.

Both modes rename records `name_i` with the 1-based input ordinal (:30-37,
257,301); `-f` emits fasta as ">{nameline}_i" (the '@' is retained — a
reference quirk we preserve).
"""

from __future__ import annotations

import getopt
import os
import sys

import numpy as np

from ..io.fastq import FastqChunkReader, count_reads, format_fastq
from ..io.stream import ParallelGzipWriter
from ..rng.mt19937 import glibc_rand_first, sample_indices, x31_hash_batch
from ..utils.timing import StageTimer


def _format_fasta(batch, idx, ordinals) -> bytes:
    parts = []
    for i, o in zip(idx, ordinals):
        parts.append(b">" + batch.name(int(i)) + b"_%d\n" % o
                     + batch.seq_bytes(int(i)) + b"\n")
    return b"".join(parts)


def _emit(batch, keep_idx: np.ndarray, ordinals: np.ndarray, out, fasta: bool):
    if len(keep_idx) == 0:
        return
    if fasta:
        out.write(_format_fasta(batch, keep_idx, ordinals))
        return
    sub = batch.take(keep_idx)
    suffixes = [b"_%d" % o for o in ordinals]
    out.write(format_fastq(sub.names, sub.name_starts, sub.name_lens,
                           sub.seq, sub.qual, sub.lens, count_suffix=suffixes))


def _out_writer(infile: str, tag: str):
    name = os.path.basename(infile) + "." + tag + ".gz"
    return ParallelGzipWriter(open(name, "wb")), name


def _fast_sample(read1: str, read2: str | None, fasta: bool,
                 select_fn, tag_fn) -> tuple[int, int] | None:
    """Offset-indexed sampling (round-5): mmap/inflate + index both files
    once, pick with `select_fn(ix1) -> (keep_idx, ordinals, picked_total)`,
    and emit "name_ordinal" records straight from the raw bytes
    (uniq_text sep='_') through the parallel gzip writer. Replaces the
    reference's stream loops (gzfastq_sample.c:252-266 two-pass -n mode;
    :280-313 one-pass -s mode) AND the -n mode's full counting pre-pass —
    the index already knows n. Returns None when inapplicable."""
    import os as _os

    from ..io.fastindex import index_fastq, uniq_text

    if fasta or _os.environ.get("NGSTPU_NO_FASTPATH"):
        return None
    ix1 = index_fastq(read1, pool="smp.ix1")
    if ix1 is None or ix1.n == 0:
        return None
    ix2 = None
    if read2 is not None:
        ix2 = index_fastq(read2, pool="smp.ix2")
        if ix2 is None or ix2.n != ix1.n:
            return None
    picked_sel = select_fn(ix1)
    if picked_sel is None:
        return None
    keep, ordinals = picked_sel
    CH = 1 << 19
    for ix, path in ((ix1, read1), (ix2, read2)):
        if ix is None:
            continue
        out, _name = _out_writer(path, tag_fn())
        for lo in range(0, len(keep), CH):
            view, total = uniq_text(ix, keep[lo:lo + CH],
                                    ordinals[lo:lo + CH], "smp.text",
                                    sep=0x5F)
            out.write(view[:total].data)
        out.close()
    return ix1.n, len(keep)


def proportion_mode(read1: str, read2: str | None, frac: float, seed: int,
                    fasta: bool) -> tuple[int, int]:
    def select(ix):
        h = x31_hash_batch(ix.data, ix.name_off, ix.name_len)
        frac_val = ((h + np.uint32(seed)) & np.uint32(0xFFFFFF)
                    ).astype(np.float64) / 0x1000000
        keep = np.flatnonzero(frac_val < frac).astype(np.int64)
        return keep, keep + 1

    got = _fast_sample(read1, read2, fasta, select, lambda: "%f" % frac)
    if got is not None:
        return got
    out1, _ = _out_writer(read1, "%f" % frac)
    out2 = None
    r2_iter = None
    if read2 is not None:
        out2, _ = _out_writer(read2, "%f" % frac)
        r2_iter = iter(FastqChunkReader(read2))
    n = 0
    picked = 0
    useed = np.uint32(seed)
    for b1 in FastqChunkReader(read1):
        h = x31_hash_batch(b1.names, b1.name_starts, b1.name_lens)
        frac_val = ((h + useed) & np.uint32(0xFFFFFF)).astype(np.float64) / 0x1000000
        keep = frac_val < frac
        idx = np.flatnonzero(keep)
        ordinals = idx + n + 1
        _emit(b1, idx, ordinals, out1, fasta)
        if r2_iter is not None:
            b2 = next(r2_iter)
            _emit(b2, idx, ordinals, out2, fasta)
        n += b1.n
        picked += len(idx)
    out1.close()
    if out2 is not None:
        out2.close()
    return n, picked


def number_mode(read1: str, read2: str | None, pick: int,
                fasta: bool, timer: StageTimer) -> tuple[int, int]:
    def select(ix):
        if pick > ix.n:
            sys.stderr.write(f"pick_count > read_count ({pick} > {ix.n})\n")
            raise SystemExit(0)
        sys.stderr.write(f"total_reads_num: {ix.n}\n")
        timer.log("Finished count_read at %.3f s\n")
        sel = sample_indices(ix.n, pick)
        timer.log("Start_read at %.3f s\n")
        return sel.astype(np.int64), sel + 1

    got = _fast_sample(read1, read2, fasta, select, lambda: "%d" % pick)
    if got is not None:
        timer.log("End_read at %.3f s\n")
        return got
    n = count_reads(read1)
    sys.stderr.write(f"total_reads_num: {n}\n")
    timer.log("Finished count_read at %.3f s\n")
    if pick > n:
        sys.stderr.write(f"pick_count > read_count ({pick} > {n})\n")
        raise SystemExit(0)
    out1, _ = _out_writer(read1, "%d" % pick)
    out2 = None
    r2_iter = None
    if read2 is not None:
        out2, _ = _out_writer(read2, "%d" % pick)
        r2_iter = iter(FastqChunkReader(read2))
    sel = sample_indices(n, pick)          # sorted ascending ordinals (0-based)
    timer.log("Start_read at %.3f s\n")
    off = 0
    for b1 in FastqChunkReader(read1):
        lo = np.searchsorted(sel, off)
        hi = np.searchsorted(sel, off + b1.n)
        idx = (sel[lo:hi] - off).astype(np.int64)
        ordinals = sel[lo:hi] + 1
        _emit(b1, idx, ordinals, out1, fasta)
        if r2_iter is not None:
            b2 = next(r2_iter)
            _emit(b2, idx, ordinals, out2, fasta)
        off += b1.n
    timer.log("End_read at %.3f s\n")
    out1.close()
    if out2 is not None:
        out2.close()
    return n, pick


def main(argv: list[str]) -> int:
    timer = StageTimer()
    read1 = read2 = None
    frac = -1.0
    seed = 0
    reads_n = 0
    fasta = False
    if not argv:
        _usage()
        return 1
    opts, _ = getopt.gnu_getopt(argv, "1:2:o:s:n:qfh?")
    for flag, val in opts:
        if flag == "-1":
            read1 = val
        elif flag == "-2":
            read2 = val
        elif flag == "-s":
            # strtol integer part is the seed; the remainder parses as frac
            # (reference gzfastq_sample.c:364-368).
            sval = val.strip()
            i = 0
            if i < len(sval) and sval[i] in "+-":
                i += 1
            while i < len(sval) and sval[i].isdigit():
                i += 1
            ipart = int(sval[:i]) if sval[:i] not in ("", "+", "-") else 0
            if ipart != 0:
                seed = glibc_rand_first(ipart)
            frac = float(sval[i:]) if sval[i:] else 0.0
        elif flag == "-n":
            reads_n = int(val)
        elif flag == "-f":
            fasta = True
        elif flag == "-q":
            fasta = False
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    if read1 is None:
        _usage()
        return 1

    if frac > 0:
        n, picked = proportion_mode(read1, read2, frac, seed, fasta)
        sys.stderr.write(f"total reads: {n}\npick out: {picked} "
                         f"({picked}/{n}={picked / n:.6f})\n" if n else "")
    if reads_n:
        n, picked = number_mode(read1, read2, reads_n, fasta, timer)
        sys.stderr.write(f"total reads: {n}\npick out: {picked} "
                         f"({picked}/{n}={picked / n:.6f})\n")
    timer.log("Finished at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch gzfastq_sample {-1 fastq1} [-2 fastq2] [-o OUTFILE] [-s FLOAT] [-n UL] [-h]\n"
        "   [-1 fastq1] = fastq1.                                      [required]\n"
        "   [-2 fastq2] = fastq2.                                      [option]\n"
        "   [-s FLOAT]  = fraction to subsample; integer part = seed.  [option]\n"
        "   [-n UL]     = number of picked reads, not with -s.         [option]\n"
        "   [-f ]       = output fasta format.\n"
        "   [-q ]       = output fastq format [default].\n")
