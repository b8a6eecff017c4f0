"""gzfastq_uniq_sort: dedup keeping the FIRST occurrence, output by count
descending, gzip-compressed.

Mirrors ngstpu/tools/gzfastq_uniq_sort.py (reference gzfastq_uniq_sort.c)
on the port's dedup_groups. Key = seq1 (+ seq2 for PE); outputs
{outfile}_1_uniq.fq.gz (+ _2_uniq.fq.gz for PE) with records
"{name}\\t{count}\\n{seq}\\n+\\n{qual}", count descending with ties in key
order. The PE mate split uses the FIRST read's seq1 length for every
record; -1 also sets the output prefix until -o overrides.

Usage: python -m ngstpu_torch.tools.cli [--device DEV] gzfastq_uniq_sort
       -1 READ1 [-2 READ2] [-o OUTFILE]
"""

from __future__ import annotations

import getopt
import sys

import numpy as np
import torch

from ..io.fastq import format_fastq, read_fastq_file
from ..io.native import concat_pairs, fill_padded
from ..io.stream import ParallelGzipWriter
from ..utils.timing import StageTimer

from ..ops.sortengine import dedup_rows
from ..utils.device import resolve_device

OUT_CHUNK = 1 << 20


def _emit_gz(path: str, batch, rep, counts, seq, lens) -> None:
    """A copy of ngstpu's gzfastq_uniq_sort._emit_gz, whose module imports
    jax."""
    out = ParallelGzipWriter(open(path, "wb"))
    for lo in range(0, len(rep), OUT_CHUNK):
        idx = rep[lo:lo + OUT_CHUNK]
        sub = batch.take(idx)
        suffix = [b"\t%d" % c for c in counts[lo:lo + OUT_CHUNK]]
        out.write(format_fastq(sub.names, sub.name_starts, sub.name_lens,
                               seq[lo:lo + OUT_CHUNK], sub.qual,
                               lens[lo:lo + OUT_CHUNK],
                               qual_lens=sub.lens, count_suffix=suffix))
    out.close()


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
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
    if read1 is None:
        _usage()
        return 1
    dev = resolve_device(device)
    sys.stderr.write(read1 + ("\t" + read2 + "\n" if read2 else "\n"))

    b1 = read_fastq_file(read1)
    n = b1.n
    if read2:
        b2 = read_fastq_file(read2)
        n = min(n, b2.n)
        lmax12 = max(((int(b1.seq.shape[1]) + int(b2.seq.shape[1])) + 3)
                     // 4 * 4, 4)
        key = concat_pairs(b1.seq[:n], b1.lens[:n], b2.seq[:n], b2.lens[:n],
                           lmax12)
        key_lens = (b1.lens[:n].astype(np.int64)
                    + b2.lens[:n].astype(np.int64)).astype(np.int32)
    else:
        key, key_lens = b1.seq, b1.lens

    g = dedup_rows(key, key_lens, np.zeros(len(key_lens), np.uint32), n,
                   dev)
    rep, counts, n_groups = g["rep"], g["counts"], g["n_groups"]
    sys.stderr.write(f"unique reads number = {n_groups}\n")
    timer.log("Finished load hash at %.3f s\n")
    sys.stderr.write(f"total reads = {n}\n")
    if n:
        sys.stderr.write(
            f"unique reads percentage: {n_groups / n * 100:.3f}%\n")

    # count desc, tie -> key asc: heads are already key-asc; stable argsort
    order = np.argsort(-counts.astype(np.int64), kind="stable")
    rep, counts = rep[order], counts[order]

    # mate split at the FIRST read's seq1 length (uniform-length contract)
    str_len = int(b1.lens[0]) if b1.n else 0
    if read2:
        key_rows = key[rep]
        seq1 = key_rows[:, :max(b1.seq.shape[1], str_len)].copy()
        # C memcpys strLen bytes of the key (printf stops at the zero pad
        # when the whole key is shorter)
        seq1_lens = np.minimum(str_len, key_lens[rep]).astype(np.int32)
        l2 = (key_lens[rep].astype(np.int64) - str_len).astype(np.int32)
        np.clip(l2, 0, None, out=l2)
        flat = np.ascontiguousarray(key_rows).reshape(-1)
        row_starts = (np.arange(len(rep), dtype=np.int64)
                      * key_rows.shape[1] + str_len)
        seq2 = fill_padded(flat, row_starts, l2, max(b2.seq.shape[1], 4))
        _emit_gz(outfile + "_1_uniq.fq.gz", b1, rep, counts, seq1,
                 seq1_lens)
        _emit_gz(outfile + "_2_uniq.fq.gz", b2, rep, counts, seq2, l2)
    else:
        seq1 = key[rep]
        seq1_lens = np.minimum(str_len, key_lens[rep]).astype(np.int32)
        _emit_gz(outfile + "_1_uniq.fq.gz", b1, rep, counts, seq1,
                 seq1_lens)
    timer.log("Finished  at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch [--device DEV] gzfastq_uniq_sort [-1 READ1]"
        " [-2 READ2] [-o OUTFILE] [-h]\n")
