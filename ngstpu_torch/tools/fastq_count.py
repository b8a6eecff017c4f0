"""fastq_count: per-file read/base counts, length stats, Q20/Q30 (torch).

Mirrors ngstpu/tools/fastq_count.py, with the port's QCAccumulator: the
same flags, the same output row (reference fastq_count.c:127) and the same
-H / -L lines. Indexed plain files take the native fused pass on the host;
other input (gzip that does not index, stdin) goes through the device
histogram on `device`.
"""

from __future__ import annotations

import getopt
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..io.fastq import FastqChunkReader
from ..utils.timing import StageTimer

from ..ops.count import QCAccumulator
from ..utils.device import resolve_device


def count_file(path: str, device: str | torch.device) -> QCAccumulator:
    if not os.environ.get("NGSTPU_NO_FASTPATH"):
        from ..io.fastindex import fused_stats, index_fastq
        from ..utils.bufpool import get_buffer, get_matrix

        ix = index_fastq(path)
        if ix is not None:
            # one offset-based pass over the mmap'd bytes; the (tiny)
            # 1-word pack the fused kernel also emits is discarded
            B = ix.n
            hist_q = np.zeros((512, 128), np.uint64)
            hist_len = np.zeros(512, np.uint64)
            bucket = np.zeros(256, np.uint32)
            words = get_matrix("count.words", max(B, 1), 1, np.uint32)
            sumq = get_buffer("count.sumq", 4 * max(B, 1), np.uint32)
            for lo in range(0, B, 1 << 20):
                hi = min(lo + (1 << 20), B)
                fused_stats(ix, lo, hi, 1, words[lo:hi], sumq[lo:hi],
                            hist_q, hist_len, bucket)
            return QCAccumulator.from_host_partials(hist_q, hist_len)
    acc = QCAccumulator(device)
    for batch in FastqChunkReader(path, need=("qual",)):
        acc.add_batch(batch.qual, batch.lens, batch.n)
    return acc


def _row(path: str, acc: QCAccumulator) -> str:
    s = acc.stats()
    return (f"{path}\t{s['read_count']}\t{s['base_count']:.0f}\t"
            f"{s['mean_len']:.0f}\t{s['min_len']}\t{s['max_len']}\t"
            f"{s['q20_pct']:.3f}\t{s['q30_pct']:.3f}\n")


def _len_detail(acc: QCAccumulator) -> str:
    s = acc.stats()
    lo, hi = s["min_len"], s["max_len"]
    idx = range(lo, hi + 1)
    out = "#Len:" + "".join(f"\t{i}" for i in idx) + "\n"
    out += "#Freq:" + "".join(f"\t{int(acc.seq_len[i])}" for i in idx) + "\n"
    return out


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
    timer = StageTimer()
    outfile, threads, header, length_detail = "-", 0, False, False
    opts, files = getopt.gnu_getopt(argv, "o:t:HLh?")
    for flag, val in opts:
        if flag == "-o":
            outfile = val
        elif flag == "-t":
            threads = int(val)
        elif flag == "-H":
            header = True
        elif flag == "-L":
            length_detail = True
        else:
            _usage()
            return 1
    if not files:
        _usage()
        return 1
    dev = resolve_device(device)
    threads = max(1, min(threads or len(files), len(files)))

    out = sys.stdout if outfile.startswith("-") or outfile == "" else open(outfile, "w")
    if header:
        out.write("#Filename\tReadCount\tBaseCount\tMeanLen\tMinLen\tMaxLen\tQ20(%)\tQ30(%)\n")
    if threads > 1:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            accs = list(pool.map(lambda f: count_file(f, dev), files))
    else:
        accs = [count_file(f, dev) for f in files]
    for path, acc in zip(files, accs):
        out.write(_row(path, acc))
        if length_detail:
            out.write(_len_detail(acc))
    timer.log("Finished at %.3f s\n")
    if out is not sys.stdout:
        out.close()
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch [--device DEV] fastq_count file1.fq file2.fq ..."
        " [-o outfile] [-t thread] [-H] [-L] [-h]\n"
        "   [-o OUTPUT] = OUTPUT file. default is stdout.\n"
        "   [-H ]       = output the Header information.\n"
        "   [-L ]       = output the read length detail.\n"
        "   [-t ]       = thread count (default: number of input files).\n")
