"""fastq_count_kthread: map-reduce fastq_count, per-file TSVs + merged row.

Mirrors ngstpu/tools/fastq_count_kthread.py (reference
fastq_count_kthread.c) on the port's count_file and QCAccumulator. Input
file i writes basename(file).{i}.tsv in the working directory: the stats
row with the file name, and with -L the length detail and the full
128 x maxLen quality matrix (printQ). The merged row (to -o or stdout) has
no file name. -t N counts N files at once, each in its own thread; on the
generic route each launches the QC histogram kernel on `device`.

Usage: python -m ngstpu_torch.tools.cli [--device DEV] fastq_count_kthread
       file1.fq ... [-o outfile] [-t thread] [-H] [-L]
"""

from __future__ import annotations

import getopt
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..utils.timing import StageTimer

from ..ops.count import QCAccumulator
from ..utils.device import resolve_device
from .fastq_count import _row, count_file


def _detail(acc: QCAccumulator, min_len: int, max_len: int) -> str:
    idx = range(min_len, max_len + 1)
    out = "#Len:" + "".join(f"\t{i}" for i in idx) + "\n"
    out += "#Freq:" + "".join(f"\t{int(acc.seq_len[i])}" for i in idx) + "\n"
    # printQ: the full quality matrix, 128 rows x max_len cycles
    q = acc.quality
    rows = ["\t".join(str(int(v)) for v in q[r, :max_len]) for r in range(128)]
    return out + "\n".join(rows) + "\n"


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

    if threads > 1:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            accs = list(pool.map(lambda f: count_file(f, dev), files))
    else:
        accs = [count_file(f, dev) for f in files]

    for i, (path, acc) in enumerate(zip(files, accs)):
        with open(os.path.basename(path) + f".{i}.tsv", "w") as per_out:
            if header:
                per_out.write("#Filename\tReadCount\tBaseCount\tMeanLen\t"
                              "MinLen\tMaxLen\tQ20(%)\tQ30(%)\n")
            per_out.write(_row(path, acc))
            if length_detail:
                s = acc.stats()
                per_out.write(_detail(acc, s["min_len"], s["max_len"]))

    total = QCAccumulator(dev)
    for acc in accs:
        total.merge(acc)
    s = total.stats()
    out = sys.stdout if outfile.startswith("-") or outfile == "" else open(outfile, "w")
    if header:
        out.write("#ReadCount\tBaseCount\tMeanLen\tMinLen\tMaxLen\tQ20(%)\tQ30(%)\n")
    # the reduce takes the min over per-file minLens (start 10000, :182,189)
    min_len = min((a.stats()["min_len"] for a in accs), default=10000)
    max_len = max((a.stats()["max_len"] for a in accs), default=0)
    out.write(f"{s['read_count']}\t{s['base_count']:.0f}\t{s['mean_len']:.0f}\t"
              f"{min_len}\t{max_len}\t{s['q20_pct']:.3f}\t{s['q30_pct']:.3f}\n")
    if length_detail:
        out.write(_detail(total, min_len, max_len))
    if out is not sys.stdout:
        out.close()
    timer.log("Finished at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch [--device DEV] fastq_count_kthread file1.fq ..."
        " [-o outfile] [-t thread] [-H] [-L] [-h]\n")
