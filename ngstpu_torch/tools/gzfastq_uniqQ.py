"""gzfastq_uniqQ: SE dedup keeping EVERY (name, quality) per unique sequence.

Mirrors ngstpu/tools/gzfastq_uniqQ.py (reference gzfastq_uniqQ.c) on the
port's dedup_groups. The stored head is the LAST occurrence; the record is
"{name of last occurrence}\\t{count}\\n{key}\\n+\\n" followed by one quality
line per occurrence in reverse input order. Order: -S (default)
key-ascending, -C count-descending. Output: outfile + "_sortKeyUniq.fq".

Usage: python -m ngstpu_torch.tools.cli [--device DEV] gzfastq_uniqQ
       -1 READ1 -o OUTFILE [-S|-C]
"""

from __future__ import annotations

import getopt
import sys

import numpy as np
import torch

from ..io.fastq import read_fastq_file
from ..io.stream import open_output, with_suffix
from ..utils.timing import StageTimer

from ..ops.sortengine import dedup_rows
from ..utils.device import resolve_device


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
    timer = StageTimer()
    read1, outfile = "-", "-"
    sort_by_seq = True
    if not argv:
        _usage()
        return 1
    opts, _ = getopt.gnu_getopt(argv, "1:o:CSh?")
    for flag, val in opts:
        if flag == "-1":
            read1 = val
        elif flag == "-o":
            outfile = val
        elif flag == "-S":
            sort_by_seq = True
        elif flag == "-C":
            sort_by_seq = False
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    dev = resolve_device(device)

    batch = read_fastq_file(read1)
    n = batch.n
    # sumq=0 -> members ordered by input index within each group
    g = dedup_rows(batch.seq, batch.lens, np.zeros(n, np.uint32), n, dev)
    perm = g["perm"]
    n_groups = g["n_groups"]
    sys.stderr.write(
        f"unique reads number = {n_groups}({n_groups} / {n} = "
        f"{100.0 * n_groups / n:.3f}%)\n" if n else "")
    timer.log("Finished load hash at %.3f s\n")

    head_pos = g["head_pos"]                      # [G] sorted-row index
    counts = g["counts"]
    if not sort_by_seq:
        order = np.argsort(-counts.astype(np.int64), kind="stable")
    else:
        order = np.arange(len(head_pos))

    out = open_output(with_suffix(outfile, "_sortKeyUniq.fq"))
    write = out.write
    for gi in order:
        hp = int(head_pos[gi])
        c = int(counts[gi])
        members = perm[hp:hp + c]                 # input-index ascending
        last = int(members[-1])
        key_i = int(members[0])                   # first occurrence == key
        write(batch.name(last) + b"\t%d\n" % c)
        write(batch.seq_bytes(key_i) + b"\n+\n")
        for m in members[::-1]:
            write(batch.qual_bytes(int(m)) + b"\n")
    if out is not sys.stdout.buffer:
        out.close()
    else:
        out.flush()
    timer.log("Finished  at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch [--device DEV] gzfastq_uniqQ [-1 READ1]"
        " [-C sort by count] [-S sort by seq] [-o OUTFILE] [-h]\n")
