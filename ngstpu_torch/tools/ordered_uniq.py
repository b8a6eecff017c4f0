"""ordered_uniq: ordered dedup with order-statistics (rank) queries.

Mirrors ngstpu/tools/ordered_uniq.py on the port's dedup_groups: one sort;
ordered iteration is the sorted order, and rank(key) / select(rank) are
index arithmetic on the sorted unique set. Every unique record is dumped in
key order as "name\\trank\\nseq\\n+\\nqual" (first occurrence kept); -r K
prints only ranks 1..K. stderr reports the unique count.

Usage: python -m ngstpu_torch.tools.cli [--device DEV] ordered_uniq
       [-i IN] [-o OUT] [-r K]
"""

from __future__ import annotations

import bisect
import getopt
import sys

import numpy as np
import torch

from ..io.fastq import read_fastq_file
from ..io.native import format_fastq_take
from ..io.stream import open_output
from ..utils.timing import StageTimer

from ..ops.sortengine import dedup_rows
from ..utils.device import resolve_device


def ordered_unique(batch, device: torch.device):
    """(rep, counts): unique sequences in key order, first-occurrence
    representatives (rank i = row i of the result, 1-based)."""
    g = dedup_rows(batch.seq, batch.lens, np.zeros(batch.n, np.uint32),
                   batch.n, device)
    return g["rep"], g["counts"]


def rank_of(sorted_rep_seqs: list[bytes], seq: bytes) -> int:
    """1-based rank of `seq` in the unique set (bisect = the skiplist's
    key_rank); 0 if absent. A copy of ngstpu's ordered_uniq.rank_of, whose
    module imports jax."""
    i = bisect.bisect_left(sorted_rep_seqs, seq)
    if i < len(sorted_rep_seqs) and sorted_rep_seqs[i] == seq:
        return i + 1
    return 0


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
    timer = StageTimer()
    infile, outfile, top_k = "-", "-", 0
    opts, _ = getopt.gnu_getopt(argv, "i:o:r:h?")
    for flag, val in opts:
        if flag == "-i":
            infile = val
        elif flag == "-o":
            outfile = val
        elif flag == "-r":
            top_k = int(val)
        elif flag in ("-h", "-?"):
            sys.stderr.write(
                "Usage: ngstpu-torch [--device DEV] ordered_uniq [-i IN]"
                " [-o OUT] [-r K]\n"
                "  ordered dedup by sequence; -r K prints only ranks 1..K\n")
            return 1
    dev = resolve_device(device)
    batch = read_fastq_file(infile)
    rep, counts = ordered_unique(batch, dev)
    sys.stderr.write(f"{len(rep)}\n")  # kbtree_kseq.c:40 prints kb_size
    if top_k:
        rep = rep[:top_k]
    ranks = np.arange(1, len(rep) + 1, dtype=np.int64)
    out = open_output(outfile)
    text = format_fastq_take(batch.names, batch.name_starts, batch.name_lens,
                             rep, ranks, batch.seq, batch.lens, rep,
                             batch.qual, batch.lens, rep)
    if text is not None:
        out.write(text)
    else:  # no native lib: small-python fallback
        for r, k in zip(rep.tolist(), ranks.tolist()):
            out.write(batch.name(r) + b"\t%d\n" % k)
            out.write(batch.seq_bytes(r) + b"\n+\n")
            out.write(batch.qual_bytes(r) + b"\n")
    if out is not sys.stdout.buffer:
        out.close()
    timer.log("Finished at %.3f s\n")
    return 0
