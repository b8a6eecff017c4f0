"""bamSplitChr: split a BAM into one BAM per chromosome.

Parity target: reference bamSplitChr.c. Per chromosome j the output
"{outfile or bamfile}_{chrname}.bam" carries the FULL original header
(samopen "wbh", :117,130-131) and the records fetched for that chromosome
(all records with that tid, in file order). -u / -1 select compression
level 0 / 1 (:96-97). Records are copied byte-verbatim from the source
(re-encoding is unnecessary: BAM record payloads are position-independent).
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from ..io.bam import BamStream, write_bam
from ..utils.timing import StageTimer


def _split_stream(path: str, prefix: str, level: int,
                  timer: StageTimer) -> None:
    """Stream the BAM in bounded batches; each chromosome's BAM is written
    (and its buffered record bytes released) as soon as a coordinate-
    grouped stream moves past its tid. Interleaved-tid inputs accumulate
    until EOF — identical outputs."""
    stream = BamStream(path)
    header = stream.header
    pending: dict[int, list[bytes]] = {}
    counts: dict[int, int] = {}
    flushed = 0
    monotone = True
    last_tid = -1

    def flush(j: int) -> None:
        name, tlen = header.ref_names[j], header.ref_lens[j]
        rec_bytes = b"".join(pending.pop(j, []))
        write_bam(f"{prefix}_{name}.bam", header, rec_bytes, level=level)
        sys.stderr.write(
            f"chr: {name}\tchr_len: {tlen}\treads_count: {counts.get(j, 0)} "
            f"at {timer.elapsed():.3f} s\n")

    for cols in stream:
        body = cols.body
        mapped = cols.tid[cols.tid >= 0]
        for j in np.unique(mapped):
            sel = np.flatnonzero(cols.tid == j)
            pending.setdefault(int(j), []).append(b"".join(
                body[int(cols.rec_offset[k]):
                     int(cols.rec_offset[k]) + int(cols.rec_len[k])].tobytes()
                for k in sel))
            counts[int(j)] = counts.get(int(j), 0) + len(sel)
        if monotone and len(mapped):
            if mapped[0] < last_tid or (np.diff(mapped) < 0).any():
                monotone = False
            else:
                last_tid = int(mapped[-1])
        if monotone:
            while flushed < last_tid and flushed < header.n_refs:
                flush(flushed)
                flushed += 1
    for j in range(flushed, header.n_refs):
        flush(j)


def main(argv: list[str]) -> int:
    timer = StageTimer()
    outfile = None
    level = 6
    if not argv:
        _usage()
        return 1
    # C optString is "o:w:r:s:u:1:h?" — -u/-1 greedily consume a value; we
    # accept them valueless or with a value for compatibility.
    opts, files = getopt.gnu_getopt(argv, "o:w:r:s:u1h?")
    for flag, val in opts:
        if flag == "-o":
            outfile = val
        elif flag == "-u":
            level = 0
        elif flag == "-1":
            level = 1
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    if not files:
        _usage()
        return 1

    for path in files:
        _split_stream(path, outfile if outfile else path, level, timer)
        sys.stderr.write(
            f"splited {path} into each chromosome at {timer.elapsed():.3f} s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch bamSplitChr [-o OUTFILE_PREFIX] [-u] [-1] [-h] bam1 ...\n")
