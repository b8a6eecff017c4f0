"""fastq2twobit: pack FASTQ sequences into the reference 2-bit container.

Mirrors ngstpu/tools/fastq2twobit.py (reference fastq2twobit.c): a 2-byte
header {readLen, packedLen} from the FIRST emitted record, then each
record's ceil(len/4) packed bytes, records in REVERSE input order. The
output gets the reference's "_sort_by_seq.fq" ("_sort_by_name.fq" with -n)
suffix; the default "-" writes to stdout.

The offset-indexed fast path, _run_fast (a copy of ngstpu's), runs on the
host. The generic path packs on `device` (ops/twobit.pack2bit) when the
link verdict is 'device' and the operand is at least DEVICE_MIN_BYTES, and
with the numpy codec otherwise.

Usage: python -m ngstpu_torch.tools.cli [--device DEV] fastq2twobit
       -i IN -o OUTFILE [-s|-n]
"""

from __future__ import annotations

import getopt
import os
import sys

import numpy as np
import torch

from ..io.fastq import read_fastq_file
from ..io.stream import open_output, with_suffix
from ..ops.twobit import pack2bit
from ..ops.twobit_host import pack2bit_np
from ..utils.device import resolve_device
from ..utils.linkprobe import link_verdict
from ..utils.timing import StageTimer

# smallest operand the codec ships to the device (ngstpu's 8 MB rule)
DEVICE_MIN_BYTES = 8 << 20


def _run_fast(infile: str, outfile: str, by_name: int, by_seq: int,
              timer: StageTimer) -> bool:
    """Offset-indexed pack (round-5): mmap + index, then chunked
    fill_padded -> numpy 2-bit pack -> ragged flatten, walking records in
    REVERSE input order (the reference's prepend-list dump,
    fastq2twobit.c:101-113) without ever materializing the padded batch.
    Returns False when the fast path does not apply (stdout, gz handled
    via the shared inflate, no native lib)."""
    from ..io.fastindex import index_fastq
    from ..io.native import get_lib
    from ..utils.bufpool import get_buffer

    lib = get_lib()
    if lib is None or outfile.startswith("-") or not outfile:
        return False
    ix = index_fastq(infile, pool="f2b.ix")
    if ix is None:
        return False
    timer.log("done read file at %.3f s\n")
    suffix = ("_sort_by_name.fq" if (by_name and not by_seq)
              else "_sort_by_seq.fq")
    B = ix.n
    with open(with_suffix(outfile, suffix), "wb") as out:
        if B:
            last = B - 1
            read_len = int(ix.seq_len[last]) & 0xFF
            packed_len = ((int(ix.seq_len[last]) + 3) // 4) & 0xFF
            out.write(bytes([read_len, packed_len]))
            CH = 1 << 19
            lmax = max(int(ix.seq_len.max()), 1)
            lmax4 = (lmax + 3) // 4 * 4
            for hi in range(B, 0, -CH):
                lo = max(hi - CH, 0)
                k = hi - lo
                # reversed record order within the chunk
                offs = ix.seq_off[lo:hi][::-1].copy()
                lens = ix.seq_len[lo:hi][::-1].copy()
                padded = get_buffer("f2b.pad", k * lmax4).reshape(k, lmax4)
                lib.ngs_fill_padded(ix.data, offs, lens, k, lmax4,
                                    padded, 0)
                packed = pack2bit_np(padded)
                plens = ((lens.astype(np.int64) + 3) // 4).astype(np.int32)
                col = np.arange(packed.shape[1])
                flat = packed[col[None, :] < plens[:, None]]
                out.write(flat.tobytes())
    timer.log("done write file at %.3f s\n")
    return True


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
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
    sys.stderr.write(f"name: {by_name}\tseq: {by_seq}\n")
    dev = resolve_device(device)

    if not os.environ.get("NGSTPU_NO_FASTPATH") \
            and _run_fast(infile, outfile, by_name, by_seq, timer):
        return 0
    batch = read_fastq_file(infile, need=("seq",))
    timer.log("done read file at %.3f s\n")
    seq = np.ascontiguousarray(batch.seq)
    if seq.shape[1] % 4:
        seq = np.pad(seq, ((0, 0), (0, 4 - seq.shape[1] % 4)))
    if link_verdict() == "device" and seq.nbytes >= DEVICE_MIN_BYTES:
        packed = pack2bit(torch.from_numpy(seq).to(dev)).cpu().numpy()
    else:
        packed = pack2bit_np(seq)
    suffix = ("_sort_by_name.fq" if (by_name and not by_seq)
              else "_sort_by_seq.fq")
    out = open_output(with_suffix(outfile, suffix))

    order = np.arange(batch.n - 1, -1, -1)  # reverse input order
    lens = batch.lens
    if batch.n:
        first = int(order[0])
        read_len = int(lens[first]) & 0xFF
        packed_len = ((int(lens[first]) + 3) // 4) & 0xFF
        out.write(bytes([read_len, packed_len]))
        # each record contributes ceil(len/4) bytes of its own packed row
        plens = ((lens[order].astype(np.int64) + 3) // 4).astype(np.int32)
        rows = packed[order]
        col = np.arange(rows.shape[1])
        flat = rows[col[None, :] < plens[:, None]]
        out.write(flat.tobytes())
    if out is not sys.stdout.buffer:
        out.close()
    else:
        out.flush()
    timer.log("done write file at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch [--device DEV] fastq2twobit [-i Infile]"
        " [-o OUTFILE] [-s|-n] [-h]\n")
