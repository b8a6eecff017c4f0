"""twoBit2seq: unpack the 2-bit container back into one sequence per line.

Mirrors ngstpu/tools/twobit2seq.py (reference twoBit2seq.c): the 2-byte
header {readLen, packedLen}, then fixed packedLen-byte records, each
unpacked to readLen bases of "TCAG". Output file = outfile + ".decompress"
(default outfile "out"); input is plain binary. The unpack runs on `device`
(ops/twobit.unpack2bit) when the link verdict is 'device' and the records
take at least fastq2twobit.DEVICE_MIN_BYTES, and with the numpy codec
otherwise.

Usage: python -m ngstpu_torch.tools.cli [--device DEV] twoBit2seq
       -i IN [-o OUTFILE]
"""

from __future__ import annotations

import getopt
import sys

import numpy as np
import torch

from ..ops.twobit_host import unpack2bit_np
from ..utils.timing import StageTimer

from ..ops.twobit import unpack2bit
from ..utils.device import resolve_device
from ..utils.linkprobe import link_verdict
from . import fastq2twobit


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
    timer = StageTimer()
    infile, outfile = "-", "out"
    if not argv:
        _usage()
        return 1
    opts, _ = getopt.gnu_getopt(argv, "i:o:c:h?")
    for flag, val in opts:
        if flag == "-i":
            infile = val
        elif flag == "-o":
            outfile = val
        elif flag == "-c":
            pass  # compress level accepted, unused (matches reference)
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    dev = resolve_device(device)

    if infile.startswith("-") or infile == "":
        data = sys.stdin.buffer.read()
    else:
        with open(infile, "rb") as f:
            data = f.read()
    if outfile.startswith("-") or outfile == "":
        out = sys.stdout.buffer
    else:
        out = open(outfile + ".decompress", "wb")
    if len(data) >= 2:
        read_len, packed_len = data[0], data[1]
        payload = np.frombuffer(data, dtype=np.uint8, offset=2)
        n_rec = len(payload) // packed_len if packed_len else 0
        rows = payload[: n_rec * packed_len].reshape(n_rec, packed_len)
        if link_verdict() == "device" \
                and rows.nbytes >= fastq2twobit.DEVICE_MIN_BYTES:
            bases = unpack2bit(torch.from_numpy(rows.copy()).to(dev)
                               ).cpu().numpy()[:, :read_len]
        else:
            bases = unpack2bit_np(rows)[:, :read_len]
        block = np.concatenate(
            [bases, np.full((n_rec, 1), 0x0A, np.uint8)], axis=1)
        out.write(block.tobytes())
    if out is not sys.stdout.buffer:
        out.close()
    else:
        out.flush()
    timer.log("done read file at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch [--device DEV] twoBit2seq [-i Infile]"
        " [-o OUTFILE] [-c level] [-h]\n")
