"""index: build a samtools-compatible .bai for a BAM file.

The reference delegates indexing to external samtools (its tools then
bam_index_load the result, e.g. reference bam2depth.c:112-119); the port
generates the index natively so reference-style consumers can fetch from
BAMs we produce.

Usage: ngstpu-torch index <in.bam> [out.bai]
"""

from __future__ import annotations

import sys

from ..io.bai import write_bai


def main(argv: list[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write("Usage: ngstpu-torch index <in.bam> [out.bai]\n")
        return 1
    out = write_bai(argv[0], argv[1] if len(argv) > 1 else None)
    sys.stderr.write(f"wrote {out}\n")
    return 0
