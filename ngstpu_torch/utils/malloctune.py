"""glibc malloc tuning for page-fault-hostile hosts.

Large numpy/C++ buffers (padded batches, format blobs) default to
mmap-backed malloc chunks, which glibc munmaps on free — so EVERY batch
re-pays first-touch page faults. On VMs with a slow fault path (measured
~25MB/s first-touch vs 3-9GB/s warm on one such host) that dominates the
host pipeline. Routing big allocations to the brk heap and disabling trim
makes the process fault each page once and reuse it forever:

    mallopt(M_MMAP_MAX, 0)             never satisfy malloc via mmap
    mallopt(M_TRIM_THRESHOLD, MAX)     never return heap to the kernel

Applied once at ngstpu_torch import (linux/glibc only). Opt out with
NGSTPU_MALLOC=default. The trade is address-space/heap growth up to the
high-water mark of live allocations — the right trade for batch tools.
"""

from __future__ import annotations

import ctypes
import os
import sys

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4

_applied: list[bool] = []


def tune_malloc() -> bool:
    """Apply the tuning once; returns True if active."""
    if _applied:
        return _applied[0]
    ok = False
    if (sys.platform.startswith("linux")
            and os.environ.get("NGSTPU_MALLOC", "keep") != "default"):
        try:
            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            ok = bool(libc.mallopt(_M_MMAP_MAX, 0)) and \
                bool(libc.mallopt(_M_TRIM_THRESHOLD, 0x7FFFFFFF))
        except OSError:
            ok = False
    _applied.append(ok)
    return ok


def prefault(n_bytes: int) -> None:
    """Touch n_bytes of heap once so later allocations reuse warm pages.
    Cheap no-op when the tuning is inactive."""
    if not tune_malloc():
        return
    buf = bytearray(n_bytes)
    for i in range(0, n_bytes, 4096):
        buf[i] = 1
    del buf
