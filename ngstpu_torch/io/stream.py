"""Stream helpers: transparent gzip/plain input, '-' == stdin/stdout.

Behavioral model: the reference's IO_stream.h (reference IO_stream.h:53-136)
opens every input through gzdopen so plain and gzip files are read through the
same handle, and treats ``-`` or ``""`` as stdin/stdout. We reproduce that
contract: `open_input` sniffs the gzip magic and returns a binary file object
that yields decompressed bytes either way.
"""

from __future__ import annotations

import gzip
import io
import os
import sys
import zlib
from typing import BinaryIO

import numpy as np


def _is_stdio(name: str | None) -> bool:
    # reference IO_stream.h:55 uses strncmp(filename, "-", 1): any name
    # *starting* with '-' selects stdio, as does the empty string.
    return name is None or name == "" or name.startswith("-")


def open_input(name: str | None) -> BinaryIO:
    """Open a (possibly gzip) input for reading decompressed bytes."""
    if _is_stdio(name):
        raw: BinaryIO = sys.stdin.buffer
    else:
        raw = open(name, "rb")
    head = raw.read(2)
    if head == b"\x1f\x8b":
        merged = _PushbackReader(head, raw)
        return gzip.GzipFile(fileobj=merged, mode="rb")  # type: ignore[return-value]
    if raw.seekable():
        raw.seek(0)  # plain file: hand back the raw stream, no wrapper
        return raw
    return _PushbackReader(head, raw)


class _PushbackReader(io.RawIOBase):
    """Binary reader that replays sniffed magic bytes before the stream."""

    def __init__(self, head: bytes, raw: BinaryIO):
        self._head = head
        self._raw = raw

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        if self._head:
            n = min(len(b), len(self._head))
            b[:n] = self._head[:n]
            self._head = self._head[n:]
            return n
        data = self._raw.read(len(b))
        if not data:
            return 0
        b[: len(data)] = data
        return len(data)

    def close(self) -> None:
        if self._raw is not sys.stdin.buffer:
            self._raw.close()
        super().close()


def _unlink_first(name: str) -> str:
    """Unlink before recreating: truncate-open of a file whose pages are
    still dirty in cache forces synchronous invalidation (measured up to
    ~0.7s per 300MB on a slow-fault VM); unlinking lets the kernel drop the
    old inode's dirty pages in the background instead."""
    try:
        os.unlink(name)
    except OSError:
        pass
    return name


def open_output(name: str | None, gz: bool = False, level: int = 6) -> BinaryIO:
    """Open a binary output; '-' or '' → stdout. gz=True wraps in gzip."""
    if _is_stdio(name):
        out: BinaryIO = sys.stdout.buffer
    else:
        out = open(_unlink_first(name), "wb")
    if gz:
        return GzipRecordWriter(out, level=level)
    return out


def open_text_output(name: str | None):
    """Text-mode output stream for TSV/bedGraph/wig emission."""
    if _is_stdio(name):
        return sys.stdout
    return open(_unlink_first(name), "w")


def with_suffix(outfile: str, suffix: str) -> str:
    """fcreat_outfile semantics (reference IO_stream.h:92-97): name + suffix,
    except stdio names pass through untouched."""
    if _is_stdio(outfile):
        return outfile
    return outfile + suffix


class ParallelGzipWriter:
    """Multi-member gzip writer: buffered text deflates as INDEPENDENT
    gzip members in parallel (ngsio.cpp ngs_gzip_compress_blocks);
    concatenated members are a valid gzip file every reader accepts.

    Used where the contract is decompressed-content parity (the gz
    outputs of gzfastq_sample / gzfastq_uniq_sort / pick_pair — gzip BYTES
    already differ from the reference across zlib versions); tools
    needing the exact single-stream container keep GzipRecordWriter.
    """

    BLOCK = 4 << 20

    def __init__(self, raw: BinaryIO, level: int | None = None):
        self._raw = raw
        # default level 1: the contract for these outputs is decompressed-
        # content parity, and libdeflate L1 measures 3.4x the throughput
        # of L6 for ~4.6% larger files on FASTQ — the right trade for a
        # throughput-first writer. NGSTPU_GZ_LEVEL overrides (e.g. 6 to
        # match the reference's zlib default sizes).
        if level is None:
            level = int(os.environ.get("NGSTPU_GZ_LEVEL", "1"))
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> int:
        self._buf += data
        if len(self._buf) >= 16 << 20:
            self._flush_blocks()
        return len(data)

    def _flush_blocks(self) -> None:
        from .native import get_lib

        data = bytes(self._buf)
        self._buf.clear()
        if not data:
            return
        lib = get_lib()
        if lib is None:
            import gzip as _gzip

            self._raw.write(_gzip.compress(data, self._level, mtime=0))
            return
        n_blocks = (len(data) + self.BLOCK - 1) // self.BLOCK
        starts = np.arange(n_blocks, dtype=np.int64) * self.BLOCK
        lens = np.minimum(self.BLOCK, len(data) - starts)
        caps = lens + (lens >> 9) + 64
        offs = np.zeros(n_blocks, dtype=np.int64)
        np.cumsum(caps[:-1], out=offs[1:])
        payload = np.empty(int(caps.sum()), dtype=np.uint8)
        sizes = np.empty(n_blocks, dtype=np.int64)
        rc = lib.ngs_gzip_compress_blocks(
            np.frombuffer(data, np.uint8), starts, lens, n_blocks,
            payload, caps, offs, sizes, self._level, 0)
        if rc != 0:  # capacity/zlib failure: plain fallback
            import gzip as _gzip

            self._raw.write(_gzip.compress(data, self._level, mtime=0))
            return
        for i in range(n_blocks):
            self._raw.write(
                memoryview(payload)[int(offs[i]):int(offs[i] + sizes[i])])

    def close(self) -> None:
        self._flush_blocks()
        if self._raw is not sys.stdout.buffer:
            self._raw.close()
        else:
            self._raw.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GzipRecordWriter:
    """Buffered gzip writer matching zlib's gzdopen(..., "wb") default output
    (level 6, OS byte 3) so byte-parity with the reference gz outputs is
    achievable. Large internal buffer amortizes compression calls."""

    def __init__(self, raw: BinaryIO, level: int = 6):
        self._raw = raw
        # mtime=0 and OS=3(unix) match zlib's gzprintf container defaults.
        self._comp = zlib.compressobj(level, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
        self._buf = bytearray()

    def write(self, data: bytes) -> int:
        self._buf += data
        if len(self._buf) >= 1 << 20:
            self.flush_compress()
        return len(data)

    def flush_compress(self) -> None:
        if self._buf:
            chunk = self._comp.compress(bytes(self._buf))
            if chunk:
                self._raw.write(chunk)
            self._buf.clear()

    def close(self) -> None:
        self.flush_compress()
        tail = self._comp.flush()
        if tail:
            self._raw.write(tail)
        if self._raw is not sys.stdout.buffer:
            self._raw.close()
        else:
            self._raw.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
