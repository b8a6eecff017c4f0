"""BGZF block-compressed format: parallel reader + writer.

BAM files are BGZF: concatenated gzip members each carrying a BSIZE extra
field (total block size - 1). The reference reads them through samtools'
bgzf.c / klib bgzf.c (reference klib/bgzf.h:84-112). Here the reader scans
block boundaries from the headers (cheap) and inflates all blocks in
parallel through the native zlib path; the writer emits spec-compliant
64KB blocks plus the BGZF EOF marker, compressing blocks in parallel.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib

import numpy as np

from .native import get_lib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_HDR = struct.Struct("<4BI2B2H")


def _scan_blocks_ex(data: bytes, partial: bool = False
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Walk BGZF headers; returns (starts, comp_lens, isize, consumed).

    partial=True stops cleanly at a block the buffer truncates (streaming
    readers carry the tail into the next read); corrupt structure (bad
    magic, missing BSIZE) raises in both modes."""
    starts, lens, isizes = [], [], []
    o = 0
    n = len(data)
    while o + 18 <= n:
        if data[o] != 0x1F or data[o + 1] != 0x8B:
            raise ValueError("bad BGZF magic")
        xlen = struct.unpack_from("<H", data, o + 10)[0]
        if o + 12 + xlen > n:
            if partial:
                break
            raise ValueError("truncated BGZF header")
        # find BC subfield
        xo = o + 12
        bsize = None
        end_x = xo + xlen
        while xo + 4 <= end_x:
            si1, si2, slen = data[xo], data[xo + 1], struct.unpack_from("<H", data, xo + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", data, xo + 4)[0] + 1
            xo += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BSIZE")
        if o + bsize > n:
            if partial:
                break
            raise ValueError("truncated BGZF block")
        isize = struct.unpack_from("<I", data, o + bsize - 4)[0]
        starts.append(o)
        lens.append(bsize)
        isizes.append(isize)
        o += bsize
    return (np.array(starts, dtype=np.int64), np.array(lens, dtype=np.int64),
            np.array(isizes, dtype=np.int64), o)


def _scan_blocks(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    starts, lens, isizes, _ = _scan_blocks_ex(data)
    return starts, lens, isizes


def _inflate_scanned(lib, arr, starts, lens, isizes, out, out_offsets,
                     out_sizes) -> int:
    """Inflate one batch of per-member scanned BGZF blocks (native).

    Prefers the raw-DEFLATE path (ngs_bgzf_inflate_blocks): the member
    framing was already parsed host-side by the scanners here, so decode
    skips libdeflate's gzip-wrapper walk and its mandatory whole-output
    CRC32 — callers still enforce produced size == ISIZE, and
    NGSTPU_BGZF_CRC=1 turns full CRC verification back on. Any failure
    falls back to the gzip-member walk (ngs_gzip_decompress_blocks).
    Returns the final rc (0 = success)."""
    n = len(starts)
    verify = 1 if os.environ.get("NGSTPU_BGZF_CRC") else 0
    rc = lib.ngs_bgzf_inflate_blocks(arr, starts, lens, n, out, out_offsets,
                                     isizes, out_sizes, verify, 0)
    if rc != 0:
        rc = lib.ngs_gzip_decompress_blocks(arr, starts, lens, n, out,
                                            out_offsets, isizes, out_sizes, 0)
    return rc


def _scan_blocks_from(data, off: int, budget: int, file_end: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Walk BGZF headers over mmapped bytes starting at block-start `off`,
    stopping once `budget` compressed bytes are covered (always taking at
    least one block). Unlike _scan_blocks_ex there is no 'partial' mode:
    the whole file is addressable, so a header or block extending past
    file_end is definitively truncated and raises. Returns
    (starts, comp_lens, isizes, next_off)."""
    starts, lens, isizes = [], [], []
    o = off
    stop = off + budget
    while o < stop and o < file_end:
        if o + 18 > file_end:
            raise ValueError("truncated BGZF block")
        if data[o] != 0x1F or data[o + 1] != 0x8B:
            raise ValueError("bad BGZF magic")
        xlen = struct.unpack_from("<H", data, o + 10)[0]
        if o + 12 + xlen > file_end:
            raise ValueError("truncated BGZF header")
        xo = o + 12
        bsize = None
        end_x = xo + xlen
        while xo + 4 <= end_x:
            si1, si2, slen = data[xo], data[xo + 1], \
                struct.unpack_from("<H", data, xo + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", data, xo + 4)[0] + 1
            xo += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BSIZE")
        if o + bsize > file_end:
            raise ValueError("truncated BGZF block")
        starts.append(o)
        lens.append(bsize)
        isizes.append(struct.unpack_from("<I", data, o + bsize - 4)[0])
        o += bsize
    return (np.array(starts, np.int64), np.array(lens, np.int64),
            np.array(isizes, np.int64), o)


def _scan_blocks_span(data, off: int, last_start: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Walk BGZF headers from byte `off` (which must be a block start)
    through the block starting at `last_start` inclusive — touching only
    the compressed bytes of that span. The seek-then-bounded-scan the BAI
    virtual offsets make possible (samtools' bam_fetch block skip,
    reference bam2depth.c:121-130) instead of a whole-file block scan."""
    starts, lens, isizes = [], [], []
    o = off
    n = len(data)
    while o <= last_start and o + 18 <= n:
        if data[o] != 0x1F or data[o + 1] != 0x8B:
            raise ValueError("bad BGZF magic (corrupt virtual offset?)")
        xlen = struct.unpack_from("<H", data, o + 10)[0]
        if o + 12 + xlen > n:
            raise ValueError("truncated BGZF header")
        xo = o + 12
        bsize = None
        end_x = xo + xlen
        while xo + 4 <= end_x:
            si1, si2, slen = data[xo], data[xo + 1], \
                struct.unpack_from("<H", data, xo + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", data, xo + 4)[0] + 1
            xo += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BSIZE")
        if o + bsize > n:
            raise ValueError("truncated BGZF block")
        starts.append(o)
        lens.append(bsize)
        isizes.append(struct.unpack_from("<I", data, o + bsize - 4)[0])
        o += bsize
    return (np.array(starts, np.int64), np.array(lens, np.int64),
            np.array(isizes, np.int64))


def _inflate_blocks(data: bytes, starts: np.ndarray, lens: np.ndarray,
                    isizes: np.ndarray) -> bytes:
    """Inflate a scanned block set (native parallel; zlib fallback)."""
    lib = get_lib()
    if lib is not None and len(starts):
        total = int(isizes.sum())
        out = np.empty(total, dtype=np.uint8)
        out_offsets = np.zeros(len(starts), dtype=np.int64)
        np.cumsum(isizes[:-1], out=out_offsets[1:])
        out_sizes = np.empty(len(starts), dtype=np.int64)
        arr = np.frombuffer(data, dtype=np.uint8)
        rc = _inflate_scanned(lib, arr, np.ascontiguousarray(starts),
                              np.ascontiguousarray(lens),
                              np.ascontiguousarray(isizes), out, out_offsets,
                              out_sizes)
        if rc == 0 and (out_sizes == isizes).all():
            return out.tobytes()
    chunks = []
    for s, ln in zip(starts.tolist(), lens.tolist()):
        chunks.append(gzip.decompress(data[s:s + ln]))
    return b"".join(chunks)


def iter_inflated(path: str, chunk_bytes: int = 32 << 20):
    """Stream a BGZF file as inflated byte batches with bounded memory —
    the role of samtools' incremental bgzf_read (reference klib
    bgzf.h:84-112), but block-parallel per batch. A 100GB BAM never holds
    more than ~2x chunk_bytes of compressed+inflated data at once."""
    max_block = (1 << 16) + 18
    with open(path, "rb") as f:
        tail = b""
        while True:
            data = f.read(chunk_bytes)
            if not data:
                break
            buf = tail + data if tail else data
            starts, lens, isizes, consumed = _scan_blocks_ex(buf, partial=True)
            tail = buf[consumed:]
            if len(starts) == 0:
                if len(tail) > max_block:
                    raise ValueError("truncated BGZF block")
                continue
            yield _inflate_blocks(buf, starts, lens, isizes)
        if tail:
            raise ValueError("truncated BGZF block")


class PooledInflater:
    """Streaming BGZF inflate into ONE pooled buffer with zero whole-chunk
    copies: each `next_chunk(carry)` copies the (small) unprocessed tail of
    the previous inflated chunk to the buffer head and inflates the next
    batch of blocks right after it. Compared to iter_inflated + bytes
    concatenation this removes two full passes over the inflated stream
    (the .tobytes() copy and the carry+data concat) and never re-faults
    pages across chunks or runs — the decode half of what samtools'
    bgzf_read buffer reuse does (reference klib bgzf.h:84-112), sized for
    multi-GB WGS BAMs.

    The compressed side is mmapped (MADV_SEQUENTIAL): header scans and the
    native inflate read the page cache directly, eliminating the
    f.read() copy of every compressed byte (~1 GB of memcpy on a WGS BAM —
    measurable on a host with a ~1 GB/s memory system) and the
    partial-block carry bytes the read() path had to stitch across chunk
    boundaries.

    prefetch=True overlaps the NEXT chunk's read+inflate with the caller's
    processing of the current one: inflation lands at a fixed reserve
    offset of an alternating second pooled buffer BEFORE the caller's
    carry is known; next_chunk then just copies the (small) carry into the
    tail of the reserve area in front of it. The decode thread(s) inside
    ngs_gzip_decompress_blocks keep both cores busy while the caller's
    single-threaded record scan runs — the kt_pipeline read/compute
    overlap of the reference (klib/kthread.c:83-143) on the input side.
    A carry larger than the reserve (a record spanning >reserve inflated
    bytes) falls back to one extra copy into a side buffer.

    Requires the native library (callers gate on get_lib()).
    """

    def __init__(self, path: str, chunk_bytes: int = 32 << 20,
                 pool: str = "bgzf.pooled", prefetch: bool = False,
                 reserve: int = 1 << 20, depth: int = 2):
        import mmap as _mmap
        import queue as _queue
        import threading as _threading

        self._f = open(path, "rb")
        self._size = os.fstat(self._f.fileno()).st_size
        self._mm = None
        self._arr = np.zeros(0, np.uint8)
        if self._size:
            self._mm = _mmap.mmap(self._f.fileno(), 0,
                                  prot=_mmap.PROT_READ)
            if hasattr(self._mm, "madvise"):
                try:
                    self._mm.madvise(_mmap.MADV_SEQUENTIAL)
                except (OSError, AttributeError):
                    pass
            self._arr = np.frombuffer(self._mm, np.uint8)
        self._off = 0
        self._chunk = chunk_bytes
        self._pool = pool
        self._prefetch = prefetch
        self._reserve = reserve if prefetch else 0
        self._flip = 0
        # producer may hold `depth` queued results + 1 in flight while the
        # consumer still reads its current view: rotate depth+2 buffers
        self._nbufs = depth + 2
        self._sticky_err: BaseException | None = None
        self._finished = False
        self._t = None
        if prefetch:
            self._q = _queue.Queue(maxsize=depth)
            self._stop = False
            self._t = _threading.Thread(target=self._producer, daemon=True)
            self._t.start()

    def _producer(self) -> None:
        while not self._stop:
            try:
                got = self._inflate_next()
            except BaseException as e:  # surfaced on the consumer's pull
                self._q.put(("err", e))
                return
            self._q.put(("ok", got))
            if got is None:
                return

    def close(self, release_buffers: bool | None = None) -> None:
        """Close the stream. release_buffers=True also returns this
        inflater's pooled rotation buffers (depth+2 chunk-sized maps for
        the prefetch path) to the OS — several hundred MB of RSS a
        long-lived process may not want pinned. The default keeps them
        pooled for warm reuse (on hosts whose page-fault path is slow and
        erratic, re-faulting them per run costs far more than the
        resident pages); NGSTPU_RELEASE_BUFFERS=1 flips the default."""
        if self._t is not None:
            self._stop = True
            try:  # unblock a producer stuck in put()
                while True:
                    self._q.get_nowait()
            except Exception:
                pass
            self._t.join(timeout=30)
            self._t = None
        self._arr = np.zeros(0, np.uint8)
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass  # a live view keeps the map alive; GC reclaims it
            self._mm = None
        self._f.close()
        if release_buffers is None:
            release_buffers = bool(os.environ.get("NGSTPU_RELEASE_BUFFERS"))
        if release_buffers:
            from ..utils.bufpool import release

            if self._prefetch:
                for k in range(self._nbufs):
                    release(f"{self._pool}.{k}")
            else:
                release(self._pool)
            release(self._pool + ".carry")

    def _inflate_next(self, reserve: int | None = None):
        """Scan+inflate one batch of whole blocks (straight off the mmap)
        into a pooled buffer at offset `reserve` (default: the configured
        prefetch reserve). Returns (out, total) or None at EOF; raises
        ValueError on corrupt/truncated streams."""
        from ..utils.bufpool import get_buffer

        lib = get_lib()
        if reserve is None:
            reserve = self._reserve
        while True:
            if self._off >= self._size:
                return None
            starts, lens, isizes, next_off = _scan_blocks_from(
                self._mm, self._off, self._chunk, self._size)
            self._off = next_off
            if len(starts) == 0:
                continue
            total = int(isizes.sum())
            name = (f"{self._pool}.{self._flip}" if self._prefetch
                    else self._pool)
            self._flip = (self._flip + 1) % self._nbufs
            out = get_buffer(name, reserve + total)
            out_offsets = np.empty(len(starts), np.int64)
            out_offsets[0] = reserve
            np.cumsum(isizes[:-1], out=out_offsets[1:])
            out_offsets[1:] += reserve
            out_sizes = np.empty(len(starts), np.int64)
            rc = _inflate_scanned(lib, self._arr, starts, lens, isizes, out,
                                  out_offsets, out_sizes)
            if rc != 0 or not (out_sizes == isizes).all():
                raise ValueError("corrupt BGZF block payload")
            return out, total

    def next_chunk(self, carry) -> np.ndarray | None:
        """Inflate the next compressed chunk; returns a uint8 view of
        carry ++ inflated bytes (valid until the rotation reuses the same
        pooled buffer — with prefetch the previous `depth+1` views stay
        intact), or None at EOF (with `carry` empty-checked by
        the caller). Raises ValueError on a truncated trailing block."""
        carry = bytes(carry)  # copy the small tail out of the live buffer
        if not self._prefetch:
            nc = len(carry)
            got = self._inflate_next(reserve=nc)
            if got is None:
                return None
            out, total = got
            if nc:
                out[:nc] = np.frombuffer(carry, np.uint8)
            return out[:nc + total]
        if self._sticky_err is not None:
            raise self._sticky_err
        if self._finished:
            return None
        kind, got = self._q.get()
        if kind == "err":
            self._sticky_err = got  # re-raises on every later pull
            raise got
        if got is None:
            self._finished = True
            return None
        out, total = got
        nc = len(carry)
        if nc <= self._reserve:
            if nc:
                out[self._reserve - nc:self._reserve] = np.frombuffer(
                    carry, np.uint8)
            return out[self._reserve - nc:self._reserve + total]
        return self._with_carry(out, total, carry)

    def _with_carry(self, out: np.ndarray, total: int, carry: bytes
                    ) -> np.ndarray:
        """Oversized-carry fallback: one extra copy into a side buffer."""
        from ..utils.bufpool import get_buffer

        nc = len(carry)
        big = get_buffer(self._pool + ".carry", nc + total)
        big[:nc] = np.frombuffer(carry, np.uint8)
        big[nc:nc + total] = out[self._reserve:self._reserve + total]
        return big[:nc + total]


def decompress_bgzf(data: bytes) -> bytes:
    """Whole-buffer BGZF -> plain bytes (parallel when native lib present)."""
    lib = get_lib()
    if lib is None:
        return gzip.decompress(data)
    starts, lens, isizes = _scan_blocks(data)
    total = int(isizes.sum())
    out = np.empty(total, dtype=np.uint8)
    out_offsets = np.zeros(len(starts), dtype=np.int64)
    if len(starts):
        np.cumsum(isizes[:-1], out=out_offsets[1:])
    out_sizes = np.empty(len(starts), dtype=np.int64)
    arr = np.frombuffer(data, dtype=np.uint8)
    rc = _inflate_scanned(lib, arr, starts, lens, isizes, out, out_offsets,
                          out_sizes)
    if rc != 0 or not (out_sizes == isizes).all():
        return gzip.decompress(data)  # fallback on any mismatch
    return out.tobytes()


def read_bgzf(path: str) -> bytes:
    with open(path, "rb") as f:
        return decompress_bgzf(f.read())


def decompress_block_range(data: bytes, starts: np.ndarray, lens: np.ndarray,
                           isizes: np.ndarray, lo: int, hi: int) -> bytes:
    """Inflate only blocks [lo, hi) of a scanned BGZF buffer (the
    BAI-driven partial decode: non-overlapping blocks are never touched)."""
    if lo >= hi:
        return b""
    starts, lens, isizes = starts[lo:hi], lens[lo:hi], isizes[lo:hi]
    lib = get_lib()
    if lib is not None:
        total = int(isizes.sum())
        out = np.empty(total, dtype=np.uint8)
        out_offsets = np.zeros(len(starts), dtype=np.int64)
        if len(starts):
            np.cumsum(isizes[:-1], out=out_offsets[1:])
        out_sizes = np.empty(len(starts), dtype=np.int64)
        arr = np.frombuffer(data, dtype=np.uint8)
        rc = _inflate_scanned(lib, arr, np.ascontiguousarray(starts),
                              np.ascontiguousarray(lens),
                              np.ascontiguousarray(isizes), out, out_offsets,
                              out_sizes)
        if rc == 0 and (out_sizes == isizes).all():
            return out.tobytes()
    chunks = []
    for s, ln in zip(starts.tolist(), lens.tolist()):
        chunks.append(gzip.decompress(data[s:s + ln]))
    return b"".join(chunks)


def compress_bgzf(data: bytes, level: int = 6,
                  block_size: int = 0xFF00) -> bytes:
    """Plain bytes -> BGZF blocks + EOF marker (parallel deflate)."""
    lib = get_lib()
    n = len(data)
    n_blocks = (n + block_size - 1) // block_size if n else 0
    chunks = []
    if lib is not None and n_blocks:
        starts = np.arange(n_blocks, dtype=np.int64) * block_size
        lens = np.minimum(block_size, n - starts)
        caps = lens + 1024
        offs = np.zeros(n_blocks, dtype=np.int64)
        np.cumsum(caps[:-1], out=offs[1:])
        payload = np.empty(int(caps.sum()), dtype=np.uint8)
        sizes = np.empty(n_blocks, dtype=np.int64)
        arr = np.frombuffer(data, dtype=np.uint8)
        rc = lib.ngs_gzip_compress_blocks(arr, starts, lens, n_blocks, payload,
                                          caps, offs, sizes, level, 0)
        if rc == 0:
            for i in range(n_blocks):
                raw = payload[offs[i]: offs[i] + sizes[i]].tobytes()
                chunks.append(_wrap_bgzf(raw, int(lens[i]),
                                         data[starts[i]:starts[i] + int(lens[i])],
                                         level))
            chunks.append(BGZF_EOF)
            return b"".join(chunks)
    # pure-python path
    for i in range(n_blocks):
        block = data[i * block_size:(i + 1) * block_size]
        chunks.append(_deflate_block(block, level))
    chunks.append(BGZF_EOF)
    return b"".join(chunks)


def _deflate_block(block: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(block) + co.flush()
    return _assemble(comp, block)


def _wrap_bgzf(member: bytes, ulen: int, block: bytes, level: int) -> bytes:
    """Re-wrap a full gzip member produced by the native path into BGZF
    (strip its plain header/trailer, add the BSIZE header)."""
    # native emitted a standard gzip member; extract the raw deflate part
    flg = member[3]
    o = 10
    if flg & 4:
        xlen = struct.unpack_from("<H", member, o)[0]
        o += 2 + xlen
    if flg & 8:
        o = member.index(b"\x00", o) + 1
    if flg & 16:
        o = member.index(b"\x00", o) + 1
    raw = member[o:-8]
    return _assemble(raw, block)


def _assemble(raw_deflate: bytes, block: bytes) -> bytes:
    bsize = len(raw_deflate) + 25 + 1
    if bsize - 1 > 0xFFFF:
        raise ValueError("BGZF block too large")
    hdr = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
           + struct.pack("<H", 6)
           + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize - 1))
    trail = struct.pack("<I", zlib.crc32(block) & 0xFFFFFFFF) + \
        struct.pack("<I", len(block) & 0xFFFFFFFF)
    return hdr + raw_deflate + trail
