"""Offset-indexed FASTQ fast path: mmap + index, zero materialization.

The generic reader (io/fastq.py) copies every record into padded matrices;
on hosts with a slow page-fault path the first-touch faults for those
intermediates can
cost more than all real work combined. This path instead mmaps the input
(plain files) and builds six per-record offset/length arrays in one native
scan; every downstream stage (QC histograms, quality sums, 2-bit sort-key
packing, trim/uniq text assembly) then runs as offset gathers straight out
of the page cache via the fused native kernels (ngsio.cpp ngs_fastq_index /
ngs_fastq_fused / ngs_trim_format_ofs / ngs_format_uniq_ofs).

Replaces the reference's per-tool re-read loops (fastq_trim.c:67-89,
gzfastq_uniq.c:170-192, fastq_count.c:106-133) with ONE pass over the bytes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import mmap
import os

import numpy as np

from .native import get_lib


@dataclasses.dataclass
class IndexedFastq:
    """Raw FASTQ bytes + per-record line offsets (no copies of the data)."""

    data: np.ndarray          # uint8, mmap-backed for plain files
    name_off: np.ndarray      # int64 [B] offset of '@' line start
    name_len: np.ndarray      # int32 [B]
    seq_off: np.ndarray       # int64 [B]
    seq_len: np.ndarray       # int32 [B]
    qual_off: np.ndarray      # int64 [B]
    qual_len: np.ndarray      # int32 [B]

    @property
    def n(self) -> int:
        return len(self.seq_len)


def _sniff(path: str | None) -> str | None:
    """'plain' | 'gz' | None (stdin/empty/unreadable)."""
    if not path or path == "-":
        return None
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
        if os.path.getsize(path) == 0:
            return None
        return "gz" if magic == b"\x1f\x8b" else "plain"
    except OSError:
        return None


def _is_plain_file(path: str | None) -> bool:
    return _sniff(path) == "plain"


def _inflate_gz(path: str, pool: str) -> np.ndarray | None:
    """Whole-file gzip inflate into a pooled buffer (libdeflate walk over
    all members, zlib fallback — ngsio.cpp ngs_gzip_decompress_blocks with
    one block). Sizes the buffer from the trailing ISIZE word and grows on
    a short fit (multi-member files under-report). Returns the inflated
    uint8 view, or None when inflation fails (caller's generic gzip path
    then surfaces the proper error). The role of the reference's gzdopen
    transparency (IO_stream.h:122-136) for the offset-indexed fast path."""
    from ..utils.bufpool import get_buffer

    lib = get_lib()
    n = os.path.getsize(path)
    if n < 18:
        return None
    # size gate BEFORE reading anything: the whole-file inflate holds the
    # entire inflated stream in one pooled buffer, which is the right
    # trade only up to a point — a 10M+-read .gz would pin GBs of
    # anonymous memory where the chunked generic reader streams in
    # O(chunk). Estimate from the compressed size (FASTQ gzips ~3-4x;
    # use 4x) and route oversized inputs to the generic path by
    # returning None. NGSTPU_GZ_INFLATE_MAX (bytes, estimated inflated)
    # overrides the default 2 GB bound.
    est_max = int(os.environ.get("NGSTPU_GZ_INFLATE_MAX", 2 << 30))
    if 4 * n > est_max:
        return None
    # mmap the compressed bytes: the decoders read the page cache
    # directly — np.fromfile would copy every compressed byte first
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    raw = np.frombuffer(mm, np.uint8)

    out = _inflate_gz_members_parallel(lib, raw, pool)
    if out is not None:
        return out

    # ISIZE comes from the (untrusted) trailer: a truncated/corrupt file
    # reads 4 arbitrary bytes here, so clamp to DEFLATE's maximum
    # compression ratio (~1032:1) before sizing any allocation
    isize = int(raw[-4:].view(np.uint32)[0])
    cap = max(min(isize, 1032 * n), 4 * n, 1 << 20)
    starts = np.zeros(1, np.int64)
    lens_ = np.array([n], np.int64)
    offs = np.zeros(1, np.int64)
    sizes = np.zeros(1, np.int64)
    # the native call cannot distinguish short-buffer from corrupt data, so
    # retries are bounded: 4 doublings covers compression ratios to ~64x
    # (FASTQ is typically 3-4x); corrupt inputs fail fast each attempt and
    # then take the generic gzip path, which raises the precise error
    prev_produced = -1
    for _ in range(4):
        out = get_buffer(pool + ".gzdata", cap)
        caps = np.array([cap], np.int64)
        rc = lib.ngs_gzip_decompress_blocks(raw, starts, lens_, 1, out,
                                            offs, caps, sizes, 0)
        if rc == 0:
            return out[:int(sizes[0])]
        # a short buffer produces MORE with a bigger one; a failure at
        # the same produced size below cap is corrupt/odd-layout data —
        # doubling again only re-pays the inflate (and a growing buffer)
        produced = int(sizes[0])
        if produced == prev_produced and produced < cap:
            return None
        prev_produced = produced
        cap *= 2
    return None


def _inflate_gz_members_parallel(lib, raw: np.ndarray,
                                 pool: str) -> np.ndarray | None:
    """Member-parallel inflate of a MULTI-member gzip file (pigz, BGZF,
    our ParallelGzipWriter — the standard parallel-gzip layouts): find
    candidate member boundaries by magic scan (1f 8b 08 with zero
    reserved FLG bits), take each member's inflated size from the ISIZE
    trailer right before the next boundary, and decode every member
    concurrently straight into place (ngs_bgzf_inflate_blocks — raw
    DEFLATE, per-member). Entirely speculative and self-validating: a
    false boundary (the 3-byte magic inside compressed data) makes some
    member's decode fail or its produced size mismatch, and the caller
    falls back to the sequential whole-file walk with identical output.
    Returns None when the layout doesn't hold (single member, implausible
    trailer sizes, or any decode mismatch). Halves the gz fast-path
    inflate wall on a 2-core host (the reference decodes serially
    through zlib's gzgets either way, IO_stream.h:122-136)."""
    from ..utils.bufpool import get_buffer

    n = len(raw)
    if n < 40:
        return None
    # candidate scan: parallel memchr for 0x1f, then the cheap per-hit
    # magic/FLG checks on the (few) hits only. Compressed data holds one
    # 0x1F byte per ~256, so the hit buffer must scale with the file —
    # a fixed 1MB cap silently rejected every input over ~250MB
    # (round-5 regression, caught by the config-2 bench)
    cap = (n >> 7) + (1 << 20)
    c0 = (get_buffer(pool + ".gzmagic", 8 * cap, np.int64)
          if cap > (1 << 22) else np.empty(cap, np.int64))
    total = lib.ngs_find_byte(raw, n - 17, 0x1F, c0, cap, 0)
    if total > cap:
        return None  # implausibly magic-dense; sequential path
    c0 = c0[:total]
    m = (raw[c0 + 1] == 0x8B) & (raw[c0 + 2] == 8) \
        & ((raw[c0 + 3] & 0xE0) == 0)
    starts = c0[m]
    if len(starts) < 2 or starts[0] != 0:
        return None
    starts = starts.astype(np.int64)
    # probe-decode each candidate's first bytes: a FALSE boundary (the
    # 3-byte magic inside compressed data) is followed by garbage that
    # zlib rejects as a DEFLATE stream almost immediately, while a true
    # member decodes cleanly (a short valid prefix just stops without
    # error). The ISIZE plausibility pass below cannot do this job alone:
    # a mid-stream "trailer" is 4 random bytes, and random passes the
    # <=1032x ratio test roughly half the time (measured: 2 of 3 false
    # boundaries in a 113MB fixture survived it, poisoning the layout and
    # costing a failed 1.3GB speculative decode before the slow fallback).
    # Gated to few-member layouts (pigz / our ParallelGzipWriter): on a
    # member-dense BGZF-style file the serial Python probe would cost
    # more than the decode it protects, and the decode-driven repair
    # loop below recovers any surviving false boundary either way.
    if len(starts) <= 512:
        import zlib

        keep = np.ones(len(starts), bool)
        for i in range(1, len(starts)):
            s = int(starts[i])
            try:
                zlib.decompressobj(wbits=31).decompress(
                    raw[s:s + 4096].tobytes())
            except zlib.error:
                keep[i] = False
        starts = starts[keep]
        if len(starts) < 2:
            return None
    # a FALSE boundary (the 3-byte magic inside compressed data) splits a
    # real member in two, and the first piece's "ISIZE" reads mid-stream
    # garbage — prune such candidates and re-derive instead of rejecting
    # the whole layout (one false hit per ~100MB is routine). Pruning a
    # real boundary is impossible to confuse for long: the decode below
    # is fully self-validating (exact produced-size match + CRC).
    for _ in range(8):
        ends = np.append(starts[1:], n)
        lens = ends - starts
        if (lens < 28).any():  # header(10) + trailer(8) + some payload
            bad = np.flatnonzero(lens < 28)
            if bad[-1] == len(starts) - 1 or len(starts) < 3:
                return None
            starts = np.delete(starts, bad + 1)
            continue
        isizes = np.ascontiguousarray(
            raw[(ends[:, None] + np.arange(-4, 0)[None, :]).reshape(-1)]
        ).view(np.uint32).astype(np.int64)
        # plausibility: DEFLATE can't exceed ~1032x; zero-size members
        # are legal (empty writer flushes) but a giant claimed total is
        # not — an implausible size marks the NEXT candidate as false
        bad = np.flatnonzero(isizes > 1032 * lens)
        if len(bad) == 0:
            break
        if bad[-1] == len(starts) - 1 or len(starts) < 3:
            return None  # the file's own trailer is implausible
        starts = np.delete(starts, bad + 1)
    else:
        return None
    if len(starts) < 2:
        return None
    # general .gz user inputs verify CRC32 by DEFAULT (advisor r4 medium:
    # the prior libdeflate-gzip/zlib paths always did, and a corrupted
    # stream that still inflates to the right length must not pass
    # silently). NGSTPU_GZ_CRC=0 opts out for trusted pipelines; this is
    # distinct from NGSTPU_BGZF_CRC, which gates BAM/BGZF blocks whose
    # framing was already host-scanned and whose payloads are further
    # structure-validated downstream (io/bgzf.py).
    verify = os.environ.get("NGSTPU_GZ_CRC", "1") != "0"
    # Decode with repair: a false boundary that slipped past both filters
    # (garbage can parse as a DEFLATE stored-block prefix, so the probe
    # is not airtight) truncates the member it splits and corrupts the
    # "member" it starts — the failures land as a CONSECUTIVE RUN in
    # out_sizes (the native attempts every member independently). Merging
    # each failed run back into one member removes exactly the false
    # boundaries; anything unrepairable that way (isolated failure = real
    # corruption, run against the file end) bails to the sequential
    # whole-file walk, which raises the precise error.
    for _attempt in range(3):
        ends = np.append(starts[1:], n)
        lens = ends - starts
        isizes = np.ascontiguousarray(
            raw[(ends[:, None] + np.arange(-4, 0)[None, :]).reshape(-1)]
        ).view(np.uint32).astype(np.int64)
        total = int(isizes.sum())
        if total > 1032 * n or total <= 0:
            return None
        offs = np.zeros(len(starts), np.int64)
        np.cumsum(isizes[:-1], out=offs[1:])
        out = get_buffer(pool + ".gzdata", total)
        sizes = np.empty(len(starts), np.int64)
        rc = lib.ngs_bgzf_inflate_blocks(
            raw, starts, np.ascontiguousarray(lens), len(starts), out,
            offs, np.ascontiguousarray(isizes), sizes,
            1 if verify else 0, 0)
        if rc == 0 and (sizes == isizes).all():
            return out[:total]
        bad = np.flatnonzero(sizes != isizes)
        if len(bad) == 0:
            return None  # CRC failure with matching sizes: corrupt data
        # boundaries interior to each maximal failed run are the false ones
        run_start = bad[np.r_[True, np.diff(bad) != 1]]
        run_end = bad[np.r_[np.diff(bad) != 1, True]]
        drop = np.concatenate([np.arange(a + 1, b + 1)
                               for a, b in zip(run_start, run_end)])
        if len(drop) == 0 or len(starts) - len(drop) < 2:
            return None
        starts = np.delete(starts, drop)
    return None  # speculative split still wrong: sequential fallback


def _load_data(path: str | None, pool: str | None) -> np.ndarray | None:
    """Raw record bytes for the offset-index machinery: plain files mmap,
    gzip files inflate into a pooled buffer (transparent gzdopen of
    reference IO_stream.h:122-136). None when the fast path cannot apply."""
    kind = _sniff(path)
    if get_lib() is None or kind is None:
        return None
    if kind == "gz":
        data = _inflate_gz(path, pool if pool is not None else "gzix")
        if data is None or len(data) == 0:
            return None
    else:
        f = open(path, "rb")
        try:
            mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
        except ValueError:
            f.close()
            return None
        finally:
            f.close()
        if hasattr(mm, "madvise"):
            try:
                mm.madvise(mmap.MADV_WILLNEED)
            except (OSError, AttributeError):
                pass
        data = np.frombuffer(mm, dtype=np.uint8)
    if data[-1] != 0x0A:  # no trailing newline: generic path tolerates it
        return None
    return data


def index_fastq(path: str | None,
                pool: str | None = None) -> IndexedFastq | None:
    """Index a FASTQ file: plain files via mmap, gzip files via a whole-
    file libdeflate inflate into a pooled buffer (both then share the
    offset-index machinery). Returns None when the fast path does not
    apply (stdin, empty file, no native lib, a failed inflate, or a
    missing trailing newline) — callers fall back to the generic reader.

    `pool`: optional bufpool name prefix for the six offset arrays —
    repeated same-process runs (benchmarks, the serve daemon) then reuse
    the pages instead of re-faulting ~60MB per run. Views of the same pool
    name alias, so only one IndexedFastq per pool name may be live.

    Raises ValueError on a line count that is not a multiple of 4 (same
    contract as the generic parser).
    """
    lib = get_lib()
    data = _load_data(path, pool)
    if data is None:
        return None
    t = lib.ngs_hw_threads()
    state = np.zeros(4 + 14 * max(t, 64), dtype=np.int64)
    n_lines = lib.ngs_fastq_scan(data, len(data), state, t)
    if n_lines % 4:
        raise ValueError(
            f"FASTQ file has {n_lines} lines (not a multiple of 4)")
    b = n_lines // 4
    if pool is not None:
        from ..utils.bufpool import get_buffer

        name_off = get_buffer(pool + ".name_off", 8 * b, np.int64)
        name_len = get_buffer(pool + ".name_len", 4 * b, np.int32)
        seq_off = get_buffer(pool + ".seq_off", 8 * b, np.int64)
        seq_len = get_buffer(pool + ".seq_len", 4 * b, np.int32)
        qual_off = get_buffer(pool + ".qual_off", 8 * b, np.int64)
        qual_len = get_buffer(pool + ".qual_len", 4 * b, np.int32)
    else:
        name_off = np.empty(b, np.int64)
        name_len = np.empty(b, np.int32)
        seq_off = np.empty(b, np.int64)
        seq_len = np.empty(b, np.int32)
        qual_off = np.empty(b, np.int64)
        qual_len = np.empty(b, np.int32)
    if b:
        lib.ngs_fastq_index(data, len(data), state, name_off, name_len,
                            seq_off, seq_len, qual_off, qual_len, t)
    return IndexedFastq(data, name_off, name_len, seq_off, seq_len,
                        qual_off, qual_len)


def index_fastq_fused(path: str | None, pool: str, want_hist: bool = True):
    """Index + fused QC/pack in ONE sweep over the bytes
    (ngs_fastq_index_fused): the record offsets AND the QC histograms,
    quality sums, 2-bit sort keys and bucket histogram come out of the
    same record-aligned walk — one full pass less than index_fastq +
    fused_stats. Returns
    (IndexedFastq, words u32 [B, W], sumq u32 [B], hist_q u64 [512, 128],
     hist_len u64 [512], bucket u32 [256], all_acgt: bool)
    or None when the fast path does not apply. Buffers come from the
    bufpool under `pool`.`name` (aliased across calls with the same pool).

    want_hist=False skips the per-cycle quality histogram (the hottest
    increment stream of the pass: reads x read_len table updates) for
    callers that only dedup/sort — hist_q comes back None.
    """
    from ..utils.bufpool import get_buffer, get_matrix

    lib = get_lib()
    data = _load_data(path, pool + ".ix")
    if data is None:
        return None
    t = lib.ngs_hw_threads()
    state = np.zeros(4 + 14 * max(t, 64), dtype=np.int64)
    n_lines = lib.ngs_fastq_scan(data, len(data), state, t)
    if n_lines % 4:
        raise ValueError(
            f"FASTQ file has {n_lines} lines (not a multiple of 4)")
    b = n_lines // 4
    if b == 0:
        return None
    lmax = int(state[2])
    W = max(1, -(-lmax // 16))
    name_off = get_buffer(pool + ".ix.name_off", 8 * b, np.int64)[:b]
    name_len = get_buffer(pool + ".ix.name_len", 4 * b, np.int32)[:b]
    seq_off = get_buffer(pool + ".ix.seq_off", 8 * b, np.int64)[:b]
    seq_len = get_buffer(pool + ".ix.seq_len", 4 * b, np.int32)[:b]
    qual_off = get_buffer(pool + ".ix.qual_off", 8 * b, np.int64)[:b]
    qual_len = get_buffer(pool + ".ix.qual_len", 4 * b, np.int32)[:b]
    words_all = get_matrix(pool + ".words", b, W, np.uint32)
    sumq = get_buffer(pool + ".sumq", 4 * b, np.uint32)[:b]
    hist_q = np.zeros((512, 128), np.uint64) if want_hist else None
    hist_len = np.zeros(512, np.uint64)
    bucket = np.zeros(256, np.uint32)
    hq_ptr = (hist_q.ctypes.data_as(ctypes.c_void_p) if hist_q is not None
              else None)
    bad = lib.ngs_fastq_index_fused(
        data, len(data), state, name_off, name_len, seq_off, seq_len,
        qual_off, qual_len, W, words_all, sumq, hq_ptr,
        hist_len, 128, 512, bucket, 0)
    ix = IndexedFastq(data, name_off, name_len, seq_off, seq_len,
                      qual_off, qual_len)
    return ix, words_all, sumq, hist_q, hist_len, bucket, bad == 0


def fused_stats(ix: IndexedFastq, lo: int, hi: int, words: int,
                words_out: np.ndarray, sumq_out: np.ndarray,
                hist_q: np.ndarray, hist_len: np.ndarray,
                bucket_hist: np.ndarray) -> bool:
    """Run the fused QC+pack pass over records [lo, hi).

    words_out: uint32 [hi-lo, words]; sumq_out: uint32 [hi-lo];
    hist_q: uint64 [512, 128] (accumulated); hist_len: uint64 [512]
    (accumulated); bucket_hist: uint32 [256] (accumulated).
    Returns True when all sequence bytes were ACGT (the 2-bit packing in
    words_out is then valid).
    """
    lib = get_lib()
    b = hi - lo
    if b == 0:
        return True
    bad = lib.ngs_fastq_fused(
        ix.data, ix.seq_off[lo:hi], ix.seq_len[lo:hi],
        ix.qual_off[lo:hi], ix.qual_len[lo:hi], b, words,
        words_out, sumq_out, hist_q.reshape(-1), hist_len,
        hist_q.shape[1], hist_q.shape[0], bucket_hist, 0)
    return bad == 0


def fused_pair_stats(ix1: IndexedFastq, ix2: IndexedFastq, lo: int, hi: int,
                     words: int, words_out: np.ndarray, sumq_out: np.ndarray,
                     bucket_hist: np.ndarray) -> bool:
    """Fused PE pass over pairs [lo, hi): pack seq1||seq2 into one 2-bit
    key stream (the sds key of reference gzfastq_uniq.c:212-213), sum both
    mates' quality bytes, histogram the leading packed byte. Returns True
    when all sequence bytes (both mates) were ACGT."""
    lib = get_lib()
    b = hi - lo
    if b == 0:
        return True
    bad = lib.ngs_fastq_fused_pair(
        ix1.data, ix1.seq_off[lo:hi], ix1.seq_len[lo:hi],
        ix1.qual_off[lo:hi], ix1.qual_len[lo:hi],
        ix2.data, ix2.seq_off[lo:hi], ix2.seq_len[lo:hi],
        ix2.qual_off[lo:hi], ix2.qual_len[lo:hi],
        b, words, words_out, sumq_out, bucket_hist, 0)
    return bad == 0


def trim_text(ix: IndexedFastq, lo: int, hi: int, start: int, end: int,
              out: np.ndarray) -> int:
    """Assemble trimmed FASTQ text for records [lo, hi) into `out`
    (caller-sized via trim_text_size). Returns total bytes."""
    lib = get_lib()
    b = hi - lo
    if b == 0:
        return 0
    cl = np.clip(np.minimum(ix.seq_len[lo:hi].astype(np.int64), end) - start,
                 0, None)
    rec = ix.name_len[lo:hi].astype(np.int64) + 1 + cl + 3 + cl + 1
    out_starts = np.zeros(b, np.int64)
    np.cumsum(rec[:-1], out=out_starts[1:])
    total = int(out_starts[-1] + rec[-1])
    lib.ngs_trim_format_ofs(
        ix.data, ix.name_off[lo:hi], ix.name_len[lo:hi],
        ix.seq_off[lo:hi], ix.seq_len[lo:hi],
        ix.qual_off[lo:hi], ix.qual_len[lo:hi],
        b, start, end, out_starts,
        out.ctypes.data_as(ctypes.c_void_p), 0)
    return total


def trim_text_size(ix: IndexedFastq, start: int, end: int) -> int:
    cl = np.clip(np.minimum(ix.seq_len.astype(np.int64), end) - start,
                 0, None)
    return int((ix.name_len.astype(np.int64) + 1 + cl + 3 + cl + 1).sum())


def uniq_text(ix: IndexedFastq, rep: np.ndarray, counts: np.ndarray,
              bufname: str, sep: int = 0x09) -> tuple[np.ndarray, int]:
    """Assemble numeric-suffixed FASTQ text for rows `rep` into the named
    pooled buffer: name{sep}{counts[k]} records — '\\t' (default) for the
    dedup "name\\tcount" headers, '_' for gzfastq_sample's ordinal
    renames. Returns (buffer view, total bytes)."""
    from ..utils.bufpool import get_buffer

    lib = get_lib()
    k = len(rep)
    if k == 0:
        return get_buffer(bufname, 1), 0
    rep = np.ascontiguousarray(rep, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    out_starts = get_buffer(bufname + ".starts", 8 * k, np.int64)[:k]
    total = int(lib.ngs_uniq_sizes(
        np.ascontiguousarray(ix.name_len, np.int32),
        np.ascontiguousarray(ix.seq_len, np.int32),
        rep, counts.ctypes.data_as(ctypes.c_void_p), k, out_starts))
    out = get_buffer(bufname, total)
    lib.ngs_format_uniq_ofs(
        ix.data, ix.name_off, ix.name_len, ix.seq_off, ix.seq_len,
        ix.qual_off, ix.qual_len, rep,
        counts.ctypes.data_as(ctypes.c_void_p), k, out_starts,
        out.ctypes.data_as(ctypes.c_void_p), sep, 0)
    return out, total


def take_text(ix: IndexedFastq, order: np.ndarray, bufname: str
              ) -> tuple[np.ndarray, int]:
    """Assemble plain FASTQ text for records in `order` (a permutation
    slice) into the named pooled buffer — the emit half of the
    gzfastq_sort offset fast path (records gathered straight from the
    raw bytes, no padded matrices). Returns (buffer view, total bytes)."""
    from ..utils.bufpool import get_buffer

    lib = get_lib()
    k = len(order)
    if k == 0:
        return get_buffer(bufname, 1), 0
    order = np.ascontiguousarray(order, np.int64)
    out_starts = get_buffer(bufname + ".starts", 8 * k, np.int64)[:k]
    null = ctypes.c_void_p(0)
    total = int(lib.ngs_uniq_sizes(
        np.ascontiguousarray(ix.name_len, np.int32),
        np.ascontiguousarray(ix.seq_len, np.int32),
        order, null, k, out_starts))
    out = get_buffer(bufname, total)
    lib.ngs_format_uniq_ofs(
        ix.data, ix.name_off, ix.name_len, ix.seq_off, ix.seq_len,
        ix.qual_off, ix.qual_len, order, null, k, out_starts,
        out.ctypes.data_as(ctypes.c_void_p), 0x09, 0)
    return out, total
