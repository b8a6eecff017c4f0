"""BAM container decode into columnar arrays (+ BAM writing).

Replaces the reference's vendored samtools-0.1.19 record path
(samopen/samread, sam.h:59-81; bam_fetch iteration) with a two-stage
host decode: BGZF blocks inflate in parallel (io.bgzf), then the native
scanner (ngsio.cpp ngs_bam_scan) emits structure-of-arrays — tid, pos,
flag, l_qseq, GC counts, flattened cigar — which feed the device pileup
ops directly. Raw per-record byte spans are retained so tools like
bamSplitChr can re-emit records verbatim.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from .bgzf import compress_bgzf, read_bgzf
from .native import get_lib

BAM_MAGIC = b"BAM\x01"

# flag bits (samtools bam.h)
FUNMAP = 0x4
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
DEF_MASK = FUNMAP | FSECONDARY | FQCFAIL | FDUP

CIGAR_OPS = "MIDNSHP=X"


@dataclasses.dataclass
class BamHeader:
    text: bytes
    ref_names: list[str]
    ref_lens: list[int]

    @property
    def n_refs(self) -> int:
        return len(self.ref_names)

    def encode(self) -> bytes:
        out = [BAM_MAGIC, struct.pack("<i", len(self.text)), self.text,
               struct.pack("<i", self.n_refs)]
        for name, ln in zip(self.ref_names, self.ref_lens):
            nb = name.encode() + b"\x00"
            out.append(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))
        return b"".join(out)


@dataclasses.dataclass
class BamColumns:
    """Columnar alignment data. All arrays have length n_records."""

    rec_offset: np.ndarray   # int64, offset into `body`
    rec_len: np.ndarray      # int32
    tid: np.ndarray          # int32
    pos: np.ndarray          # int32 (0-based leftmost)
    flag: np.ndarray         # int32
    mapq: np.ndarray         # int32
    l_qseq: np.ndarray       # int32
    gc: np.ndarray           # int32 (count of C/G 4-bit codes)
    cigar_offset: np.ndarray  # int64 into flat cigar arrays
    n_cigar: np.ndarray      # int32
    cigar_op: np.ndarray     # uint8  [total_ops]
    cigar_len: np.ndarray    # uint32 [total_ops]
    body: np.ndarray         # uint8: decompressed alignment section

    @property
    def n(self) -> int:
        return len(self.tid)


def parse_header(data: bytes) -> tuple[BamHeader, int]:
    """Parse the BAM header from decompressed bytes; returns (header, body_offset)."""
    if data[:4] != BAM_MAGIC:
        raise ValueError("not a BAM file")
    l_text = struct.unpack_from("<i", data, 4)[0]
    text = data[8:8 + l_text]
    o = 8 + l_text
    n_ref = struct.unpack_from("<i", data, o)[0]
    o += 4
    names, lens = [], []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, o)[0]
        names.append(data[o + 4:o + 4 + l_name - 1].decode())
        lens.append(struct.unpack_from("<i", data, o + 4 + l_name)[0])
        o += 8 + l_name
    return BamHeader(text=text, ref_names=names, ref_lens=lens), o


def _scan_python(body: np.ndarray, strict: bool = True) -> BamColumns:
    """Pure-python fallback scanner (validation mirrors ngs_bam_count)."""
    data = body.tobytes()
    n = len(data)
    offs, lens, tids, poss, flags, mapqs, lseqs, gcs = [], [], [], [], [], [], [], []
    cig_off, n_cig, ops_all, clens_all = [], [], [], []
    gc_nibble = np.zeros(16, dtype=np.int32)
    gc_nibble[2] = gc_nibble[4] = 1
    o = 0
    while o + 4 <= n:
        bs = struct.unpack_from("<I", data, o)[0]
        if o + 4 + bs > n:
            break
        if bs < 32:
            raise ValueError("malformed BAM record (block_size < 32)")
        r = o + 4
        tid, pos = struct.unpack_from("<ii", data, r)
        l_read_name = data[r + 8]
        mapq = data[r + 9]
        nc, flag = struct.unpack_from("<HH", data, r + 12)
        l_seq = struct.unpack_from("<i", data, r + 16)[0]
        if (l_read_name < 1 or l_seq < 0
                or 32 + l_read_name + 4 * nc + (l_seq + 1) // 2 + l_seq > bs):
            raise ValueError("malformed BAM record (field sizes exceed"
                             " block_size)")
        p = r + 32 + l_read_name
        cig_off.append(len(ops_all))
        n_cig.append(nc)
        for k in range(nc):
            cg = struct.unpack_from("<I", data, p + 4 * k)[0]
            ops_all.append(cg & 0xF)
            clens_all.append(cg >> 4)
        seq = np.frombuffer(data, np.uint8, (l_seq + 1) // 2, p + 4 * nc)
        g = int(gc_nibble[seq >> 4].sum() + gc_nibble[seq & 0xF].sum())
        if l_seq % 2:
            g -= int(gc_nibble[seq[-1] & 0xF]) if len(seq) else 0
        offs.append(o)
        lens.append(4 + bs)
        tids.append(tid)
        poss.append(pos)
        flags.append(flag)
        mapqs.append(mapq)
        lseqs.append(l_seq)
        gcs.append(g)
        o += 4 + bs
    if strict and o != n:
        raise ValueError("truncated BAM alignment section")
    return BamColumns(
        rec_offset=np.array(offs, np.int64), rec_len=np.array(lens, np.int32),
        tid=np.array(tids, np.int32), pos=np.array(poss, np.int32),
        flag=np.array(flags, np.int32), mapq=np.array(mapqs, np.int32),
        l_qseq=np.array(lseqs, np.int32), gc=np.array(gcs, np.int32),
        cigar_offset=np.array(cig_off, np.int64),
        n_cigar=np.array(n_cig, np.int32),
        cigar_op=np.array(ops_all, np.uint8),
        cigar_len=np.array(clens_all, np.uint32), body=body)


def scan_records(body: np.ndarray, strict: bool = True) -> BamColumns:
    """Columnar record scan of a decompressed alignment section.

    strict=True (whole-file reads) raises ValueError on a trailing partial
    record; strict=False (BAI-bounded block-range decodes, where the last
    block legitimately cuts a record) stops cleanly at it. A record whose
    claimed name/cigar/seq sizes exceed its block_size is malformed and
    raises in both modes — the scanners never read past validated bounds.
    """
    lib = get_lib()
    if lib is None:
        return _scan_python(body, strict=strict)
    import ctypes

    n_rec = ctypes.c_int64()
    n_cig = ctypes.c_int64()
    rc = lib.ngs_bam_count(body, len(body), ctypes.byref(n_rec),
                           ctypes.byref(n_cig))
    if rc == 2:
        raise ValueError("malformed BAM record (field sizes exceed"
                         " block_size)")
    if rc == 1 and strict:
        raise ValueError("truncated BAM alignment section")
    R, C = n_rec.value, n_cig.value
    cols = BamColumns(
        rec_offset=np.empty(R, np.int64), rec_len=np.empty(R, np.int32),
        tid=np.empty(R, np.int32), pos=np.empty(R, np.int32),
        flag=np.empty(R, np.int32), mapq=np.empty(R, np.int32),
        l_qseq=np.empty(R, np.int32), gc=np.empty(R, np.int32),
        cigar_offset=np.empty(R, np.int64), n_cigar=np.empty(R, np.int32),
        cigar_op=np.empty(C, np.uint8), cigar_len=np.empty(C, np.uint32),
        body=body)
    if R:
        lib.ngs_bam_scan(body, len(body), cols.rec_offset, cols.rec_len,
                         cols.tid, cols.pos, cols.flag, cols.mapq,
                         cols.l_qseq, cols.gc, cols.cigar_offset,
                         cols.n_cigar, cols.cigar_op, cols.cigar_len, 0)
    return cols


def read_bam(path: str) -> tuple[BamHeader, BamColumns]:
    data = read_bgzf(path)
    header, body_off = parse_header(data)
    body = np.frombuffer(data, dtype=np.uint8, offset=body_off)
    return header, scan_records(body)


class BamStream:
    """Chunked BAM decode with bounded RSS: BGZF batches inflate in
    parallel (io.bgzf.iter_inflated) and each batch scans to columnar
    arrays; a record cut by a batch edge carries into the next batch.
    Replaces the whole-file inflate for the streaming tools so a BAM
    larger than free RAM processes in O(chunk) memory — the role of
    samtools' samread loop (reference sam.h:59-81).

    Usage: s = BamStream(path); s.header; for cols in s: ...
    Each yielded BamColumns is self-contained (rec_offset indexes its own
    `body` slice).
    """

    def __init__(self, path: str, chunk_bytes: int = 32 << 20):
        from .bgzf import iter_inflated

        self._gen = iter_inflated(path, chunk_bytes)
        buf = b""
        while True:
            if len(buf) >= 4 and buf[:4] != BAM_MAGIC:
                raise ValueError("not a BAM file")
            try:
                self.header, body_off = parse_header(buf)
                break
            except (ValueError, IndexError, struct.error):
                nxt = next(self._gen, None)
                if nxt is None:
                    raise ValueError("truncated BAM header")
                buf += nxt
        self._carry = buf[body_off:]

    def __iter__(self):
        carry = self._carry
        self._carry = b""
        for data in self._gen:
            body_bytes = carry + data if carry else data
            body = np.frombuffer(body_bytes, dtype=np.uint8)
            cols = scan_records(body, strict=False)
            if cols.n:
                consumed = int(cols.rec_offset[-1] + cols.rec_len[-1])
                carry = body_bytes[consumed:]
                yield cols
            else:
                carry = body_bytes
        if carry:
            body = np.frombuffer(carry, dtype=np.uint8)
            yield scan_records(body, strict=True)


def _header_from_inflater(inf) -> tuple[BamHeader, bytes]:
    """Decode the BAM header prologue from a PooledInflater, closing it on
    any failure. Returns (header, initial record-byte carry)."""
    buf = b""
    try:
        while True:
            if len(buf) >= 4 and buf[:4] != BAM_MAGIC:
                raise ValueError("not a BAM file")
            try:
                header, body_off = parse_header(buf)
                return header, buf[body_off:]
            except (ValueError, IndexError, struct.error):
                nxt = inf.next_chunk(b"")
                if nxt is None:
                    raise ValueError("truncated BAM header")
                buf += nxt.tobytes()
    except BaseException:
        inf.close()
        raise


def read_bam_header(path: str) -> BamHeader:
    """Decode just the BAM header (a few BGZF blocks): gzip-stream the
    prefix until parse_header succeeds. Cheap enough to drive dispatch
    decisions before committing to a full-file decode strategy."""
    import gzip

    with gzip.open(path, "rb") as f:
        buf = b""
        while True:
            chunk = f.read(1 << 16)
            buf += chunk
            if len(buf) >= 4 and buf[:4] != BAM_MAGIC:
                raise ValueError("not a BAM file")
            try:
                header, _ = parse_header(buf)
                return header
            except (ValueError, IndexError, struct.error):
                if not chunk:
                    raise ValueError("truncated BAM header")


def choose_pileup_mode(path: str) -> str:
    """Pick the pileup engine for a whole-file depth/wig conversion.

    'dense'  — fused delta-scatter into per-reference arrays; O(genome)
               memory traffic, unbeatable at real WGS depth where events
               rival genome size (and on small genomes, where the arrays
               preallocate and fit cache-ish).
    'events' — stream_pileup_events + fused emit; O(events·log-ish)
               work, the winner whenever coverage is shallow relative to
               the genome (est. events ≪ genome positions) — WGS *and*
               small references. The reference's per-chromosome hash
               makes the same trade (bam2depth.c:86).
    'sparse' — the python/device legacy path (no native lib, or forced).

    Heuristic: events estimated from the compressed size (~50 compressed
    bytes per event on typical 100bp-read BAMs); the event path wins
    below ~1 event per 8 genome positions (the crossover the JAX
    package measured for these same native engines), the dense scatter
    above it.
    NGSTPU_PILEUP_MODE=dense|events|sparse overrides.
    """
    mode = os.environ.get("NGSTPU_PILEUP_MODE")
    if mode in ("events", "dense", "sparse"):
        return mode
    try:
        header = read_bam_header(path)
        genome = sum(header.ref_lens) + header.n_refs
        est_events = os.path.getsize(path) // 50
        return "events" if est_events < genome // 8 else "dense"
    except (OSError, ValueError):
        return "dense"  # let the real decode surface the precise error


class DensePileupUnsupported(ValueError):
    """Input contains alignments the dense pileup cannot represent
    (reference start below 0 — corrupt records); callers fall back to the
    sparse event path, which handles them like the reference's hash."""


def stream_depth_dense(path: str, flag_mask: int,
                       chunk_bytes: int = 32 << 20,
                       recycle: bool = False):
    """Fused dense pileup over a whole BAM (the bam2depth fast path).

    Decodes in O(chunk) BGZF batches (like BamStream) but instead of
    materializing columnar records + event arrays, each chunk scatters its
    CIGAR M-run deltas directly into dense per-reference int32 arrays in
    ONE native pass (ngs_bam_depth_scan) — no intermediate sort, the role
    of the reference's per-read depth accumulation (bam2depth.c:90-107)
    done chunk-parallel. Records failing `flag & flag_mask == 0` or with
    tid outside the header are skipped.

    Returns (header, generator of (delta_int32[>=ref_len+1], m_run_count)
    per reference in header order), or None when the native library is
    unavailable (callers fall back to stream_chrom_events). Like
    stream_chrom_events, coordinate-grouped inputs release each
    chromosome's array as soon as the stream moves past its tid (working
    set = largest touched chromosome); interleaved tids accumulate until
    EOF with identical outputs. NOTE (matches the sparse path): inputs
    must be coordinate-GROUPED for correct per-chromosome output — a
    record whose tid reappears after the stream already moved past it is
    dropped from the (already-emitted) chromosome on both paths.

    recycle=True returns each yielded delta array to an internal free
    list when the NEXT item is pulled — the working set becomes ~one
    chromosome-sized buffer instead of a fresh page-faulting allocation
    per chromosome (big WGS win on slow-fault VMs). CONTRACT: the
    consumer must (a) be done with an item before advancing and (b) have
    restored the array to all-zero by then — depth_emit_dense's
    zero_after=True does both in its single read pass, so no per-chrom
    memset is ever paid. Tests that collect arrays keep the default False.
    """
    from .native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    from .bgzf import PooledInflater

    inf = PooledInflater(path, chunk_bytes, pool="bamdense.chunk", prefetch=True)
    header, initial_carry = _header_from_inflater(inf)
    n_refs = header.n_refs
    ref_lens = header.ref_lens

    # sized so a chunk that bulk-enters a brand-new chromosome (every
    # chrom boundary on WGS input — up to ~chunk_records M-runs) still
    # completes on the single fast-scatter walk; the undo+handshake path
    # is then reserved for pathological files. 24MB of spill scratch.
    SPILL_CAP = 1 << 20

    def gen():
        arrays: list = [None] * n_refs
        ptrs = np.zeros(n_refs, np.uintp)
        cur_lens = np.zeros(n_refs, np.int64)
        needed = np.zeros(max(n_refs, 1 + 3 * SPILL_CAP), np.int64)
        ev_counts = np.zeros(n_refs, np.int64)
        # [monotone, last passing tid, mode (1 fast / 0 handshake / -1 undo)]
        state = np.array([1, -1, 0], np.int32)
        warned_unsorted = False
        emitted = 0
        empty = np.zeros(1, np.int32)
        free_list: list = []

        def grow(t, need):
            need = max(int(need), int(ref_lens[t]) + 1)
            # corrupt coordinates far past the declared reference end would
            # force an absurd allocation here — surface as unsupported so
            # the caller falls back to the sparse event path, which handles
            # them in O(events) memory
            if need > int(ref_lens[t]) + (4 << 20) + 1:
                raise DensePileupUnsupported(
                    "alignment ends implausibly far past the reference end")
            if arrays[t] is None:
                # recycled buffers come back all-zero already: the recycle
                # contract requires the consumer to restore zeros while it
                # reads (depth_emit_dense zero_after=True does it in the
                # same pass), so no 400MB memset per chromosome here
                for k, a in enumerate(free_list):
                    if len(a) >= need:
                        arrays[t] = free_list.pop(k)
                        break
                else:
                    arrays[t] = np.zeros(need, np.int32)
            elif len(arrays[t]) < need:
                grown = np.zeros(need, np.int32)
                grown[:len(arrays[t])] = arrays[t]
                arrays[t] = grown
            else:
                return
            ptrs[t] = arrays[t].ctypes.data
            cur_lens[t] = len(arrays[t])

        # small genomes: allocate every array upfront so no chunk ever
        # pays the undo+handshake re-walks; big (WGS) genomes stay lazy
        # for bounded RSS — the spill-scatter handles them with one
        # handshake per chromosome entered
        prealloc_max = int(os.environ.get("NGSTPU_DENSE_PREALLOC_MAX",
                                          64 << 20))  # elements (x4 bytes)
        if sum(ref_lens) + n_refs <= prealloc_max:
            for t in range(n_refs):
                grow(t, 0)

        def take(t):
            a = arrays[t]
            arrays[t] = None
            ptrs[t] = 0
            cur_lens[t] = 0
            needed[t] = 0
            return (a if a is not None else empty), int(ev_counts[t])

        # Producer-thread prefetch overlaps the next chunk's inflate with
        # this chunk's scatter (re-measured a win once the inflater went
        # mmap + raw-DEFLATE; the pre-mmap read()+inflate producer lost
        # to strict alternation on a 2-core host). PooledInflater
        # hands back carry ++ inflated-batch views over pooled buffers:
        # no whole-chunk copies, no cross-run page faults.
        carry = np.frombuffer(initial_carry, np.uint8)
        final = False
        while True:
            body = inf.next_chunk(carry)
            if body is None:
                # trailing records that fit entirely in the last chunk's
                # carry (including the whole-file-in-header-batch case)
                body = carry
                final = True
            if len(body) == 0 and final:
                carry = body
                break
            # every scan call re-walks this chunk's records from the top,
            # so the monotone/last-tid tracking must restart from the
            # pre-chunk snapshot on EVERY call — otherwise a handshake
            # retry sees the chunk's first tid "below" its own last tid
            # and falsely clears the monotone flag, which disables early
            # per-chromosome emission for the rest of the stream
            saved_mono, saved_tid = int(state[0]), int(state[1])

            def scan_chunk():
                state[0], state[1] = saved_mono, saved_tid
                return lib.ngs_bam_depth_scan(
                    body, len(body), ptrs, cur_lens, n_refs, flag_mask,
                    needed, ev_counts, state, 0)

            # on sorted input the next chunk can only enter the next one
            # or two tids: pre-grow them so chromosome-boundary chunks
            # scatter natively with zero spills (np.zeros is lazy — an
            # unused speculative array costs nothing and is recycled)
            if state[0]:
                for t in range(max(int(state[1]), 0),
                               min(int(state[1]) + 3, n_refs)):
                    if arrays[t] is None and emitted <= t:
                        grow(t, 0)
            # fast spill-scatter first, ALWAYS: chunks whose touched tids
            # are already allocated scatter in one walk; a chunk that
            # bulk-enters an unallocated tid (> SPILL_CAP runs) undoes
            # itself exactly and redoes via the allocation handshake —
            # only pathological files take it now
            state[2] = 1
            needed[0] = SPILL_CAP
            consumed = scan_chunk()
            if consumed == -3:
                state[2] = -1
                scan_chunk()  # exact undo of the applied in-range runs
                needed[:n_refs] = 0
                consumed = -2
            elif needed[0]:
                # out-of-range runs (chiefly: the bulk entry into a not-
                # yet-allocated chromosome), applied vectorized after
                # growing — np.add.at per touched tid, no Python per-run
                n_sp = int(needed[0])
                trips = needed[1:1 + 3 * n_sp].reshape(-1, 3)
                if (trips[:, 1] < 0).any():
                    raise DensePileupUnsupported(
                        "alignment start below position 0")
                for t in np.unique(trips[:, 0]):
                    sel = trips[trips[:, 0] == t]
                    s, ln = sel[:, 1], sel[:, 2]
                    grow(int(t), int((s + ln).max()) + 1)
                    np.add.at(arrays[int(t)], s, 1)
                    np.subtract.at(arrays[int(t)], s + ln, 1)
                needed[0] = 0
            state[2] = 0
            while consumed == -2:
                consumed = scan_chunk()
                if consumed == -4:
                    raise DensePileupUnsupported(
                        "alignment start below position 0")
                if consumed == -2:
                    # allocation handshake: grow what the chunk needs
                    for t in np.flatnonzero(needed[:n_refs]):
                        grow(int(t), needed[int(t)])
            carry = body[consumed:]
            if state[0]:  # monotone so far: tids below last_tid are final
                while emitted < state[1] and emitted < n_refs:
                    a, c = take(emitted)
                    emitted += 1
                    yield a, c
                    if recycle and a is not empty:
                        free_list.append(a)
            elif not warned_unsorted and sum(ref_lens) > prealloc_max:
                # interleaved tids on a WGS-sized genome: every touched
                # chromosome's array now stays resident until EOF (can
                # reach genome_size x 4 bytes). Outputs stay correct;
                # advise the cheap fix once.
                warned_unsorted = True
                import sys as _sys

                _sys.stderr.write(
                    "ngstpu: BAM is not coordinate-grouped; dense pileup "
                    "holds every touched chromosome in memory until EOF "
                    "- coordinate-sort the input to bound RSS\n")
            if final:
                break
        inf.close()
        if len(carry):
            # trailing bytes that never formed a complete record: reuse the
            # strict scan for the exact malformed-input diagnostics
            scan_records(np.ascontiguousarray(carry), strict=True)
            raise ValueError("truncated BAM record at end of file")
        while emitted < n_refs:
            a, c = take(emitted)
            emitted += 1
            yield a, c
            if recycle and a is not empty:
                free_list.append(a)

    return header, gen()


def stream_pileup_events(path: str, flag_mask: int,
                         chunk_bytes: int = 32 << 20,
                         pooled_flush: bool = False):
    """Event-mode pileup stream (the low-depth bam2depth/bam2wig fast
    path): yields (pos, delta) int32 event arrays per reference in header
    order — the stream_chrom_events contract — but decodes through the
    pooled zero-copy BGZF inflater and extracts CIGAR M-run events with
    one vectorized pass per chunk, skipping the columnar BamStream
    carry/concat copies. At WGS shapes with modest depth this does
    O(events) work where the dense scatter path pays O(genome) memory
    traffic (the trade the reference's per-chromosome hash makes too,
    bam2depth.c:86-110 — here the hash is a radix sweep).

    Returns (header, generator), or None when the native library is
    unavailable (callers fall back to stream_chrom_events, which has a
    pure-python decode path). Grouping semantics match the sparse/dense
    paths exactly: coordinate-grouped inputs release each chromosome as
    the stream moves past its tid; interleaved tids accumulate until EOF;
    a tid reappearing after emission is dropped like both other paths.
    """
    from .native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    from .bgzf import PooledInflater

    inf = PooledInflater(path, chunk_bytes, pool="bamev.chunk",
                         prefetch=True)
    header, initial_carry = _header_from_inflater(inf)
    n_refs = header.n_refs
    genome = sum(header.ref_lens)

    def gen():
        try:
            yield from _gen_events(inf, initial_carry, n_refs, flag_mask,
                                   lib, genome, pooled_flush)
        finally:
            # abandoned-generator / error path: release the fd and unpark
            # the prefetch producer thread
            inf.close()

    return header, gen()


def _gen_events(inf, initial_carry: bytes, n_refs: int, flag_mask: int,
                lib, genome: int = 0, pooled_flush: bool = False):
    import ctypes

    from ..utils.bufpool import get_buffer

    pending: dict[int, list] = {}
    pending_events = 0
    warned_unsorted = False
    warned_resident = False
    emitted = 0
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))

    flush_flip = [0]

    def flush(t):
        nonlocal pending_events
        pieces = pending.pop(t, None)
        if not pieces:
            return empty
        pending_events -= sum(len(s) for s, _ in pieces)
        # layout [all starts | all ends] (chunk order preserved): the
        # starts half of a coordinate-sorted input is ascending, which
        # merged_intervals_runs exploits to sort only the ends half.
        # pooled_flush=True rotates three pooled buffer pairs instead of
        # allocating fresh arrays per chromosome (a measured fault-noise
        # source on slow-fault hosts) — CONTRACT: a yielded (pos, delta) is then
        # valid only until the THIRD following flush; the CLI tools
        # consume each chromosome before pulling two more (even through
        # their 1-deep prefetch), while collect-everything callers keep
        # the default copy semantics.
        ns = sum(len(s) for s, _ in pieces)
        if pooled_flush and not os.environ.get("NGSTPU_DEBUG_POOLVIEWS"):
            # NGSTPU_DEBUG_POOLVIEWS forces owned arrays so a consumer
            # holding a flush past the 3-rotation window can be bisected
            # against the zero-copy mode
            name = f"bamev.flush{flush_flip[0]}"
            flush_flip[0] = (flush_flip[0] + 1) % 3
            pos = get_buffer(name + ".pos", 8 * ns, np.int32)
            delta = get_buffer(name + ".delta", 8 * ns, np.int32)
        else:
            pos = np.empty(2 * ns, np.int32)
            delta = np.empty(2 * ns, np.int32)
        o = 0
        for s, e in pieces:
            k = len(s)
            pos[o:o + k] = s
            pos[ns + o:ns + o + k] = e
            o += k
        delta[:ns] = 1
        delta[ns:] = -1
        return pos, delta

    mono_state = np.array([1, -1], np.int32)
    carry = np.frombuffer(initial_carry, np.uint8)
    final = False
    while True:
        body = inf.next_chunk(carry)
        if body is None:
            body = carry
            final = True
        if len(body) == 0 and final:
            break
        body = np.ascontiguousarray(body)
        # single-walk extraction: the event buffers are sized by a
        # fraction of the chunk (typical BAMs produce ~1 event per
        # ~100-200 record bytes, so /16 is ample headroom) instead of an
        # exact ngs_bam_count pre-walk — that pre-walk was a second full
        # pass over every record byte (~0.45 core-s on a WGS run). When a
        # dense-cigar chunk does overflow, rc==3 stops at a record
        # boundary; the events drain into `pending` and the walk resumes.
        # The floor far exceeds the 65535-op single-record maximum, so
        # forward progress is guaranteed. NGSTPU_EVENT_CAP overrides for
        # tests of the resume loop (must stay >= the max per-record op
        # count of the input or the walk cannot advance).
        cap = int(os.environ.get("NGSTPU_EVENT_CAP", 0)) \
            or max(1 << 20, len(body) // 16)
        off = 0
        n_ev = ctypes.c_int64()
        consumed_c = ctypes.c_int64()
        while True:
            tid_b = get_buffer("bamev.tid", 4 * cap, np.int32)
            st_b = get_buffer("bamev.start", 4 * cap, np.int32)
            en_b = get_buffer("bamev.end", 4 * cap, np.int32)
            sub = body[off:] if off else body
            rc = lib.ngs_bam_m_events(sub, len(sub), n_refs, flag_mask,
                                      tid_b, st_b, en_b, cap,
                                      ctypes.byref(n_ev),
                                      ctypes.byref(consumed_c), mono_state)
            if rc == 2 or (rc == 1 and final):
                # re-walk with the columnar scanner for its precise
                # malformed/truncated diagnostics (raises)
                scan_records(body, strict=final)
                raise ValueError("truncated BAM record at end of file")
            E = int(n_ev.value)
            consumed = off + int(consumed_c.value)
            if E:
                tids = tid_b[:E]
                ss, se = st_b[:E], en_b[:E]
                if not mono_state[0] and (np.diff(tids) < 0).any():
                    order = np.argsort(tids, kind="stable")
                    tids, ss, se = tids[order], ss[order], se[order]
                # segment bounds from the present tids only — a dense
                # range(tids[0], tids[-1]+1) walk would loop over every
                # absent intermediate contig on scaffold-heavy references
                ut, seg_lo = np.unique(tids, return_index=True)
                seg_hi = np.append(seg_lo[1:], E)
                for t, lo, hi in zip(ut.tolist(), seg_lo.tolist(),
                                     seg_hi.tolist()):
                    pending.setdefault(int(t), []).append(
                        (ss[lo:hi].copy(), se[lo:hi].copy()))
                pending_events += E
            # unsorted-input advisories (mirror of the dense path's):
            # interleaved tids on a big genome keep every touched
            # chromosome's events resident until EOF — outputs stay
            # correct, but the cheap fix is a coordinate sort
            if (not mono_state[0] and not warned_unsorted
                    and genome > (64 << 20)):
                warned_unsorted = True
                import sys as _sys

                _sys.stderr.write(
                    "ngstpu: BAM is not coordinate-grouped; event-mode "
                    "pileup holds every touched chromosome's events in "
                    "memory until EOF - coordinate-sort the input to "
                    "bound RSS\n")
            if not warned_resident and pending_events > int(os.environ.get(
                    "NGSTPU_EVENT_PENDING_CAP", 128 << 20)):
                warned_resident = True
                import sys as _sys

                _sys.stderr.write(
                    f"ngstpu: event-mode pileup is holding "
                    f"{pending_events} undischarged events "
                    f"(~{pending_events * 8 >> 20} MB); the input's tid "
                    f"grouping prevents streaming emission - "
                    f"coordinate-sort the input, or raise "
                    f"NGSTPU_EVENT_PENDING_CAP to silence this\n")
            if rc == 3:
                if consumed == off:
                    # cap below a single record's op count: the walk
                    # cannot advance — fail fast instead of spinning
                    # (a too-small NGSTPU_EVENT_CAP would spin here)
                    raise ValueError(
                        f"event capacity {cap} is below one record's "
                        f"cigar op count; raise NGSTPU_EVENT_CAP")
                off = consumed
                continue
            break
        if mono_state[0]:
            while emitted < mono_state[1] and emitted < n_refs:
                yield flush(emitted)
                emitted += 1
        if final:
            break
        carry = body[consumed:]
    while emitted < n_refs:
        yield flush(emitted)
        emitted += 1


def read_bam_region(path: str, ref_name_or_tid, beg: int, end: int
                    ) -> tuple[BamHeader, BamColumns] | None:
    """BAI-driven region decode: inflate ONLY the BGZF blocks whose virtual
    offsets can hold records overlapping [beg, end) on the given reference
    (samtools' bam_fetch block-skip, reference bam2depth.c:121-130, done
    block-parallel). Requires `path`.bai (ours or samtools'); returns None
    when no index is available (caller falls back to the full scan), and
    an empty column set when the index proves the region empty.

    Returned records are the superset held by the overlapping chunks —
    callers apply the precise region/flag mask exactly as with a full scan.
    """
    import mmap as _mmap
    import os

    from .bai import read_bai, region_voffsets
    from .bgzf import _scan_blocks_span, decompress_block_range

    bai_path = path + ".bai"
    if not os.path.exists(bai_path):
        return None
    f = open(path, "rb")
    try:
        raw = _mmap.mmap(f.fileno(), 0, prot=_mmap.PROT_READ)
    finally:
        f.close()

    # decode the header prefix (usually one block) by walking blocks
    # forward from offset 0 only as far as the header needs
    hdr_stop = 0
    while True:
        hs, hl, hi_ = _scan_blocks_span(raw, 0, hdr_stop)
        prefix = decompress_block_range(raw, hs, hl, hi_, 0, len(hs))
        try:
            header, body_off = parse_header(prefix)
            break
        except (struct.error, IndexError, ValueError):
            nxt = int(hs[-1] + hl[-1])
            if nxt + 18 > len(raw):
                raise
            hdr_stop = nxt

    tid = (header.ref_names.index(ref_name_or_tid)
           if isinstance(ref_name_or_tid, str) else int(ref_name_or_tid))
    window = region_voffsets(read_bai(bai_path), tid, beg, end)
    empty = BamColumns(
        rec_offset=np.zeros(0, np.int64), rec_len=np.zeros(0, np.int32),
        tid=np.zeros(0, np.int32), pos=np.zeros(0, np.int32),
        flag=np.zeros(0, np.int32), mapq=np.zeros(0, np.int32),
        l_qseq=np.zeros(0, np.int32), gc=np.zeros(0, np.int32),
        cigar_offset=np.zeros(0, np.int64), n_cigar=np.zeros(0, np.int32),
        cigar_op=np.zeros(0, np.uint8), cigar_len=np.zeros(0, np.uint32),
        body=np.zeros(0, np.uint8))
    if window is None:
        return header, empty
    v_lo, v_hi = window
    # the virtual offsets point straight at block starts: mmap + bounded
    # header walk over [v_lo>>16, v_hi>>16] touches O(result) compressed
    # bytes — never the rest of the file (bam_fetch seek behavior,
    # reference bam2depth.c:121-130)
    c_lo, c_hi = v_lo >> 16, v_hi >> 16
    if c_lo >= len(raw) or c_hi >= len(raw) + 1:
        raise ValueError("corrupt BAI: virtual offset beyond file end")
    if (v_hi & 0xFFFF) == 0 and c_hi > c_lo:
        c_hi -= 1  # chunk ends exactly at a block boundary
    starts, lens, isizes = _scan_blocks_span(raw, c_lo, c_hi)
    data = decompress_block_range(raw, starts, lens, isizes, 0, len(starts))
    intra = v_lo & 0xFFFF
    if intra > len(data):
        raise ValueError("corrupt BAI: virtual offset beyond block payload")
    body = np.frombuffer(data, dtype=np.uint8, offset=intra)
    # tolerate a record cut by the final block's edge (past the BAI chunk
    # end, so never one the caller's region mask would keep)
    return header, scan_records(body, strict=False)


def write_bam(path: str, header: BamHeader, record_bytes: bytes,
              level: int = 6) -> None:
    """Write header + raw record bytes as a BGZF BAM file."""
    with open(path, "wb") as f:
        f.write(compress_bgzf(header.encode() + record_bytes, level=level))
