"""BAI index writer — samtools-compatible .bai generation.

The reference tools hard-require a .bai built by external samtools
(bam_index_load, reference bam2depth.c:112-119). The streaming decode
does not need one, but producing indexes makes our BAM outputs (and any
BAM) consumable by index-based readers. Virtual file offsets are
reconstructed by mapping each record's decompressed offset back onto the
BGZF block table ((block_file_offset << 16) | intra_block_offset).

Format (SAM spec §5.2): magic "BAI\\1", n_ref; per ref: binning index
(bin -> chunks of virtual offsets) over the UCSC 37449-bin scheme and a
16kb-window linear index of minimum virtual offsets.
"""

from __future__ import annotations

import struct

import numpy as np

from .bam import BamColumns, BamHeader
from ..ops.bamops import ref_span


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _voffsets(block_file_off: np.ndarray, block_usize: np.ndarray,
              u_offsets: np.ndarray) -> np.ndarray:
    """Map decompressed offsets -> BGZF virtual offsets (u64)."""
    u_starts = np.zeros(len(block_usize), dtype=np.int64)
    np.cumsum(block_usize[:-1], out=u_starts[1:])
    blk = np.searchsorted(u_starts, u_offsets, side="right") - 1
    intra = u_offsets - u_starts[blk]
    return (block_file_off[blk].astype(np.uint64) << np.uint64(16)) | \
        intra.astype(np.uint64)


def reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """reg2bin over int64 arrays (the same ladder, first match wins)."""
    e = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, ((1 << 15) - 1) // 7), (17, ((1 << 12) - 1) // 7),
                        (20, ((1 << 9) - 1) // 7), (23, ((1 << 6) - 1) // 7),
                        (26, ((1 << 3) - 1) // 7)):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _bin_table(bins: np.ndarray, vs: np.ndarray,
               ve: np.ndarray) -> tuple[int, bytes]:
    """One reference's binning index from its records in file order: bins
    ascending, each bin's chunks in file order, a record merged into its
    bin's last chunk when that chunk ends where the record starts. Every
    field is a little-endian u64 word: (bin | n_chunk << 32), then
    (v_start, v_end) per chunk. Returns (n_bin, the table's bytes)."""
    if (bins < 0).any():  # as struct.pack("<I") refuses a negative bin
        raise struct.error("argument out of range")
    order = np.argsort(bins, kind="stable")
    b, vs, ve = bins[order], vs[order], ve[order]
    new_bin = np.ones(len(b), bool)
    new_bin[1:] = b[1:] != b[:-1]
    new_chunk = new_bin.copy()
    new_chunk[1:] |= ve[:-1] != vs[1:]
    c_lo = np.flatnonzero(new_chunk)
    c_hi = np.append(c_lo[1:], len(b)) - 1
    c_bin = np.cumsum(new_bin)[c_lo] - 1  # bin ordinal of each chunk
    n_chunk = np.bincount(c_bin)
    # word offset of each bin header: one word per earlier bin, two per
    # earlier chunk
    first_chunk = np.concatenate([[0], np.cumsum(n_chunk)[:-1]])
    hdr_at = np.arange(len(n_chunk)) + 2 * first_chunk
    words = np.empty(len(n_chunk) + 2 * len(c_lo), np.uint64)
    words[hdr_at] = (b[new_bin].astype(np.uint64)
                     | (n_chunk.astype(np.uint64) << np.uint64(32)))
    at = hdr_at[c_bin] + 1 + 2 * (np.arange(len(c_lo)) - first_chunk[c_bin])
    words[at] = vs[c_lo]
    words[at + 1] = ve[c_hi]
    return len(n_chunk), words.astype("<u8").tobytes()


def _linear_index(beg: np.ndarray, end: np.ndarray,
                  vs: np.ndarray) -> np.ndarray:
    """One reference's 16 kb linear index: each window covered by a record
    holds the least v_start of those records, and an uncovered window the
    value of the window before it (0 before the first). A v_start is never
    0 (the header precedes every record), so 0 can mark "unset"; window
    numbers below 0 index from the end, as numpy's indexing does."""
    n_intv = int(end.max() - 1) // 16384 + 1
    w0 = beg >> 14
    nw = ((end - 1) >> 14) - w0 + 1
    rec = np.repeat(np.arange(len(beg)), nw)
    w = w0[rec] + (np.arange(len(rec)) - np.repeat(np.cumsum(nw) - nw, nw))
    if w.min() < -n_intv or w.max() >= n_intv:
        raise IndexError("linear index window out of range")
    w[w < 0] += n_intv
    lin = np.full(n_intv, np.iinfo(np.uint64).max, np.uint64)
    np.minimum.at(lin, w, vs[rec])
    lin[lin == np.iinfo(np.uint64).max] = 0
    # fill zero gaps with the previous value (samtools convention)
    last = np.maximum.accumulate(np.where(lin != 0, np.arange(n_intv), -1))
    return np.where(last >= 0, lin[np.maximum(last, 0)], np.uint64(0))


def build_bai(header: BamHeader, cols: BamColumns, body_u_offset: int,
              block_file_off: np.ndarray, block_usize: np.ndarray,
              total_csize: int, total_usize: int) -> bytes:
    """Build .bai bytes for a BAM whose records are `cols` (coordinate
    sorted), where body_u_offset is the decompressed offset of the
    alignment section. Vectorized per reference; the bytes are those of
    the per-record loop it replaces (held against the JAX package's
    build_bai in tests)."""
    u_start = cols.rec_offset.astype(np.int64) + body_u_offset
    u_end = u_start + cols.rec_len.astype(np.int64)
    v_start = _voffsets(block_file_off, block_usize, u_start)
    v_end = _voffsets(block_file_off, block_usize, u_end)

    spans = ref_span(cols)
    beg = cols.pos.astype(np.int64)
    end = beg + np.maximum(spans, 1)
    bins = reg2bin_vec(beg, end)
    # records grouped by tid, file order within a tid
    order = np.argsort(cols.tid, kind="stable")
    bounds = np.searchsorted(cols.tid[order], np.arange(header.n_refs + 1))

    out = [b"BAI\x01", struct.pack("<i", header.n_refs)]
    for tid in range(header.n_refs):
        sel = order[bounds[tid]:bounds[tid + 1]]
        if len(sel) == 0:
            out.append(struct.pack("<i", 0))  # n_bin
            out.append(struct.pack("<i", 0))  # n_intv
            continue
        n_bin, table = _bin_table(bins[sel], v_start[sel], v_end[sel])
        out.append(struct.pack("<i", n_bin))
        out.append(table)
        lin = _linear_index(beg[sel], end[sel], v_start[sel])
        out.append(struct.pack("<i", len(lin)))
        out.append(lin.astype("<u8").tobytes())
    return b"".join(out)


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end) (SAM spec §5.3 reg2bins)."""
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def read_bai(path: str) -> list[tuple[dict[int, list[tuple[int, int]]],
                                      np.ndarray]]:
    """Parse a .bai: per-reference (bins -> chunk list, linear index).
    The inverse of build_bai; also reads samtools-produced indexes
    (trailing n_no_coor and metadata pseudo-bin 37450 are tolerated)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"BAI\x01":
        raise ValueError("not a BAI index")
    try:
        (n_ref,) = struct.unpack_from("<i", data, 4)
        if n_ref < 0:
            raise ValueError("corrupt BAI: negative n_ref")
        o = 8
        refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, o)
            o += 4
            if n_bin < 0 or o + 12 * n_bin > len(data):
                raise ValueError("corrupt BAI: bin table exceeds file")
            bins: dict[int, list[tuple[int, int]]] = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, o)
                o += 8
                if n_chunk < 0 or o + 16 * n_chunk > len(data):
                    raise ValueError("corrupt BAI: chunk list exceeds file")
                chunks = []
                for _ in range(n_chunk):
                    vs, ve = struct.unpack_from("<QQ", data, o)
                    o += 16
                    chunks.append((vs, ve))
                if b != 37450:  # metadata pseudo-bin
                    bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", data, o)
            o += 4
            if n_intv < 0 or o + 8 * n_intv > len(data):
                raise ValueError("corrupt BAI: linear index exceeds file")
            lin = np.frombuffer(data, dtype="<u8", count=n_intv, offset=o)
            o += 8 * n_intv
            refs.append((bins, lin.astype(np.uint64)))
        return refs
    except struct.error as e:  # truncated/garbage index
        raise ValueError(f"corrupt BAI index: {e}") from e


def region_voffsets(bai_refs, tid: int, beg: int, end: int
                    ) -> tuple[int, int] | None:
    """Virtual-offset window [v_lo, v_hi) covering every record that can
    overlap region [beg, end) on reference `tid` — the chunk union over
    reg2bins, floor-filtered by the linear index (the bam_fetch block-skip
    strategy of samtools' index machinery). None if the index proves the
    region empty."""
    if tid < 0 or tid >= len(bai_refs):
        return None
    bins, lin = bai_refs[tid]
    min_off = int(lin[min(beg >> 14, len(lin) - 1)]) if len(lin) else 0
    v_lo, v_hi = None, None
    for b in reg2bins(beg, end):
        for vs, ve in bins.get(b, ()):
            if ve <= min_off:
                continue
            vs = max(vs, min_off)
            v_lo = vs if v_lo is None else min(v_lo, vs)
            v_hi = ve if v_hi is None else max(v_hi, ve)
    if v_lo is None:
        return None
    return v_lo, v_hi


def write_bai(bam_path: str, bai_path: str | None = None) -> str:
    """Index a BAM file; returns the .bai path."""
    from .bgzf import _scan_blocks, decompress_bgzf
    from .bam import parse_header, scan_records

    with open(bam_path, "rb") as f:
        raw = f.read()
    starts, lens, isizes = _scan_blocks(raw)
    data = decompress_bgzf(raw)
    header, body_off = parse_header(data)
    body = np.frombuffer(data, dtype=np.uint8, offset=body_off)
    cols = scan_records(body)
    bai = build_bai(header, cols, body_off, starts, isizes,
                    len(raw), len(data))
    path = bai_path or bam_path + ".bai"
    with open(path, "wb") as f:
        f.write(bai)
    return path
