"""ctypes loader for the native host-I/O library (ngsio.cpp).

Compiles on first use with g++ -O3 -march=native into
ngstpu_torch/native/build/libngsio_torch.so. The file name is the port's
own, so a process that also loads the JAX package's libngsio never maps
one file for two loaders.

Every entry point has a pure-numpy fallback, so the framework degrades
gracefully on machines without a toolchain (NGSTPU_NO_NATIVE=1 forces the
fallback for testing).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
import time

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_BUILD_DIR = _NATIVE_DIR / "build"
_SRC = _NATIVE_DIR / "ngsio.cpp"
_SO = _BUILD_DIR / "libngsio_torch.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
# wall seconds of this process's g++ build (0.0 while none ran)
BUILD_SECONDS = 0.0

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_int = ctypes.c_int
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _build() -> bool:
    global BUILD_SECONDS
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a per-pid temp path, then atomic-rename: concurrent builds
    # never observe a half-written .so
    tmp = _BUILD_DIR / f".libngsio_torch.{os.getpid()}.so"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", str(tmp), str(_SRC), "-lz", "-lpthread", "-ldl"]
    try:
        t0 = time.monotonic()
        r = subprocess.run(cmd, capture_output=True, timeout=180)
        if r.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, _SO)
        BUILD_SECONDS = time.monotonic() - t0
        return True
    except (OSError, subprocess.TimeoutExpired):
        try:
            tmp.unlink(missing_ok=True)
        except OSError:
            pass
        return False


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("NGSTPU_NO_NATIVE"):
            return None
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None
        lib.ngs_version.restype = _int
        lib.ngs_hw_threads.restype = _int
        lib.ngs_fastq_scan.restype = _i64
        lib.ngs_fastq_scan.argtypes = [_p_u8, _i64, _p_i64, _int]
        lib.ngs_fastq_fill.argtypes = [
            _p_u8, _i64, _p_i64, _i64, _int, _int, _int,
            ctypes.c_void_p, ctypes.c_void_p, _p_i32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, _int]
        lib.ngs_count_newlines.restype = _i64
        lib.ngs_count_newlines.argtypes = [_p_u8, _i64, _int]
        lib.ngs_find_byte.restype = _i64
        lib.ngs_find_byte.argtypes = [_p_u8, _i64, _int, _p_i64, _i64, _int]
        lib.ngs_find_newlines.restype = _i64
        lib.ngs_find_newlines.argtypes = [_p_u8, _i64, _p_i64, _int]
        lib.ngs_fill_padded.argtypes = [_p_u8, _p_i64, _p_i32, _i64, _i64,
                                        _p_u8, _int]
        lib.ngs_concat_ragged.argtypes = [_p_u8, _p_i64, _p_i32, _p_i64, _i64,
                                          _p_u8, _int]
        lib.ngs_scatter_rows.argtypes = [_p_u8, _p_i32, _i64, _i64, _p_i64,
                                         _p_u8, _int]
        lib.ngs_concat_pairs.argtypes = [_p_u8, _p_i32, _i64, _p_u8, _p_i32,
                                         _i64, _i64, _i64, _p_u8, _int]
        lib.ngs_format_fastq.argtypes = [
            _p_u8, _p_i64, _p_i32,              # names
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # suffixes
            _p_u8, _p_u8, _p_i32, ctypes.c_void_p,  # seq, qual, lens, qual_lens
            _i64, _i64, _p_i64, _p_u8, _int]
        lib.ngs_format_fastq_take.argtypes = [
            _p_u8, _p_i64, _p_i32, _p_i64, ctypes.c_void_p,   # names, idx_n, counts
            _p_u8, _i64, _p_i32, _p_i64,                      # seq
            _p_u8, _i64, _p_i32, _p_i64,                      # qual
            _i64, _p_i64, _p_u8, _int]
        lib.ngs_tile_ids.restype = _i64
        lib.ngs_tile_ids.argtypes = [_p_u8, _p_i64, _p_i32, _p_i64, _i64,
                                     _p_i64]
        lib.ngs_fastq_index.argtypes = [
            _p_u8, _i64, _p_i64,
            _p_i64, _p_i32, _p_i64, _p_i32, _p_i64, _p_i32, _int]
        lib.ngs_fastq_index_fused.restype = _int
        lib.ngs_fastq_index_fused.argtypes = [
            _p_u8, _i64, _p_i64,
            _p_i64, _p_i32, _p_i64, _p_i32, _p_i64, _p_i32,
            _i64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_void_p,  # hist_q u64* or NULL (skip quality histogram)
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            _i64, _i64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), _int]
        lib.ngs_fastq_fused.restype = _int
        lib.ngs_fastq_fused.argtypes = [
            _p_u8, _p_i64, _p_i32, _p_i64, _p_i32, _i64, _i64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            _i64, _i64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), _int]
        lib.ngs_trim_format_ofs.argtypes = [
            _p_u8, _p_i64, _p_i32, _p_i64, _p_i32, _p_i64, _p_i32,
            _i64, _i32, _i32, _p_i64, ctypes.c_void_p, _int]
        lib.ngs_format_uniq_ofs.argtypes = [
            _p_u8, _p_i64, _p_i32, _p_i64, _p_i32, _p_i64, _p_i32,
            _p_i64, ctypes.c_void_p, _i64, _p_i64, ctypes.c_void_p,
            _int, _int]
        lib.ngs_dedup_sort_host.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_void_p, _int, _i64, _i64, _p_i32, _p_u8, _int]
        lib.ngs_dedup_groups_host.restype = _i64
        lib.ngs_dedup_groups_host.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            _int, _i64, _i64, _p_i32, _p_i64, _p_i64, _int]
        lib.ngs_uniq_sizes.restype = _i64
        lib.ngs_uniq_sizes.argtypes = [_p_i32, _p_i32, _p_i64,
                                       ctypes.c_void_p, _i64, _p_i64]
        lib.ngs_dna3_pack_ofs.restype = _int
        lib.ngs_dna3_pack_ofs.argtypes = [
            _p_u8, _p_i64, _p_i32, _i64, _i64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), _int]
        lib.ngs_dedup_groups_range.restype = _i64
        lib.ngs_dedup_groups_range.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            _int, _i64, _p_i32, _i64, _i64, _p_i64, _p_i64]
        lib.ngs_msd_scatter_u32.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            _i64, _i64, _p_i32, _p_i64]
        lib.ngs_sort_perm_range.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            _i64, _p_i32, _i64, _i64]
        lib.ngs_pick_pair_join.argtypes = [
            _p_u8, _p_i64, _p_i32, _i64,
            _p_u8, _p_i64, _p_i32, _i64,
            _p_i32, _p_i32, _p_i32, _p_i32, _p_i64]
        lib.ngs_fastq_fused_pair.restype = _int
        lib.ngs_fastq_fused_pair.argtypes = [
            _p_u8, _p_i64, _p_i32, _p_i64, _p_i32,
            _p_u8, _p_i64, _p_i32, _p_i64, _p_i32,
            _i64, _i64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), _int]
        lib.ngs_gzip_compress_blocks.restype = _int
        lib.ngs_gzip_compress_blocks.argtypes = [
            _p_u8, _p_i64, _p_i64, _i64, _p_u8, _p_i64, _p_i64, _p_i64,
            _int, _int]
        lib.ngs_gzip_decompress_blocks.restype = _int
        lib.ngs_gzip_decompress_blocks.argtypes = [
            _p_u8, _p_i64, _p_i64, _i64, _p_u8, _p_i64, _p_i64, _p_i64, _int]
        lib.ngs_bgzf_inflate_blocks.restype = _int
        lib.ngs_bgzf_inflate_blocks.argtypes = [
            _p_u8, _p_i64, _p_i64, _i64, _p_u8, _p_i64, _p_i64, _p_i64,
            _int, _int]
        lib.ngs_mrle_encode_rows.restype = _i64
        lib.ngs_mrle_encode_rows.argtypes = [_p_u8, _p_i32, _i64, _i64,
                                             _p_u8, _p_i32]
        lib.ngs_dna3_pack.argtypes = [
            _p_u8, _i64, _i64, _i64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), _int]
        lib.ngs_dna2_pack.argtypes = [
            _p_u8, _i64, _i64, _i64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), _int]
        lib.ngs_byte_presence.argtypes = [_p_u8, _i64, _p_u8, _int]
        lib.ngs_qc_hist.argtypes = [
            _p_u8, _p_i32, _i64, _i64, _i64, _i64,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"), _int]
        lib.ngs_row_sums_u32.argtypes = [
            _p_u8, _i64, _i64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), _int]
        lib.ngs_bam_count.restype = _int
        lib.ngs_bam_count.argtypes = [_p_u8, _i64, ctypes.POINTER(_i64),
                                      ctypes.POINTER(_i64)]
        lib.ngs_bam_scan.argtypes = [
            _p_u8, _i64, _p_i64, _p_i32, _p_i32, _p_i32, _p_i32, _p_i32,
            _p_i32, _p_i32, _p_i64, _p_i32, _p_u8,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), _int]
        lib.ngs_bam_m_events.restype = _int
        lib.ngs_bam_m_events.argtypes = [
            _p_u8, _i64, _i32, _i32, _p_i32, _p_i32, _p_i32, _i64,
            ctypes.POINTER(_i64), ctypes.POINTER(_i64), _p_i32]
        lib.ngs_pileup_sweep.restype = _i64
        lib.ngs_pileup_sweep.argtypes = [_p_i32, _p_i32, _i64, _p_i64,
                                         _p_i64, _int]
        lib.ngs_pileup_sweep_se.restype = _i64
        lib.ngs_pileup_sweep_se.argtypes = [_p_i32, _p_i32, _i64, _p_i64,
                                            _p_i64, _int]
        lib.ngs_sort_perm_host.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            _p_i32, _i64, _i64, _int, _p_i32, _int]
        lib.ngs_pileup_emit_se.restype = _i64
        lib.ngs_pileup_emit_se.argtypes = [
            _p_i32, _p_i32, _i64, _p_u8, _i32, _i64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            _i64, _p_u8, _i64, _int]
        lib.ngs_bam_depth_scan.restype = _i64
        lib.ngs_bam_depth_scan.argtypes = [
            _p_u8, _i64,
            np.ctypeslib.ndpointer(np.uintp, flags="C_CONTIGUOUS"),
            _p_i64, _i32, _i32, _p_i64, _p_i64, _p_i32, _int]
        lib.ngs_depth_emit.restype = _i64
        lib.ngs_depth_emit.argtypes = [
            _p_i32, _i64, _p_u8, _i32, _i64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            _i64, _p_u8, _i64, _int]
        lib.ngs_depth_intervals.restype = _i64
        lib.ngs_depth_intervals.argtypes = [_p_i32, _i64, _p_i64, _p_i64,
                                            _p_i64, _i64, _int]
        lib.ngs_format_int3_rows.restype = _i64
        lib.ngs_format_int3_rows.argtypes = [_p_u8, _i32, _p_i64, _p_i64,
                                             _p_i64, _i64, _p_u8, _int]
        lib.ngs_format_int2_fixed2_rows.restype = _i64
        lib.ngs_format_int2_fixed2_rows.argtypes = [_p_u8, _i32, _p_i64,
                                                    _p_i64, _p_i64, _i64, _p_u8]
        _lib = lib
        return _lib


def have_native() -> bool:
    return get_lib() is not None


def format_fastq_take(names: np.ndarray, name_starts: np.ndarray,
                      name_lens: np.ndarray, idx_n: np.ndarray,
                      counts: np.ndarray | None,
                      seq: np.ndarray, slens: np.ndarray, idx_s: np.ndarray,
                      qual: np.ndarray, qlens: np.ndarray,
                      idx_q: np.ndarray) -> memoryview | bytes | None:
    """One-pass gather+format of FASTQ records selected by index arrays,
    with an optional "\\t{count}" name suffix. Returns the text, or None
    when the native library is unavailable (caller falls back).

    Record k: name[idx_n[k]] [\\t counts[k]] \\n seq[idx_s[k]][:slens[idx_s[k]]]
    \\n+\\n qual[idx_q[k]][:qlens[idx_q[k]]] \\n.
    """
    lib = get_lib()
    if lib is None:
        return None
    k = len(idx_n)
    if k == 0:
        return b""
    idx_n = np.ascontiguousarray(idx_n, np.int64)
    idx_s = np.ascontiguousarray(idx_s, np.int64)
    idx_q = np.ascontiguousarray(idx_q, np.int64)
    name_lens32 = np.ascontiguousarray(name_lens, np.int32)
    slens32 = np.ascontiguousarray(slens, np.int32)
    qlens32 = np.ascontiguousarray(qlens, np.int32)
    rec = (name_lens32[idx_n].astype(np.int64) + 1
           + slens32[idx_s].astype(np.int64) + 3
           + qlens32[idx_q].astype(np.int64) + 1)
    if counts is not None:
        counts = np.ascontiguousarray(counts, np.int64)
        # digits of each count (exact integer arithmetic), plus the '\t'
        digits = np.ones(k, np.int64)
        c = counts // 10
        while c.any():
            digits += c > 0
            c //= 10
        rec += 1 + digits
    out_starts = np.zeros(k, np.int64)
    np.cumsum(rec[:-1], out=out_starts[1:])
    out = np.empty(int(out_starts[-1] + rec[-1]), np.uint8)
    lib.ngs_format_fastq_take(
        np.ascontiguousarray(names), np.ascontiguousarray(name_starts, np.int64),
        name_lens32, idx_n,
        counts.ctypes.data_as(ctypes.c_void_p) if counts is not None
        else ctypes.c_void_p(0),
        np.ascontiguousarray(seq), seq.shape[1], slens32, idx_s,
        np.ascontiguousarray(qual), qual.shape[1], qlens32, idx_q,
        k, out_starts, out, 0)
    return out.data  # zero-copy buffer; file.write accepts memoryview


def tile_ids(names: np.ndarray, name_starts: np.ndarray,
             name_lens: np.ndarray, rows: np.ndarray) -> np.ndarray | None:
    """Illumina tile numbers of the names at `rows` (int64), in one native
    pass over the name blob (ngs_tile_ids): the name up to its first space
    or tab, split on ':'; field 5 of 7 or more fields, field 3 of 5 or 6,
    as a decimal. Returns None when the native library is unavailable or
    any of those rows has fewer than 5 fields or a tile field that is not
    1 to 18 ASCII digits (the caller falls back)."""
    lib = get_lib()
    if lib is None:
        return None
    names = np.ascontiguousarray(names, np.uint8)
    rows = np.ascontiguousarray(rows, np.int64)
    tiles = np.empty(len(rows), np.int64)
    if len(rows) and lib.ngs_tile_ids(
            names, np.ascontiguousarray(name_starts, np.int64),
            np.ascontiguousarray(name_lens, np.int32), rows, len(rows),
            tiles):
        return None
    return tiles


def parse_fastq_chunk(data: np.ndarray, pad_to: int,
                      need: frozenset) -> tuple | None:
    """Fused two-pass FASTQ chunk parse (ngs_fastq_scan/fill).

    Returns (seq, qual, seq_lens, names, name_starts, name_lens) with the
    same layout as the legacy path, or None when the native library is
    unavailable (caller falls back). Raises ValueError on a line count that
    is not a multiple of 4, matching the legacy parser.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    t = lib.ngs_hw_threads()
    state = np.zeros(4 + 14 * t, dtype=np.int64)
    n_lines = lib.ngs_fastq_scan(data, n, state, t) if n else 0
    if n_lines % 4:
        raise ValueError(
            f"FASTQ chunk has {n_lines} lines (not a multiple of 4)")
    b = n_lines // 4
    max_sq = int(state[2])
    name_total = int(state[3])
    lmax = max(-(-max(max_sq, 1) // pad_to) * pad_to, pad_to)
    need_seq = "seq" in need
    need_qual = "qual" in need
    need_names = "names" in need

    seq = np.empty((b, lmax), np.uint8) if need_seq else np.zeros((b, 0), np.uint8)
    qual = np.empty((b, lmax), np.uint8) if need_qual else np.zeros((b, 0), np.uint8)
    seq_lens = np.empty(b, np.int32)
    if need_names:
        names = np.empty(name_total, np.uint8)
        name_starts = np.empty(b, np.int64)
        name_lens = np.empty(b, np.int32)
    else:
        names = np.zeros(0, np.uint8)
        name_starts = np.zeros(b, np.int64)
        name_lens = np.zeros(b, np.int32)
    if b:
        def vp(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        lib.ngs_fastq_fill(
            data, n, state, lmax, need_seq, need_qual, need_names,
            vp(seq) if need_seq else ctypes.c_void_p(0),
            vp(qual) if need_qual else ctypes.c_void_p(0),
            seq_lens,
            vp(names) if need_names else ctypes.c_void_p(0),
            vp(name_starts) if need_names else ctypes.c_void_p(0),
            vp(name_lens) if need_names else ctypes.c_void_p(0),
            t)
    return seq, qual, seq_lens, names, name_starts, name_lens


def find_newlines(data: np.ndarray) -> np.ndarray:
    """Offsets of all newlines in a uint8 array (native or numpy)."""
    lib = get_lib()
    if lib is None:
        return np.flatnonzero(data == 0x0A).astype(np.int64)
    n = lib.ngs_count_newlines(data, len(data), 0)
    out = np.empty(n, dtype=np.int64)
    if n:
        lib.ngs_find_newlines(data, len(data), out, 0)
    return out


def fill_padded(data: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                lmax: int) -> np.ndarray:
    """Padded row gather (native memcpy path or numpy fallback)."""
    lib = get_lib()
    b = len(starts)
    if lib is None:
        from .ragged import gather_padded
        return gather_padded(data, starts, lens, lmax)
    out = np.empty((b, lmax), dtype=np.uint8)
    if b:
        lib.ngs_fill_padded(data, np.ascontiguousarray(starts, np.int64),
                            np.ascontiguousarray(lens, np.int32),
                            b, lmax, out, 0)
    return out


def format_int3_rows(prefix: bytes, a: np.ndarray, b: np.ndarray,
                     c: np.ndarray) -> bytes:
    """Rows "prefix\\tA\\tB\\tC\\n" (int columns), native itoa fast path."""
    n = len(a)
    if n == 0:
        return b""
    lib = get_lib()
    a64 = np.ascontiguousarray(a, np.int64)
    b64 = np.ascontiguousarray(b, np.int64)
    c64 = np.ascontiguousarray(c, np.int64)
    if lib is None:
        return b"".join(prefix + b"\t%d\t%d\t%d\n" % t
                        for t in zip(a64.tolist(), b64.tolist(), c64.tolist()))
    cap = n * (len(prefix) + 64)
    out = np.empty(cap, dtype=np.uint8)
    w = lib.ngs_format_int3_rows(np.frombuffer(prefix, np.uint8), len(prefix),
                                 a64, b64, c64, n, out, 0)
    return out[:w].tobytes()


def depth_emit_dense(delta: np.ndarray, ev_count: int, name: bytes,
                     window: int, n_windows: int, zero_after: bool = False
                     ) -> tuple[bytes, np.ndarray] | None:
    """Dense delta array -> (bedGraph rows bytes, float64 window bins).

    One native pass (ngs_depth_emit): prefix-sum the deltas, emit
    "name\\tstart\\tend\\tdepth\\n" for every maximal constant-depth run with
    depth > 0, and accumulate exact depth*bp overlap per window — the
    fused form of merged_intervals + format_int3_rows + depth_window_bins
    (reference bam2depth.c hash2BedGraph :203-236 / output_bins :238-246).
    zero_after=True restores delta to all-zero during the pass (recycled
    stream_depth_dense buffers then skip the bulk memset). Returns None
    when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    bins = np.zeros(n_windows, np.float64)
    if ev_count == 0:
        return b"", bins
    cap = (2 * ev_count + 2) * (len(name) + 70)
    text = np.empty(cap, np.uint8)
    w = lib.ngs_depth_emit(np.ascontiguousarray(delta, np.int32), len(delta),
                           np.frombuffer(name, np.uint8), len(name),
                           window, bins, n_windows, text, cap,
                           1 if zero_after else 0)
    if w < 0:  # cap bound above is a proof; this is defensive only
        raise ValueError("depth emit buffer overflow")
    return text[:w].tobytes(), bins


def depth_intervals_dense(delta: np.ndarray, ev_count: int,
                          zero_after: bool = False):
    """Dense delta array -> (starts, ends, depths) int64 columns of the
    maximal constant-depth runs with depth > 0 (ops/bamops.merged_intervals
    equivalent, from the dense pileup instead of sorted events). Returns
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.zeros(0, np.int64)
    if ev_count == 0:
        return z, z, z  # no events scattered -> array untouched (all-zero)
    cap = 2 * ev_count + 2
    starts = np.empty(cap, np.int64)
    ends = np.empty(cap, np.int64)
    depths = np.empty(cap, np.int64)
    k = lib.ngs_depth_intervals(np.ascontiguousarray(delta, np.int32),
                                len(delta), starts, ends, depths, cap,
                                1 if zero_after else 0)
    if k < 0:  # cap bound above is a proof; defensive only
        raise ValueError("depth intervals buffer overflow")
    return starts[:k], ends[:k], depths[:k]


def concat_pairs(a: np.ndarray, la: np.ndarray, b: np.ndarray,
                 lb: np.ndarray, lmax_out: int) -> np.ndarray:
    """Row-wise out[i] = a[i][:la[i]] ++ b[i][:lb[i]], zero-padded."""
    lib = get_lib()
    n = len(la)
    if lib is None:
        out = np.zeros((n, lmax_out), dtype=np.uint8)
        for i in range(n):  # fallback only
            l1, l2 = int(la[i]), int(lb[i])
            out[i, :l1] = a[i, :l1]
            out[i, l1:l1 + l2] = b[i, :l2]
        return out
    out = np.empty((n, lmax_out), dtype=np.uint8)
    if n:
        lib.ngs_concat_pairs(np.ascontiguousarray(a),
                             np.ascontiguousarray(la, np.int32), a.shape[1],
                             np.ascontiguousarray(b),
                             np.ascontiguousarray(lb, np.int32), b.shape[1],
                             n, lmax_out, out, 0)
    return out


def concat_ragged(data: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray) -> np.ndarray:
    lib = get_lib()
    lens64 = lens.astype(np.int64)
    out_starts = np.zeros(len(starts), dtype=np.int64)
    if len(starts):
        np.cumsum(lens64[:-1], out=out_starts[1:])
    total = int(lens64.sum())
    if lib is None:
        from .ragged import ragged_arange
        src = np.repeat(starts.astype(np.int64), lens64) + ragged_arange(lens64)
        return data[src]
    out = np.empty(total, dtype=np.uint8)
    if len(starts):
        lib.ngs_concat_ragged(data, np.ascontiguousarray(starts, np.int64),
                              np.ascontiguousarray(lens, np.int32),
                              out_starts, len(starts), out, 0)
    return out
