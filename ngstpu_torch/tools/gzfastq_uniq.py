"""gzfastq_uniq: exact-sequence dedup (SE/PE) on the port's sort engine.

Mirrors ngstpu/tools/gzfastq_uniq.py: the same flags, outputs and record
order (reference gzfastq_uniq.c). SE writes outfile + "_uniq.fq" and
"_sortKeyUniq.fq", the same records in key order; PE writes "_1_uniq.fq"
and "_2_uniq.fq". The representative of a group is the first occurrence
with the highest quality-byte sum.

Fast route (plain or gzip files of pure ACGT, native lib): the input is
indexed in place, one fused native pass packs 2-bit keys and quality sums,
and the dedup sort runs as key-range partitions on the device (or on the
host when the link verdict is 'host'). Generic route (stdin, other bases,
NGSTPU_NO_FASTPATH): the whole batch is parsed, packed and deduplicated by
dedup_groups on `device`.

Usage: python -m ngstpu_torch.tools.cli [--device DEV] gzfastq_uniq
       -1 READ1 [-2 READ2] -o OUTFILE [-m MESH]
"""

from __future__ import annotations

import getopt
import os
import sys

import numpy as np
import torch

from ..io.fastq import format_fastq, read_fastq_file
from ..io.native import concat_pairs
from ..io.stream import open_output, with_suffix
from ..ops.hostsort import sum_quality_host
from ..ops.sortengine import dedup_rows
from ..utils.device import check_mesh, resolve_device
from ..utils.linkprobe import link_verdict, probe_link
from ..utils.timing import StageRusage, StageTimer
from .emitters import (CHUNK_RECORDS, _CloningSink, _fresh, _RecyclingSink,
                       _RingWriter, _sort_device_async, _sort_host_async)

OUT_CHUNK = 1 << 20


def _pad4(n: int) -> int:
    return max((n + 3) // 4 * 4, 4)


def _emit(out, batch, rep: np.ndarray, counts: np.ndarray,
          seq_override=None, lens_override=None) -> None:
    """Write the representative records `rep` with their group counts
    (the JAX package's gzfastq_uniq._emit): the fused native gather and
    format in chunks, or format_fastq without the native library."""
    from ..io.native import format_fastq_take, have_native

    if len(rep) and have_native():
        # chunked so a threaded writer overlaps formatting with the file
        # writes (utils/iopipe.TeeWriter)
        seq = np.ascontiguousarray(batch.seq if seq_override is None
                                   else seq_override)
        slens = batch.lens if lens_override is None else lens_override
        idx_s_full = (rep if seq_override is None
                      else np.arange(len(rep), dtype=np.int64))
        for lo in range(0, len(rep), OUT_CHUNK):
            sl = slice(lo, lo + OUT_CHUNK)
            text = format_fastq_take(batch.names, batch.name_starts,
                                     batch.name_lens, rep[sl], counts[sl],
                                     seq, slens, idx_s_full[sl],
                                     batch.qual, batch.lens, rep[sl])
            out.write(text)
        return
    for lo in range(0, len(rep), OUT_CHUNK):
        idx = rep[lo:lo + OUT_CHUNK]
        sub = batch.take(idx)
        hi = lo + OUT_CHUNK
        seq = sub.seq if seq_override is None else seq_override[lo:hi]
        lens = sub.lens if lens_override is None else lens_override[lo:hi]
        suffix = [b"\t%d" % c for c in counts[lo:lo + OUT_CHUNK]]
        out.write(format_fastq(sub.names, sub.name_starts, sub.name_lens,
                               seq, sub.qual, lens,
                               qual_lens=sub.lens, count_suffix=suffix))


def dedup_device(seq_padded: np.ndarray, lens: np.ndarray, sumq: np.ndarray,
                 device: torch.device, mesh_n: int = 0):
    """Run the dedup on `device`; returns host arrays (heads in key-sorted
    order): (rep_idx, counts, n_groups)."""
    if mesh_n > 1:
        check_mesh(mesh_n, device)
    g = dedup_rows(seq_padded, lens, sumq, len(lens), device)
    return g["rep"], g["counts"], g["n_groups"]


def _sort_groups(words, key_lens, sumq, bucket, const_len, W,
                 device: torch.device):
    """The placement-aware group generator of the fast routes: the native
    host sort on a 'host' verdict, device partitions otherwise. Returns
    (generator, verdict)."""
    verdict = link_verdict()
    if verdict is None:
        verdict = probe_link(words)
    if verdict == "host":
        return _sort_host_async(words, key_lens, sumq, const_len), verdict
    return (_sort_device_async(words, key_lens, sumq, bucket, const_len, W,
                               device), verdict)


def _run_se_fast(read1: str, outfile: str, timer: StageTimer,
                 device: torch.device) -> bool:
    """Offset-indexed SE dedup: mmap + one fused pack/sumq pass,
    placement-aware sort, text emitted straight from the raw bytes with the
    second output kernel-cloned. Returns False when the fast path does not
    apply."""
    from ..io.fastindex import index_fastq_fused, uniq_text

    if not outfile or outfile.startswith("-"):
        return False
    ru = StageRusage()
    fused = index_fastq_fused(read1, pool="pipe", want_hist=False)
    if fused is None:
        return False
    ix, words, sumq, _hist_q, _hist_len, bucket, ok = fused
    if not ok:
        return False  # non-ACGT: generic path handles wide alphabets
    B = ix.n
    lmax = int(ix.seq_len.max())
    W = words.shape[1]
    timer.log("Finished load hash at %.3f s\n")
    ru.checkpoint("index_pack")
    const_len = int(ix.seq_len.min()) == lmax
    gen, verdict = _sort_groups(words, ix.seq_len, sumq, bucket, const_len,
                                W, device)
    n_groups = 0
    first = True
    with open(_fresh(with_suffix(outfile, "_uniq.fq")), "wb",
              buffering=0) as f1, \
            open(_fresh(with_suffix(outfile, "_sortKeyUniq.fq")), "wb",
                 buffering=0) as f2:
        writer = _RingWriter(_CloningSink(f1, f2), ["pipe.emit0",
                                                    "pipe.emit1"])
        try:
            for rep, counts in gen:
                if first:
                    ru.checkpoint("sort_group")
                    first = False
                n_groups += len(rep)
                if len(rep) == 0:
                    continue
                name = writer.acquire()
                view, total = uniq_text(ix, rep, counts, name)
                writer.submit(name, view, total)
        finally:
            writer.close()
    ru.checkpoint("emit_write")
    ru.dump(tool="gzfastq_uniq", reads=B, groups=n_groups,
            placement=verdict)
    sys.stderr.write(
        f"unique reads number = {n_groups}({n_groups} / {B} = "
        f"{100.0 * n_groups / B:.3f}%)\n")
    return True


def run_se(read1: str, outfile: str, timer: StageTimer, device: torch.device,
           mesh_n: int = 0) -> None:
    if mesh_n <= 1 and not os.environ.get("NGSTPU_NO_FASTPATH") \
            and _run_se_fast(read1, outfile, timer, device):
        return
    batch = read_fastq_file(read1)
    sumq = sum_quality_host(batch.qual)
    rep, counts, n_groups = dedup_device(batch.seq, batch.lens, sumq, device,
                                         mesh_n)
    n = batch.n
    sys.stderr.write(
        f"unique reads number = {n_groups}({n_groups} / {n} = "
        f"{100.0 * n_groups / n:.3f}%)\n" if n else "")
    timer.log("Finished load hash at %.3f s\n")
    # both outputs carry identical records in identical (key-sorted) order:
    # format once, write both files concurrently
    out = open_output(with_suffix(outfile, "_uniq.fq"))
    out2 = open_output(with_suffix(outfile, "_sortKeyUniq.fq"))
    if out is sys.stdout.buffer or out2 is sys.stdout.buffer:
        # stdout: keep record order per stream — write sequentially
        chunks: list = []

        class _Sink:
            def write(self, data):
                chunks.append(data)

        _emit(_Sink(), batch, rep, counts)
        for o in (out, out2):
            for c in chunks:
                o.write(c)
            if o is sys.stdout.buffer:
                o.flush()
            else:
                o.close()
        return
    from ..utils.iopipe import TeeWriter

    tee = TeeWriter([out, out2])
    try:
        _emit(tee, batch, rep, counts)
    finally:
        tee.close()
        out.close()
        out2.close()


def _run_pe_fast(read1: str, read2: str, outfile: str, timer: StageTimer,
                 device: torch.device) -> bool:
    """Offset-indexed PE dedup: index both mates, ONE fused native pass
    packs seq1||seq2 into 2-bit sort keys plus the summed quality,
    placement-aware sort, then both _1_uniq/_2_uniq emitted straight from
    each mate's raw bytes. Returns False when the fast path does not
    apply."""
    from ..io.fastindex import fused_pair_stats, index_fastq, uniq_text
    from ..utils.bufpool import get_buffer, get_matrix

    if not outfile or outfile.startswith("-"):
        return False
    ix1 = index_fastq(read1, pool="uniq.ix1")
    if ix1 is None or ix1.n == 0:
        return False
    ix2 = index_fastq(read2, pool="uniq.ix2")
    if ix2 is None or ix2.n != ix1.n:
        return False  # mismatched pair counts: generic path's semantics
    B = ix1.n
    lmax = int(ix1.seq_len.max()) + int(ix2.seq_len.max())
    W = max(1, -(-lmax // 16))
    words = get_matrix("pipe.words", B, W, np.uint32)
    sumq = get_buffer("pipe.sumq", 4 * B, np.uint32)
    bucket = np.zeros(256, np.uint32)
    for lo in range(0, B, CHUNK_RECORDS):
        hi = min(lo + CHUNK_RECORDS, B)
        if not fused_pair_stats(ix1, ix2, lo, hi, W, words[lo:hi],
                                sumq[lo:hi], bucket):
            return False  # non-ACGT: generic path handles wide alphabets
    timer.log("Finished load hash at %.3f s\n")
    key_lens = (ix1.seq_len.astype(np.int64)
                + ix2.seq_len.astype(np.int64)).astype(np.int32)
    const_len = int(key_lens.min()) == int(key_lens.max()) if B else True
    gen, _ = _sort_groups(words, key_lens, sumq, bucket, const_len, W,
                          device)
    n_groups = 0
    with open(_fresh(with_suffix(outfile, "_1_uniq.fq")), "wb",
              buffering=0) as f1, \
            open(_fresh(with_suffix(outfile, "_2_uniq.fq")), "wb",
                 buffering=0) as f2:
        w1 = _RingWriter(_RecyclingSink(f1), ["uniq.emit1a", "uniq.emit1b"])
        w2 = _RingWriter(_RecyclingSink(f2), ["uniq.emit2a", "uniq.emit2b"])
        try:
            for rep, counts in gen:
                n_groups += len(rep)
                if len(rep) == 0:
                    continue
                name = w1.acquire()
                view, total = uniq_text(ix1, rep, counts, name)
                w1.submit(name, view, total)
                name = w2.acquire()
                view, total = uniq_text(ix2, rep, counts, name)
                w2.submit(name, view, total)
        finally:
            try:
                w1.close()
            finally:
                w2.close()
    sys.stderr.write(
        f"unique reads number = {n_groups}({n_groups} / {B} = "
        f"{100.0 * n_groups / B:.3f}%)\n")
    return True


def run_pe(read1: str, read2: str, outfile: str, timer: StageTimer,
           device: torch.device, mesh_n: int = 0) -> None:
    from ..io.native import fill_padded

    if mesh_n <= 1 and not os.environ.get("NGSTPU_NO_FASTPATH") \
            and _run_pe_fast(read1, read2, outfile, timer, device):
        return
    b1 = read_fastq_file(read1)
    b2 = read_fastq_file(read2)
    if b1.n != b2.n:
        sys.stderr.write("unmatched read pair counts\n")
    n = min(b1.n, b2.n)
    lmax12 = _pad4(int(b1.seq.shape[1]) + int(b2.seq.shape[1]))
    key = concat_pairs(b1.seq[:n], b1.lens[:n], b2.seq[:n], b2.lens[:n],
                       lmax12)
    key_lens = (b1.lens[:n].astype(np.int64)
                + b2.lens[:n].astype(np.int64)).astype(np.int32)
    sumq = (sum_quality_host(np.ascontiguousarray(b1.qual[:n]))
            + sum_quality_host(np.ascontiguousarray(b2.qual[:n])))
    rep, counts, n_groups = dedup_device(key, key_lens, sumq, device, mesh_n)
    sys.stderr.write(
        f"unique reads number = {n_groups}({n_groups} / {n} = "
        f"{100.0 * n_groups / n:.3f}%)\n" if n else "")
    timer.log("Finished load hash at %.3f s\n")

    # mate sequences come from the stored key split at the representative's
    # mate-1 length (gzfastq_uniq.c:336,345)
    rep_l1 = b1.lens[rep]
    rep_l2 = (key_lens[rep].astype(np.int64)
              - rep_l1.astype(np.int64)).astype(np.int32)
    key_rows = key[rep]
    seq1 = key_rows[:, :b1.seq.shape[1]]
    # mate2: shift each row left by its l1 — ragged slice via native helper
    flat = key_rows.reshape(-1)
    row_starts = (np.arange(len(rep), dtype=np.int64) * key_rows.shape[1]
                  + rep_l1.astype(np.int64))
    seq2 = fill_padded(flat, row_starts, rep_l2, b2.seq.shape[1])

    out1 = open_output(with_suffix(outfile, "_1_uniq.fq"))
    _emit(out1, b1, rep, counts, seq_override=seq1, lens_override=rep_l1)
    if out1 is not sys.stdout.buffer:
        out1.close()
    out2 = open_output(with_suffix(outfile, "_2_uniq.fq"))
    _emit(out2, b2, rep, counts, seq_override=seq2, lens_override=rep_l2)
    if out2 is not sys.stdout.buffer:
        out2.close()


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
    timer = StageTimer()
    read1, read2, outfile = "-", None, "-"
    mesh_n = int(os.environ.get("NGSTPU_MESH", "0"))
    if not argv:
        _usage()
        return 1
    opts, _ = getopt.gnu_getopt(argv, "1:2:o:m:h?")
    for flag, val in opts:
        if flag == "-1":
            read1 = val
        elif flag == "-2":
            read2 = val
        elif flag == "-o":
            outfile = val
        elif flag == "-m":
            mesh_n = int(val)
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    dev = resolve_device(device)
    if read2:
        run_pe(read1, read2, outfile, timer, dev, mesh_n)
    else:
        run_se(read1, outfile, timer, dev, mesh_n)
    timer.log("Finished  at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch [--device DEV] gzfastq_uniq [-1 READ1]"
        " [-2 READ2] [-o OUTFILE] [-m MESH] [-h]\n"
        "   [-1 READ1]  = fastq formated file1.   [required]\n"
        "   [-2 READ2]  = fastq formated file2.   [option]\n"
        "   [-o OUTPUT] = OUTPUT file.            [required]\n"
        "   [-m MESH]   = devices to shard the dedup over (env NGSTPU_MESH);"
        " one device only so far.\n")
