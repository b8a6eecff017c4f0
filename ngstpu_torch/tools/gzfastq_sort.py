"""gzfastq_sort: whole-file FASTQ sort by sequence or name on the port.

Mirrors ngstpu/tools/gzfastq_sort.py: the same flags and output (reference
gzfastq_sort.c). Comparators are length-first, then byte order; ties keep
input order (every sort here is stable). Output file = outfile +
"_sort_by_name.fq" / "_sort_by_seq.fq"; the default outfile "-" streams
to stdout. -r (preallocation hint) is accepted and ignored.

Fast route (a file output and the native lib): the input is indexed in
place, collation words are packed from the offsets, the permutation comes
from the device LSD chain (lex_argsort, length first) or, on a 'host'
link verdict, from the native bucket sort; records are emitted from the
raw bytes. Generic route: the padded batch is packed (names raw by
bytes_to_words on the device) and sorted the same way.

Usage: python -m ngstpu_torch.tools.cli [--device DEV] gzfastq_sort
       -i IN [-o OUTFILE] [-s|-n] [-m MESH]
"""

from __future__ import annotations

import getopt
import os
import sys

import numpy as np
import torch

from ..io.fastq import format_fastq, read_fastq_file
from ..io.stream import open_output, with_suffix
from ..ops.hostsort import (bytes_to_words_host, is_dna3_compatible,
                            sort_perm_host)
from ..ops.sortengine import bytes_to_words, lex_argsort, pack_words, \
    seq_words, words_tensor
from ..utils.device import check_mesh, resolve_device
from ..utils.linkprobe import link_verdict, probe_link
from ..utils.timing import StageRusage, StageTimer
from .emitters import _fresh, _RecyclingSink, _RingWriter

OUT_CHUNK = 1 << 20


def emit_permuted(out, batch, perm: np.ndarray) -> None:
    """Write records of `batch` in `perm` order (fused native gather+format,
    chunked fallback)."""
    from ..io.native import format_fastq_take

    if len(perm):
        text = format_fastq_take(batch.names, batch.name_starts,
                                 batch.name_lens, perm, None,
                                 batch.seq, batch.lens, perm,
                                 batch.qual, batch.lens, perm)
        if text is not None:
            out.write(text)
            return
    for lo in range(0, len(perm), OUT_CHUNK):
        sub = batch.take(perm[lo:lo + OUT_CHUNK])
        out.write(format_fastq(sub.names, sub.name_starts, sub.name_lens,
                               sub.seq, sub.qual, sub.lens))


def _run_sort_fast(infile: str, outfile: str, by_name: bool,
                   timer: StageTimer, device: torch.device) -> bool:
    """Offset-indexed whole-file sort: mmap + index, collation words packed
    chunk-wise straight from the offsets, placement-aware permutation
    (native 256-bucket sort on a 'host' verdict, device LSD otherwise), and
    records emitted from the raw bytes in permuted order with a ring writer
    overlapping format and file writes. Returns False when the fast path
    does not apply."""
    from ..io.fastindex import index_fastq, take_text
    from ..io.native import get_lib
    from ..utils.bufpool import get_buffer, get_matrix

    if (not outfile or outfile.startswith("-")
            or os.environ.get("NGSTPU_NO_FASTPATH")):
        return False
    lib = get_lib()
    if lib is None:
        return False
    ru = StageRusage()
    ix = index_fastq(infile, pool="sort.ix")
    if ix is None or ix.n == 0:
        return False
    B = ix.n
    timer.log("done read file at %.3f s\n")
    ru.checkpoint("index")
    offs = ix.name_off if by_name else ix.seq_off
    klens = np.ascontiguousarray(ix.name_len if by_name else ix.seq_len,
                                 np.int32)
    lmax = max(int(klens.max()), 4)

    # sequences try the 3-bit DNA packing in one fused native pass; a
    # wider alphabet restarts the pack raw (chunked fill_padded +
    # big-endian view). Names always pack raw.
    kind = "raw" if by_name else "dna3"
    if kind == "dna3":
        W = (lmax + 9) // 10
        words = get_matrix("sort.words", B, W, np.uint32)
        if lib.ngs_dna3_pack_ofs(ix.data, offs, klens, B, W, words, 0):
            kind = "raw"
    if kind == "raw":
        CH = 1 << 20
        lmax4 = (lmax + 3) // 4 * 4
        W = lmax4 // 4
        words = get_matrix("sort.words", B, W, np.uint32)
        for lo in range(0, B, CH):
            hi = min(lo + CH, B)
            padded = get_buffer("sort.pad", (hi - lo) * lmax4
                                ).reshape(hi - lo, lmax4)
            lib.ngs_fill_padded(ix.data, offs[lo:hi],
                                klens[lo:hi], hi - lo, lmax4, padded, 0)
            words[lo:hi] = padded.view(">u4")

    v = link_verdict()
    if v is None and words.nbytes >= (8 << 20):
        v = probe_link(words)
    if v == "host":
        # constant-length keys make the length-first comparator vacuous;
        # the host engine then buckets by the leading packed byte and
        # streams each sorted bucket to the emitter
        if int(klens.min()) == int(klens.max()):
            _stream_sorted_emit(ix, words, outfile, by_name, timer, ru)
            return True
        perm = sort_perm_host(words, klens, True)
    else:
        perm = lex_argsort(words_tensor(words, device),
                           torch.from_numpy(klens).to(device),
                           length_first=True).cpu().numpy()
    timer.log("done qsort file at %.3f s\n")
    ru.checkpoint("pack_sort")

    suffix = "_sort_by_name.fq" if by_name else "_sort_by_seq.fq"
    with open(_fresh(with_suffix(outfile, suffix)), "wb",
              buffering=0) as f:
        w = _RingWriter(_RecyclingSink(f), ["sort.emitA", "sort.emitB"])
        try:
            for lo in range(0, B, 1 << 19):
                sl = perm[lo:lo + (1 << 19)]
                name = w.acquire()
                view, total = take_text(ix, sl, name)
                w.submit(name, view, total)
        finally:
            w.close()
    timer.log("done write file at %.3f s\n")
    ru.checkpoint("emit_write")
    ru.dump(tool="gzfastq_sort", reads=B, placement=v or "device")
    return True


def _stream_sorted_emit(ix, words: np.ndarray, outfile: str, by_name: bool,
                        timer: StageTimer, ru) -> None:
    """Constant-length host sort with the radix streamed under the emit:
    ngs_msd_scatter_u32 builds the stable 256-bucket permutation, a
    sorter thread radixes buckets in ascending (== output) order
    (ngs_sort_perm_range, GIL released), and the main thread formats +
    submits each completed bucket range to the ring writer. Order is
    identical to sort_perm_host(words, lens, length_first) on equal
    lengths — covered by the byte-parity oracle tests."""
    import ctypes
    import queue
    import threading

    from ..io.fastindex import take_text
    from ..io.native import get_lib
    from ..utils.bufpool import get_buffer

    lib = get_lib()
    B, W = words.shape
    perm = get_buffer("sort.perm", 4 * B, np.int32)[:B]
    boff = np.zeros(257, np.int64)
    lib.ngs_msd_scatter_u32(words, B, W, perm, boff)
    done_q: "queue.Queue[int]" = queue.Queue()
    box: list = []

    def sorter():
        try:
            for k in range(256):
                if boff[k + 1] > boff[k]:
                    lib.ngs_sort_perm_range(words, W, perm,
                                            int(boff[k]), int(boff[k + 1]))
                done_q.put(k)
        except BaseException as e:  # pragma: no cover - surfaced below
            box.append(e)
            done_q.put(-1)

    t = threading.Thread(target=sorter, daemon=True)
    t.start()
    timer.log("done qsort file at %.3f s\n")
    ru.checkpoint("pack_sort")
    suffix = "_sort_by_name.fq" if by_name else "_sort_by_seq.fq"
    with open(_fresh(with_suffix(outfile, suffix)), "wb",
              buffering=0) as f:
        w = _RingWriter(_RecyclingSink(f), ["sort.emitA", "sort.emitB"])
        try:
            emitted = 0   # buckets formatted
            ready = -1    # highest contiguous sorted bucket
            # group small buckets: submit once >= this many rows ready
            MIN_ROWS = 1 << 18
            pend_lo = 0
            while emitted < 256:
                k = done_q.get()
                if k < 0:
                    raise box[0]
                ready = k
                lo, hi = pend_lo, int(boff[ready + 1])
                if hi - lo >= MIN_ROWS or ready == 255:
                    for clo in range(lo, hi, 1 << 19):
                        chi = min(clo + (1 << 19), hi)
                        name = w.acquire()
                        view, total = take_text(
                            ix, perm[clo:chi].astype(np.int64), name)
                        w.submit(name, view, total)
                    pend_lo = hi
                emitted = ready + 1
        finally:
            w.close()
    t.join()
    timer.log("done write file at %.3f s\n")
    ru.checkpoint("emit_write")
    ru.dump(tool="gzfastq_sort", reads=B, placement="host")


def _link_placement(operand: np.ndarray) -> str | None:
    """Transfer-aware placement for the whole-file sort: a known verdict
    applies at any size; an unknown link only probes for operands big
    enough to matter."""
    v = link_verdict()
    if v is None and operand.nbytes >= (8 << 20):
        v = probe_link(operand)
    return v


def _lens(lens: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(lens, np.int32)).to(device)


def sort_perm_by_seq(batch, device: torch.device,
                     mesh_n: int = 0) -> np.ndarray:
    if mesh_n > 1:
        check_mesh(mesh_n, device)  # ngstpu's _mesh_perm
    if _link_placement(batch.seq) == "host":
        kind = "dna3" if is_dna3_compatible(batch.seq, None) else "raw"
        perm = sort_perm_host(pack_words(batch.seq, kind, device),
                              batch.lens, True)
        if perm is not None:
            return perm
    words = seq_words(batch.seq, device)
    return lex_argsort(words, _lens(batch.lens, device),
                       length_first=True).cpu().numpy()


def sort_perm_by_name(batch, device: torch.device,
                      mesh_n: int = 0) -> np.ndarray:
    from ..io.native import fill_padded

    lmax = max(int(batch.name_lens.max(initial=0)), 4)
    lmax = (lmax + 3) // 4 * 4
    padded = fill_padded(batch.names, batch.name_starts, batch.name_lens,
                         lmax)
    if mesh_n > 1:
        check_mesh(mesh_n, device)  # ngstpu's _mesh_perm
    if _link_placement(padded) == "host":
        perm = sort_perm_host(bytes_to_words_host(padded), batch.name_lens,
                              True)
        if perm is not None:
            return perm
    # names pack raw, so their words pass 2**31: bytes_to_words widens
    # them to int64 with the 0xFFFFFFFF mask, never as signed int32
    words = bytes_to_words(torch.from_numpy(padded).to(device))
    return lex_argsort(words, _lens(batch.name_lens, device),
                       length_first=True).cpu().numpy()


def main(argv: list[str], device: str | torch.device = "cuda") -> int:
    timer = StageTimer()
    infile, outfile = "-", "-"
    by_name = by_seq = 0
    if not argv:
        _usage()
        return 1
    mesh_n = int(os.environ.get("NGSTPU_MESH", "0"))
    opts, _ = getopt.gnu_getopt(argv, "i:o:r:m:nsh?")
    for flag, val in opts:
        if flag == "-i":
            infile = val
        elif flag == "-o":
            outfile = val
        elif flag == "-r":
            pass  # preallocation hint: unnecessary here
        elif flag == "-m":
            mesh_n = int(val)
        elif flag == "-n":
            by_name, by_seq = 1, 0
        elif flag == "-s":
            by_name, by_seq = 0, 1
        elif flag in ("-h", "-?"):
            _usage()
            return 1
    if not by_name and not by_seq:
        by_seq = 1
    sys.stderr.write(f"name: {by_name}\tseq: {by_seq}\n")
    dev = resolve_device(device)

    if mesh_n <= 1 and _run_sort_fast(infile, outfile, bool(by_name),
                                      timer, dev):
        return 0
    batch = read_fastq_file(infile)
    timer.log("done read file at %.3f s\n")
    if by_name:
        perm = sort_perm_by_name(batch, dev, mesh_n)
        out = open_output(with_suffix(outfile, "_sort_by_name.fq"))
    else:
        perm = sort_perm_by_seq(batch, dev, mesh_n)
        out = open_output(with_suffix(outfile, "_sort_by_seq.fq"))
    timer.log("done qsort file at %.3f s\n")
    emit_permuted(out, batch, perm)
    if out is not sys.stdout.buffer:
        out.close()
    else:
        out.flush()
    timer.log("done write file at %.3f s\n")
    return 0


def _usage() -> None:
    sys.stderr.write(
        "Usage: ngstpu-torch [--device DEV] gzfastq_sort [-i Infile]"
        " [-o OUTFILE] [-r reads_num] [-s|-n] [-h]\n"
        "   [-i Infile] = Infile.\n"
        "   [-o OUTPUT] = OUTPUT file. default is stdout\n"
        "   [-s ] sort by sequence.\n"
        "   [-m MESH] devices to shard the sort over (env NGSTPU_MESH);"
        " one device only so far.\n"
        "   [-n ] sort by sequence name.\n")
