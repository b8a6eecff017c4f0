"""Chunked FASTQ decode into padded device-ready batches, and parity writers.

Replaces the reference's two record readers (klib kseq.h:171-211 and the
ad-hoc 4x gzgets loops, e.g. reference fastq_trim.c:67-89) with a vectorized
chunk parser: one numpy pass finds line breaks, a single gather pads
sequences/qualities into [B, Lmax] uint8 matrices. Names never go to the
device; they stay as a host-side byte blob + offsets.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from .ragged import ragged_arange, round_up
from .stream import open_input

DEFAULT_CHUNK_BYTES = 64 << 20


@dataclasses.dataclass
class FastqBatch:
    """One padded batch of FASTQ records.

    seq/qual: uint8 [B, Lmax] zero-padded; lens: int32 [B];
    names: flat uint8 blob of name lines (no '\\n', includes leading '@');
    name_starts/name_lens: int64/int32 [B] into `names`;
    plus: same layout for the '+' lines (often all "+").
    """

    seq: np.ndarray
    qual: np.ndarray
    lens: np.ndarray
    names: np.ndarray
    name_starts: np.ndarray
    name_lens: np.ndarray
    plus: np.ndarray | None = None
    plus_starts: np.ndarray | None = None
    plus_lens: np.ndarray | None = None

    @property
    def n(self) -> int:
        return len(self.lens)

    @property
    def lmax(self) -> int:
        return self.seq.shape[1] if self.seq.ndim == 2 else 0

    def name(self, i: int) -> bytes:
        s = int(self.name_starts[i])
        return self.names[s:s + int(self.name_lens[i])].tobytes()

    def seq_bytes(self, i: int) -> bytes:
        return self.seq[i, : int(self.lens[i])].tobytes()

    def qual_bytes(self, i: int) -> bytes:
        return self.qual[i, : int(self.lens[i])].tobytes()

    def take(self, idx: np.ndarray) -> "FastqBatch":
        """Row-subset batch (host-side); name blob re-sliced lazily."""
        idx = np.asarray(idx)
        nl = self.name_lens[idx]
        nstart_new = np.zeros(len(idx), dtype=np.int64)
        if len(idx):
            np.cumsum(nl[:-1].astype(np.int64), out=nstart_new[1:])
        src = np.repeat(self.name_starts[idx].astype(np.int64), nl) + ragged_arange(nl)
        return FastqBatch(
            seq=self.seq[idx], qual=self.qual[idx], lens=self.lens[idx],
            names=self.names[src], name_starts=nstart_new, name_lens=nl)


def _parse_chunk(data: np.ndarray, keep_plus: bool, pad_to: int,
                 need: frozenset = frozenset(("seq", "qual", "names"))
                 ) -> FastqBatch:
    """Parse a byte array holding a whole number of 4-line FASTQ records.

    `need` controls which padded fields are materialized — e.g. fastq_count
    only touches qualities, so skipping seq/name extraction halves the
    host-side work.

    Fast path: the fused native parser (ngs_fastq_scan/fill — two passes
    over the chunk, no offset arrays). The numpy pipeline below is the
    fallback and handles keep_plus.
    """
    if not keep_plus:
        from .native import parse_fastq_chunk

        fused = parse_fastq_chunk(data, pad_to, need)
        if fused is not None:
            seq, qual, seq_lens, names, name_starts, name_lens = fused
            return FastqBatch(seq=seq, qual=qual, lens=seq_lens, names=names,
                              name_starts=name_starts, name_lens=name_lens)

    from .native import find_newlines

    nl = find_newlines(data)
    if len(nl) % 4:
        raise ValueError(f"FASTQ chunk has {len(nl)} lines (not a multiple of 4)")
    starts = np.empty(len(nl), dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    line_lens = nl - starts  # without the newline

    b = len(nl) // 4
    name_starts, seq_starts = starts[0::4], starts[1::4]
    name_lens = line_lens[0::4].astype(np.int32)
    seq_lens = line_lens[1::4].astype(np.int32)
    qual_starts = starts[3::4]
    qual_lens = line_lens[3::4].astype(np.int32)

    from .native import concat_ragged, fill_padded

    lmax = max(int(seq_lens.max()) if b else 0, int(qual_lens.max()) if b else 0)
    lmax = max(round_up(max(lmax, 1), pad_to), pad_to)
    empty = np.zeros((b, 0), dtype=np.uint8)
    seq = (fill_padded(data, seq_starts, seq_lens, lmax)
           if "seq" in need else empty)
    qual = (fill_padded(data, qual_starts, qual_lens, lmax)
            if "qual" in need else empty)

    if "names" in need:
        # Names: compact blob (drop seq/qual bytes so batches can be retained).
        names = concat_ragged(data, name_starts, name_lens)
        new_name_starts = np.zeros(b, dtype=np.int64)
        if b:
            np.cumsum(name_lens[:-1].astype(np.int64), out=new_name_starts[1:])
    else:
        names = np.zeros(0, dtype=np.uint8)
        new_name_starts = np.zeros(b, dtype=np.int64)
        name_lens = np.zeros(b, dtype=np.int32)

    batch = FastqBatch(seq=seq, qual=qual, lens=seq_lens, names=names,
                       name_starts=new_name_starts, name_lens=name_lens)
    if keep_plus:
        plus_starts, plus_lens = starts[2::4], line_lens[2::4].astype(np.int32)
        psrc = np.repeat(plus_starts, plus_lens.astype(np.int64)) + ragged_arange(plus_lens)
        batch.plus = data[psrc]
        batch.plus_starts = np.zeros(b, dtype=np.int64)
        if b:
            np.cumsum(plus_lens[:-1].astype(np.int64), out=batch.plus_starts[1:])
        batch.plus_lens = plus_lens
    return batch


class FastqChunkReader:
    """Stream a FASTQ file (plain or gzip, '-'=stdin) as padded batches.

    A producer thread performs the read+gzip-inflate (zlib releases the GIL)
    while the consumer parses the previous chunk — the kt_pipeline
    read/compute overlap of the reference (klib kthread.c:83-143) in
    double-buffered form. Disable with threaded=False.
    """

    def __init__(self, path: str | None, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 keep_plus: bool = False, pad_to: int = 128,
                 need: tuple[str, ...] = ("seq", "qual", "names"),
                 threaded: bool = True):
        self.path = path
        self.chunk_bytes = chunk_bytes
        self.keep_plus = keep_plus
        self.pad_to = pad_to
        self.need = frozenset(need)
        self.threaded = threaded

    def _chunks(self) -> Iterator[bytes]:
        stream = open_input(self.path)
        try:
            if not self.threaded:
                while True:
                    data = stream.read(self.chunk_bytes)
                    if not data:
                        return
                    yield data
            else:
                import queue
                import threading

                q: "queue.Queue[bytes | None | Exception]" = queue.Queue(maxsize=2)

                def produce():
                    try:
                        while True:
                            d = stream.read(self.chunk_bytes)
                            if not d:
                                q.put(None)
                                return
                            q.put(d)
                    except Exception as e:  # surface in consumer
                        q.put(e)

                t = threading.Thread(target=produce, daemon=True)
                t.start()
                while True:
                    item = q.get()
                    if item is None:
                        t.join()
                        return
                    if isinstance(item, Exception):
                        raise item
                    yield item
        finally:
            stream.close()

    def __iter__(self) -> Iterator[FastqBatch]:
        tail = b""
        for data in self._chunks():
            buf = tail + data if tail else data
            cut = _record_boundary(buf)
            tail = buf[cut:]
            if cut:
                yield _parse_chunk(np.frombuffer(buf[:cut], dtype=np.uint8),
                                   self.keep_plus, self.pad_to, self.need)
        if tail:
            if not tail.endswith(b"\n"):
                tail += b"\n"  # tolerate missing final newline
            yield _parse_chunk(np.frombuffer(tail, dtype=np.uint8),
                               self.keep_plus, self.pad_to, self.need)


def _record_boundary(buf: bytes) -> int:
    """Largest offset that ends a whole number of 4-line records.

    O(1) memory: count newlines with bytes.count, then walk back over the
    0..3 trailing partial lines with rfind.
    """
    n_nl = buf.count(b"\n")
    n_full = (n_nl // 4) * 4
    if n_full == 0:
        return 0
    pos = len(buf)
    for _ in range(n_nl - n_full + 1):
        pos = buf.rfind(b"\n", 0, pos)
    return pos + 1


def read_fastq_batches(path: str | None, **kw) -> Iterator[FastqBatch]:
    return iter(FastqChunkReader(path, **kw))


def concat_batches(batches: list[FastqBatch]) -> FastqBatch:
    """Concatenate chunk batches into one whole-file batch (global Lmax)."""
    if len(batches) == 1:
        return batches[0]
    if not batches:
        return FastqBatch(seq=np.zeros((0, 128), np.uint8),
                          qual=np.zeros((0, 128), np.uint8),
                          lens=np.zeros(0, np.int32),
                          names=np.zeros(0, np.uint8),
                          name_starts=np.zeros(0, np.int64),
                          name_lens=np.zeros(0, np.int32))
    lmax = max(b.lmax for b in batches)

    def padw(m):
        return m if m.shape[1] == lmax else np.pad(m, ((0, 0), (0, lmax - m.shape[1])))

    seq = np.concatenate([padw(b.seq) for b in batches]) \
        if batches[0].seq.shape[1] else batches[0].seq
    qual = np.concatenate([padw(b.qual) for b in batches]) \
        if batches[0].qual.shape[1] else batches[0].qual
    lens = np.concatenate([b.lens for b in batches])
    names = np.concatenate([b.names for b in batches])
    name_lens = np.concatenate([b.name_lens for b in batches])
    name_starts = np.zeros(len(lens), dtype=np.int64)
    if len(lens):
        np.cumsum(name_lens[:-1].astype(np.int64), out=name_starts[1:])
    return FastqBatch(seq=seq, qual=qual, lens=lens, names=names,
                      name_starts=name_starts, name_lens=name_lens)


def read_fastq_file(path: str | None, **kw) -> FastqBatch:
    """Whole-file load as one padded batch (the load_file pattern of
    gzfastq_sort.c:105-141).

    Plain seekable files parse in ONE fused native pass over the whole
    buffer — no per-chunk batches, no concat copies (worth several
    seconds at 2M+ reads). gzip/stdin keep the chunked reader."""
    # a leading '-' means stdin throughout the toolkit (the strncmp
    # semantics of reference IO_stream.h:55 that open_input implements),
    # so the fast path must not grab an on-disk file named "-x.fq"
    if (path and not path.startswith("-") and not kw.get("keep_plus")
            and os.path.isfile(path)):
        try:
            with open(path, "rb") as f:
                magic = f.read(2)
        except OSError:
            magic = b""
        if magic not in (b"\x1f\x8b", b""):
            data = np.fromfile(path, np.uint8)
            if len(data):
                if data[-1] != 0x0A:  # tolerate missing final newline
                    data = np.append(data, np.uint8(0x0A))
                return _parse_chunk(
                    data, False, kw.get("pad_to", 128),
                    frozenset(kw.get("need", ("seq", "qual", "names"))))
    return concat_batches(list(FastqChunkReader(path, **kw)))


def count_reads(path: str | None, chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> int:
    """Fast first-pass read count (newlines/4), the role of count_read
    (reference gzfastq_sample.c:214-225)."""
    stream = open_input(path)
    n_nl = 0
    last = b""
    try:
        while True:
            data = stream.read(chunk_bytes)
            if not data:
                break
            n_nl += data.count(b"\n")
            last = data[-1:]
    finally:
        stream.close()
    if last and last != b"\n":
        n_nl += 1
    return n_nl // 4


def format_fastq(names: np.ndarray, name_starts: np.ndarray, name_lens: np.ndarray,
                 seq: np.ndarray, qual: np.ndarray, lens: np.ndarray,
                 qual_lens: np.ndarray | None = None,
                 count_suffix: np.ndarray | None = None) -> bytes:
    """Vectorized FASTQ text assembly: name[+suffix]\\nseq\\n+\\nqual\\n.

    Matches the writer format shared by the reference tools
    (e.g. reference fastq_trim.c:101, gzfastq_sample.c:33). `count_suffix`
    optionally appends per-record ascii suffix bytes to the name line
    (reference gzfastq_sample.c renames reads `name_i`).

    Uses the native parallel assembler when available.
    """
    from . import native as _native

    lib = _native.get_lib()
    if lib is not None and seq.ndim == 2 and qual.ndim == 2 \
            and seq.shape[1] == qual.shape[1] and len(lens):
        import ctypes

        b = len(lens)
        lens32 = np.ascontiguousarray(lens, np.int32)
        qlens32 = (lens32 if qual_lens is None
                   else np.ascontiguousarray(qual_lens, np.int32))
        nlens32 = np.ascontiguousarray(name_lens, np.int32)
        nstarts = np.ascontiguousarray(name_starts, np.int64)
        if count_suffix is not None:
            suf_blob = np.frombuffer(b"".join(count_suffix), dtype=np.uint8)
            suf_lens = np.array([len(s) for s in count_suffix], dtype=np.int32)
            suf_starts = np.zeros(b, dtype=np.int64)
            np.cumsum(suf_lens[:-1].astype(np.int64), out=suf_starts[1:])
        else:
            suf_blob = suf_lens = suf_starts = None
        rec_lens = (nlens32.astype(np.int64)
                    + (suf_lens.astype(np.int64) if suf_lens is not None else 0)
                    + 1 + lens32.astype(np.int64) + 3
                    + qlens32.astype(np.int64) + 1)
        out_starts = np.zeros(b, dtype=np.int64)
        np.cumsum(rec_lens[:-1], out=out_starts[1:])
        out = np.empty(int(rec_lens.sum()), dtype=np.uint8)

        def vp(a):
            return (a.ctypes.data_as(ctypes.c_void_p) if a is not None
                    else ctypes.c_void_p(0))

        lib.ngs_format_fastq(
            np.ascontiguousarray(names), nstarts, nlens32,
            vp(suf_blob), vp(suf_starts), vp(suf_lens),
            np.ascontiguousarray(seq), np.ascontiguousarray(qual), lens32,
            vp(qlens32 if qual_lens is not None else None),
            b, seq.shape[1], out_starts, out, 0)
        return out.tobytes()

    from .ragged import scatter_fields

    b = len(lens)
    lens64 = lens.astype(np.int64)
    qlens64 = lens64 if qual_lens is None else qual_lens.astype(np.int64)
    nlens64 = name_lens.astype(np.int64)
    if count_suffix is not None:
        suf_lens = np.asarray([len(s) for s in count_suffix], dtype=np.int64)
    else:
        suf_lens = np.zeros(b, dtype=np.int64)

    rec_lens = nlens64 + suf_lens + 1 + lens64 + 1 + 2 + qlens64 + 1
    rec_starts = np.zeros(b, dtype=np.int64)
    if b:
        np.cumsum(rec_lens[:-1], out=rec_starts[1:])
    total = int(rec_lens.sum())

    name_src = np.repeat(name_starts.astype(np.int64), nlens64) + ragged_arange(nlens64)
    flat_names = names[name_src]
    flat_seq = seq[np.arange(seq.shape[1])[None, :] < lens64[:, None]]
    flat_qual = qual[np.arange(qual.shape[1])[None, :] < qlens64[:, None]]

    nl = np.full(b, 0x0A, dtype=np.uint8)
    plus_nl = np.tile(np.frombuffer(b"+\n", dtype=np.uint8), b)
    ones = np.ones(b, dtype=np.int64)
    twos = np.full(b, 2, dtype=np.int64)

    fields_starts = [rec_starts,
                     rec_starts + nlens64 + suf_lens,
                     rec_starts + nlens64 + suf_lens + 1,
                     rec_starts + nlens64 + suf_lens + 1 + lens64,
                     rec_starts + nlens64 + suf_lens + 1 + lens64 + 1,
                     rec_starts + nlens64 + suf_lens + 1 + lens64 + 1 + 2,
                     rec_starts + nlens64 + suf_lens + 1 + lens64 + 3 + qlens64]
    fields_bytes = [flat_names, nl, flat_seq, nl, plus_nl, flat_qual, nl]
    fields_lens = [nlens64, ones, lens64, ones, twos, qlens64, ones]
    if count_suffix is not None:
        flat_suf = np.frombuffer(b"".join(count_suffix), dtype=np.uint8)
        fields_starts.insert(1, rec_starts + nlens64)
        fields_bytes.insert(1, flat_suf)
        fields_lens.insert(1, suf_lens)

    return scatter_fields(total, fields_starts, fields_bytes, fields_lens).tobytes()
