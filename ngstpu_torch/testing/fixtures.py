"""Seeded FASTQ inputs for the port's tests and end-to-end checks.

BASES, random_fastq, random_fastq_pair and gz are copies of ngstpu's
testing/fixtures.py (the same draws give the same bytes); the rest build
large inputs as one byte matrix.
"""

from __future__ import annotations

import gzip
import io

import numpy as np

from ..ops.fastqc import ADAPTER_BYTES

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
BASES_N = np.frombuffer(b"ACGTN", dtype=np.uint8)


def random_fastq(n_reads: int, read_len: int = 100, seed: int = 0,
                 var_len: bool = False, min_len: int = 30,
                 with_n: bool = False, name_prefix: str = "read",
                 with_comment: bool = False, dup_frac: float = 0.0,
                 qual_lo: int = 33, qual_hi: int = 74,
                 qual_alphabet: bytes | None = None) -> bytes:
    """Generate FASTQ text. dup_frac makes that fraction of reads copies of
    earlier reads (for dedup tests)."""
    rng = np.random.default_rng(seed)
    lens = (rng.integers(min_len, read_len + 1, n_reads) if var_len
            else np.full(n_reads, read_len, dtype=np.int64))
    alphabet = BASES_N if with_n else BASES
    out = io.BytesIO()
    seqs: list[bytes] = []
    for i in range(n_reads):
        li = int(lens[i])
        if dup_frac > 0 and i > 0 and rng.random() < dup_frac:
            j = int(rng.integers(0, len(seqs)))
            seq = seqs[j]
            li = len(seq)
        else:
            seq = alphabet[rng.integers(0, len(alphabet), li)].tobytes()
        seqs.append(seq)
        if qual_alphabet is not None:
            qa = np.frombuffer(qual_alphabet, dtype=np.uint8)
            qual = qa[rng.integers(0, len(qa), li)].tobytes()
        else:
            qual = rng.integers(qual_lo, qual_hi + 1, li, dtype=np.uint8).tobytes()
        name = f"@{name_prefix}_{i}"
        if with_comment:
            name += f" comment/{i % 2 + 1}"
        out.write(name.encode() + b"\n" + seq + b"\n+\n" + qual + b"\n")
    return out.getvalue()


def random_fastq_pair(n_reads: int, read_len: int = 100, seed: int = 0,
                      **kw) -> tuple[bytes, bytes]:
    r1 = random_fastq(n_reads, read_len, seed, name_prefix="pair", **kw)
    r2 = random_fastq(n_reads, read_len, seed + 1, name_prefix="pair", **kw)
    return r1, r2


def gz(data: bytes) -> bytes:
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as f:
        f.write(data)
    return buf.getvalue()


def name_matrix(n: int, fields) -> np.ndarray:
    """uint8 [n, W] names from `fields`: bytes are copied into every row,
    (int array, width) pairs written as zero-padded decimal digits."""
    widths = [len(f) if isinstance(f, bytes) else f[1] for f in fields]
    out = np.empty((n, sum(widths)), np.uint8)
    c = 0
    for f, w in zip(fields, widths):
        if isinstance(f, bytes):
            out[:, c:c + w] = np.frombuffer(f, np.uint8)
        else:
            for d in range(w):
                out[:, c + d] = ord("0") + f[0] // 10 ** (w - 1 - d) % 10
        c += w
    return out


def fastq_records(names: np.ndarray, seqs: np.ndarray, quals: np.ndarray,
                  lens: np.ndarray | None = None) -> bytes:
    """FASTQ text from uint8 names [n, W] and reads [n, L], built as one
    [n, record] byte matrix: one copy of the output, with no per-record
    Python objects. With `lens`, read i keeps its first lens[i] bases and
    qualities."""
    n, L = seqs.shape
    W = names.shape[1]
    rec = np.empty((n, W + 1 + L + 3 + L + 1), np.uint8)
    rec[:, :W] = names
    rec[:, W] = 0x0A
    rec[:, W + 1:W + 1 + L] = seqs
    c = W + 1 + L
    rec[:, c:c + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, c + 3:c + 3 + L] = quals
    rec[:, -1] = 0x0A
    if lens is None:
        return rec.tobytes()
    keep = np.ones(rec.shape, bool)
    past = np.arange(L)[None, :] >= np.asarray(lens)[:, None]
    keep[:, W + 1:W + 1 + L] = ~past
    keep[:, c + 3:c + 3 + L] = ~past
    return rec[keep].tobytes()


def fastq_text(prefix: bytes, seqs: np.ndarray, quals: np.ndarray) -> bytes:
    """FASTQ text of fixed-length reads named prefix + str(i), i from 0:
    fastq_records over each run of names with the same number of digits."""
    n = len(seqs)
    parts = []
    lo = 0
    while lo < n:
        nd = len(str(lo))
        hi = min(n, 10 ** nd)
        names = name_matrix(hi - lo, [prefix, (np.arange(lo, hi), nd)])
        parts.append(fastq_records(names, seqs[lo:hi], quals[lo:hi]))
        lo = hi
    return b"".join(parts)


def random_fastq_fast(n_reads: int, read_len: int = 100, seed: int = 0,
                      name_prefix: str = "read",
                      dup_frac: float = 0.0) -> bytes:
    """ngstpu/testing/fixtures.py:random_fastq_fast, byte for byte (the same
    draws from the same generator), built by fastq_text."""
    rng = np.random.default_rng(seed)
    seqs = BASES[rng.integers(0, 4, (n_reads, read_len))]
    if dup_frac > 0:
        src = rng.integers(0, n_reads, n_reads)
        dup = rng.random(n_reads) < dup_frac
        seqs = seqs[np.where(dup, src, np.arange(n_reads))]
    quals = rng.integers(33, 75, (n_reads, read_len), dtype=np.uint8)
    return fastq_text(f"@{name_prefix}_".encode(), seqs, quals)


def _pair_draws(n_pairs: int, read_len: int, seed: int, dup_frac: float):
    """The generator, then each mate's sequences and qualities, drawn in
    random_fastq_pair_fast's order."""
    rng = np.random.default_rng(seed)
    seqs = [BASES[rng.integers(0, 4, (n_pairs, read_len))] for _ in range(2)]
    if dup_frac > 0:
        src = rng.integers(0, n_pairs, n_pairs)
        dup = rng.random(n_pairs) < dup_frac
        pick = np.where(dup, src, np.arange(n_pairs))
        seqs = [s[pick] for s in seqs]
    quals = [rng.integers(33, 75, (n_pairs, read_len), dtype=np.uint8)
             for _ in range(2)]
    return rng, seqs, quals


def random_fastq_pair_fast(n_pairs: int, read_len: int = 100, seed: int = 0,
                           dup_frac: float = 0.0) -> tuple[bytes, bytes]:
    """Two mate files of fixed-length pairs named @pair_i in both. One
    duplicate draw applies to both mates, so about `dup_frac` of the pairs
    repeat an earlier pair whole."""
    _, seqs, quals = _pair_draws(n_pairs, read_len, seed, dup_frac)
    return (fastq_text(b"@pair_", seqs[0], quals[0]),
            fastq_text(b"@pair_", seqs[1], quals[1]))


def numbered_fastq(prefix: bytes, ids, read_len: int, seed: int,
                   qual_alphabet: bytes | None = None) -> bytes:
    """Random ACGT reads of read_len bases named prefix + ids[i] as 5
    digits (so names sort as the ids do), qualities drawn from
    `qual_alphabet`, or from ASCII 33..74 without one."""
    rng = np.random.default_rng(seed)
    ids = np.asarray(ids, np.int64)
    n = len(ids)
    seqs = BASES[rng.integers(0, 4, (n, read_len))]
    quals = rng.integers(33, 75, (n, read_len), dtype=np.uint8) \
        if qual_alphabet is None else \
        np.frombuffer(qual_alphabet, np.uint8)[
            rng.integers(0, len(qual_alphabet), (n, read_len))]
    return fastq_records(name_matrix(n, [prefix, (ids, 5)]), seqs, quals)


HOT_SHARE = 0.002  # reads per hot sequence: above FastQC's 0.1% threshold


def illumina_names(n: int, n_tiles: int, seed: int, mate: int = 1
                   ) -> np.ndarray:
    """uint8 [n, 46] CASAVA 1.8 read names,
    @A00123:8:HFWCKDSXX:1:{tile}:{x}:{y} {mate}:N:0:1, read i on tile
    i * n_tiles // n as a lane file is ordered. Tiles number surface,
    swath and tile as Illumina does (1101, 2101, 1102, ...), at most 78
    per swath; x and y are 5 digits. The same seed gives both mates the
    same coordinates."""
    if not 0 < n_tiles <= 2 * 9 * 78:
        raise ValueError(f"n_tiles must be in 1..{2 * 9 * 78}")
    rng = np.random.default_rng([seed, 1])
    t = np.arange(n, dtype=np.int64) * n_tiles // max(n, 1)
    tile = (1 + t % 2) * 1000 + (1 + t // 2 // 78) * 100 + 1 + t // 2 % 78
    return name_matrix(n, [b"@A00123:8:HFWCKDSXX:1:", (tile, 4), b":",
                           (rng.integers(10000, 32768, n), 5), b":",
                           (rng.integers(10000, 37000, n), 5),
                           b" %d:N:0:1" % mate])


def _plant(rng, mates: list, lens, hot: int, n_frac: float,
           adapter_frac: float) -> None:
    """In place: `hot` sequences (pairs) each in about HOT_SHARE of the
    reads, the same rows in every mate; then, per mate, one N at a random
    cycle in an `n_frac` share of the reads and one of FastQC's adapters
    at a random offset in an `adapter_frac` share."""
    n, L = mates[0].shape
    if hot:
        rows = np.flatnonzero(rng.random(n) < hot * HOT_SHARE)
        which = rng.integers(0, hot, len(rows))
        for s in mates:
            s[rows] = BASES[rng.integers(0, 4, (hot, L), dtype=np.uint8)
                            ][which]
    k = ADAPTER_BYTES.shape[1]
    for s in mates:
        ln = np.full(n, L) if lens is None else np.asarray(lens)
        rows = np.flatnonzero(rng.random(n) < n_frac)
        s[rows, (rng.random(len(rows)) * ln[rows]).astype(np.int64)] = \
            ord("N")
        rows = np.flatnonzero((rng.random(n) < adapter_frac) & (ln >= k))
        off = (rng.random(len(rows)) * (ln[rows] - k + 1)).astype(np.int64)
        ad = ADAPTER_BYTES[rng.integers(0, len(ADAPTER_BYTES), len(rows))]
        for j in range(k):
            s[rows, off + j] = ad[:, j]


def illumina_fastq_fast(n_reads: int, read_len: int = 100, seed: int = 0,
                        n_tiles: int = 96, dup_frac: float = 0.0,
                        hot: int = 0, n_frac: float = 0.0,
                        adapter_frac: float = 0.0,
                        min_len: int | None = None) -> bytes:
    """A lane-like FASTQ file: CASAVA 1.8 names over `n_tiles` tiles
    (illumina_names), random ACGT reads of which about `dup_frac` repeat an
    earlier read, `hot` overrepresented sequences, N calls and adapters
    (_plant). With `min_len`, read lengths are uniform in
    min_len..read_len; else every read has read_len bases."""
    rng = np.random.default_rng(seed)
    seqs = BASES[rng.integers(0, 4, (n_reads, read_len), dtype=np.uint8)]
    if dup_frac > 0:
        src = rng.integers(0, n_reads, n_reads)
        dup = rng.random(n_reads) < dup_frac
        seqs = seqs[np.where(dup, src, np.arange(n_reads))]
    quals = rng.integers(33, 75, (n_reads, read_len), dtype=np.uint8)
    lens = None if min_len is None else \
        rng.integers(min_len, read_len + 1, n_reads)
    _plant(rng, [seqs], lens, hot, n_frac, adapter_frac)
    return fastq_records(illumina_names(n_reads, n_tiles, seed), seqs,
                         quals, lens)


def illumina_fastq_pair_fast(n_pairs: int, read_len: int = 100,
                             seed: int = 0, n_tiles: int = 96,
                             dup_frac: float = 0.0, hot: int = 0,
                             n_frac: float = 0.0, adapter_frac: float = 0.0,
                             min_len: int | None = None
                             ) -> tuple[bytes, bytes]:
    """The PE twin of illumina_fastq_fast: random_fastq_pair_fast's reads
    (the same draws), then the planted rows, under names that differ
    between the mates only in the mate number. With `min_len`, each mate
    draws its own lengths."""
    rng, seqs, quals = _pair_draws(n_pairs, read_len, seed, dup_frac)
    out = []
    lens = [None if min_len is None else
            rng.integers(min_len, read_len + 1, n_pairs) for _ in range(2)]
    _plant(rng, seqs, None, hot, 0.0, 0.0)
    for m in range(2):
        _plant(rng, [seqs[m]], lens[m], 0, n_frac, adapter_frac)
        out.append(fastq_records(illumina_names(n_pairs, n_tiles, seed,
                                                m + 1), seqs[m], quals[m],
                                 lens[m]))
    return out[0], out[1]


def with_n_calls(fastq: bytes, frac: float = 0.01, seed: int = 123) -> bytes:
    """A twin of `fastq` in which a `frac` share of the reads carry one N
    at a random cycle. Every record's sequence line starts one byte after
    its first newline, so the base to replace sits at a known offset."""
    data = np.frombuffer(fastq, dtype=np.uint8).copy()
    nl = np.flatnonzero(data == 0x0A)
    seq_start = nl[0::4] + 1
    seq_len = nl[1::4] - seq_start
    rng = np.random.default_rng(seed)
    rows = np.flatnonzero(rng.random(len(seq_start)) < frac)
    cycle = (rng.random(len(rows)) * seq_len[rows]).astype(np.int64)
    data[seq_start[rows] + cycle] = ord("N")
    return data.tobytes()
