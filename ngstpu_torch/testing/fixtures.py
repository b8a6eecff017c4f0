"""Seeded FASTQ inputs for the port's end-to-end checks."""

from __future__ import annotations

import numpy as np

from ngstpu.testing.fixtures import BASES


def fastq_text(prefix: bytes, seqs: np.ndarray, quals: np.ndarray) -> bytes:
    """FASTQ text of fixed-length reads named prefix + str(i), i from 0.

    Records whose names have the same number of digits have one length,
    so each such run is built as one [k, record] byte matrix: one copy of
    the output, with no per-record Python objects."""
    n, L = seqs.shape
    p = len(prefix)
    parts = []
    lo = 0
    while lo < n:
        nd = len(str(lo))
        hi = min(n, 10 ** nd)
        idx = np.arange(lo, hi)
        rec = np.empty((hi - lo, p + nd + 1 + L + 3 + L + 1), np.uint8)
        rec[:, :p] = np.frombuffer(prefix, np.uint8)
        for d in range(nd):
            rec[:, p + d] = ord("0") + idx // 10 ** (nd - 1 - d) % 10
        c = p + nd
        rec[:, c] = 0x0A
        rec[:, c + 1:c + 1 + L] = seqs[lo:hi]
        c += 1 + L
        rec[:, c:c + 3] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, c + 3:c + 3 + L] = quals[lo:hi]
        rec[:, -1] = 0x0A
        parts.append(rec.tobytes())
        lo = hi
    return b"".join(parts)


def random_fastq_fast(n_reads: int, read_len: int = 100, seed: int = 0,
                      name_prefix: str = "read",
                      dup_frac: float = 0.0) -> bytes:
    """ngstpu.testing.fixtures.random_fastq_fast, byte for byte (the same
    draws from the same generator), built by fastq_text."""
    rng = np.random.default_rng(seed)
    seqs = BASES[rng.integers(0, 4, (n_reads, read_len))]
    if dup_frac > 0:
        src = rng.integers(0, n_reads, n_reads)
        dup = rng.random(n_reads) < dup_frac
        seqs = seqs[np.where(dup, src, np.arange(n_reads))]
    quals = rng.integers(33, 75, (n_reads, read_len), dtype=np.uint8)
    return fastq_text(f"@{name_prefix}_".encode(), seqs, quals)


def random_fastq_pair_fast(n_pairs: int, read_len: int = 100, seed: int = 0,
                           dup_frac: float = 0.0) -> tuple[bytes, bytes]:
    """Two mate files of fixed-length pairs named @pair_i in both. One
    duplicate draw applies to both mates, so about `dup_frac` of the pairs
    repeat an earlier pair whole."""
    rng = np.random.default_rng(seed)
    seqs = [BASES[rng.integers(0, 4, (n_pairs, read_len))] for _ in range(2)]
    if dup_frac > 0:
        src = rng.integers(0, n_pairs, n_pairs)
        dup = rng.random(n_pairs) < dup_frac
        pick = np.where(dup, src, np.arange(n_pairs))
        seqs = [s[pick] for s in seqs]
    quals = [rng.integers(33, 75, (n_pairs, read_len), dtype=np.uint8)
             for _ in range(2)]
    return (fastq_text(b"@pair_", seqs[0], quals[0]),
            fastq_text(b"@pair_", seqs[1], quals[1]))


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
