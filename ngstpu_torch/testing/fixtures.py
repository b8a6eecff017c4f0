"""Seeded FASTQ inputs for the port's end-to-end checks."""

from __future__ import annotations

import numpy as np

from ngstpu.testing.fixtures import random_fastq_fast  # noqa: F401


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
