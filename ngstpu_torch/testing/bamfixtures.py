"""Synthetic BAM fixture writer for differential tests.

Builds coordinate-sorted BAM files from scratch (header + records + BGZF)
so the compiled reference tools and the port read identical inputs.
The tests and chip_smoke.py index them with the port's own `index` tool
(io/bai.write_bai).
"""

from __future__ import annotations

import struct

import numpy as np

from ..io.bai import reg2bin, reg2bin_vec
from ..io.bam import BamHeader, write_bam

SEQ_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
CIGAR_OP_CODE = {c: i for i, c in enumerate("MIDNSHP=X")}


def parse_cigar(cigar: str) -> list[tuple[int, int]]:
    ops = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            ops.append((int(num), CIGAR_OP_CODE[ch]))
            num = ""
    return ops


def ref_span(cigar_ops: list[tuple[int, int]]) -> int:
    # ops that consume reference: M, D, N, =, X
    return sum(l for l, op in cigar_ops if op in (0, 2, 3, 7, 8))


def encode_record(name: str, tid: int, pos: int, mapq: int, cigar: str,
                  seq: str, qual: bytes | None = None, flag: int = 0) -> bytes:
    ops = parse_cigar(cigar) if cigar else []
    l_seq = len(seq)
    if qual is None:
        qual = bytes([30] * l_seq)
    nb = name.encode() + b"\x00"
    end = pos + max(ref_span(ops), 1)
    rec = struct.pack("<iiBBHHHiiii", tid, pos, len(nb), mapq,
                      reg2bin(pos, end), len(ops), flag, l_seq, -1, -1, 0)
    rec += nb
    for l, op in ops:
        rec += struct.pack("<I", (l << 4) | op)
    packed = bytearray()
    for i in range(0, l_seq, 2):
        hi = SEQ_CODE.get(seq[i], 15) << 4
        lo = SEQ_CODE.get(seq[i + 1], 15) if i + 1 < l_seq else 0
        packed.append(hi | lo)
    rec += bytes(packed) + qual
    return struct.pack("<I", len(rec)) + rec


def make_bam(path: str, refs: list[tuple[str, int]], records: list[bytes],
             sam_text: str | None = None) -> None:
    if sam_text is None:
        sam_text = "@HD\tVN:1.0\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs)
    header = BamHeader(text=sam_text.encode(),
                       ref_names=[n for n, _ in refs],
                       ref_lens=[l for _, l in refs])
    write_bam(path, header, b"".join(records))


def random_bam(path: str, refs: list[tuple[str, int]], n_reads: int,
               seed: int = 0, read_len: int = 100, with_cigar_mix: bool = True,
               flag_frac: float = 0.1) -> None:
    """Coordinate-sorted random BAM touching all chromosomes."""
    rng = np.random.default_rng(seed)
    recs = []
    per_ref: list[list[bytes]] = [[] for _ in refs]
    for i in range(n_reads):
        tid = int(rng.integers(0, len(refs)))
        tlen = refs[tid][1]
        pos = int(rng.integers(0, max(tlen - read_len - 60, 1)))
        if with_cigar_mix and rng.random() < 0.4:
            a = int(rng.integers(10, read_len - 20))
            kind = rng.random()
            if kind < 0.4:
                cigar = f"{a}M{int(rng.integers(1, 30))}D{read_len - a}M"
            elif kind < 0.7:
                cigar = f"{a}M{int(rng.integers(1, 10))}I{read_len - a - int(rng.integers(1, 10))}M"
                # keep it simple: recompute below
                ins = int(rng.integers(1, 10))
                cigar = f"{a}M{ins}I{read_len - a - ins}M"
            else:
                cigar = f"{a}M{int(rng.integers(20, 60))}N{read_len - a}M"
        else:
            cigar = f"{read_len}M"
        flag = 0
        r = rng.random()
        if r < flag_frac:
            flag = int(rng.choice([0x4, 0x100, 0x200, 0x400, 0x10]))
        seq = "".join(rng.choice(list("ACGT"), read_len))
        per_ref[tid].append((pos, encode_record(
            f"r{i:06d}", tid, pos, 60, cigar, seq, flag=flag)))
    for tid in range(len(refs)):
        for pos, rec in sorted(per_ref[tid], key=lambda t: t[0]):
            recs.append(rec)
    make_bam(path, refs, recs)


def random_bam_fast(path: str, refs: list[tuple[str, int]], n_reads: int,
                    seed: int = 0, read_len: int = 100,
                    mix_frac: float = 0.3, flag_frac: float = 0.1) -> None:
    """Vectorized coordinate-sorted random BAM for WGS-scale fixtures.

    Same record shapes as random_bam (flag mix, M-only and M/D/M cigars)
    but assembled with numpy column writes — ~1000x faster than the
    per-read encode_record loop, practical at 10M+ reads x Gbp genomes.

    The bytes are those of the JAX package's random_bam_fast for the same
    arguments (the same draws in the same order), built with less memory
    traffic: every record is a row of one [n_reads, widest record] matrix
    whose M-only rows drop their two unused cigar words when the matrix
    is compacted, and the per-base draws come in blocks of rows instead
    of two int64 [n_reads, read_len] arrays.
    """
    rng = np.random.default_rng(seed)
    L = int(read_len)
    n_refs = len(refs)
    ref_lens = np.array([l for _, l in refs], np.int64)

    tid = rng.integers(0, n_refs, n_reads).astype(np.int64)
    span = np.maximum(ref_lens[tid] - L - 64, 1)
    pos = (rng.random(n_reads) * span).astype(np.int64)
    order = np.lexsort((pos, tid))
    tid, pos = tid[order], pos[order]

    is_mix = rng.random(n_reads) < mix_frac
    a_op = rng.integers(10, max(L - 20, 11), n_reads)
    d_op = rng.integers(1, 31, n_reads)
    flag = np.zeros(n_reads, np.int64)
    f_hit = rng.random(n_reads) < flag_frac
    flag[f_hit] = rng.choice([0x4, 0x100, 0x200, 0x400, 0x10],
                             int(f_hit.sum()))

    ref_end = pos + np.where(is_mix, L + d_op, L)
    name_len = 10  # "r" + 8 digits + NUL
    seq_b = (L + 1) // 2
    n_ops = np.where(is_mix, 3, 1)
    rec_size = 4 + 32 + name_len + 4 * n_ops + seq_b + L
    hdr = np.zeros(n_reads, np.dtype([
        ("block_size", "<i4"), ("tid", "<i4"), ("pos", "<i4"),
        ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
        ("n_cigar_op", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
        ("next_refID", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4")]))
    hdr["block_size"] = rec_size - 4
    hdr["tid"] = tid
    hdr["pos"] = pos
    hdr["l_read_name"] = name_len
    hdr["mapq"] = 60
    hdr["bin"] = reg2bin_vec(pos, ref_end)
    hdr["n_cigar_op"] = n_ops
    hdr["flag"] = flag
    hdr["l_seq"] = L
    hdr["next_refID"] = -1
    hdr["next_pos"] = -1
    c0 = hdr.itemsize + name_len
    s0 = c0 + 12  # after the widest (3-op) cigar
    q0 = s0 + seq_b
    rows = np.zeros((n_reads, q0 + L), np.uint8)
    rows[:, :c0 - name_len] = hdr.view(np.uint8).reshape(n_reads, -1)
    del hdr
    # name "r%08d" by sorted ordinal
    idx = np.arange(n_reads, dtype=np.int64)
    rows[:, c0 - name_len] = ord("r")
    for k in range(8):
        rows[:, c0 - name_len + 1 + k] = (idx // 10 ** (7 - k)) % 10 + 48
    cigar = np.empty((n_reads, 3), "<i4")
    cigar[:, 0] = np.where(is_mix, a_op << 4, L << 4)
    cigar[:, 1] = (d_op << 4) | 2
    cigar[:, 2] = (L - a_op) << 4
    rows[:, c0:s0] = cigar.view(np.uint8).reshape(n_reads, 12)
    del cigar
    # seq (4-bit codes) + qual, random; each drawn in row blocks, in the
    # order and with the dtype of the one-array draws
    lut = np.array([1, 2, 4, 8], np.uint8)  # A C G T
    block = 1 << 16
    for lo in range(0, n_reads, block):
        hi = min(lo + block, n_reads)
        codes = lut[rng.integers(0, 4, (hi - lo, L)).astype(np.int8)]
        packed = codes[:, 0::2] << 4
        packed[:, : L // 2] |= codes[:, 1::2]
        rows[lo:hi, s0:q0] = packed
    for lo in range(0, n_reads, block):
        hi = min(lo + block, n_reads)
        rows[lo:hi, q0:] = rng.integers(20, 41, (hi - lo, L))
    # M-only records keep one cigar word: drop the other two
    keep = np.ones(rows.shape, bool)
    keep[~is_mix, c0 + 4:s0] = False
    out = rows[keep]
    del rows, keep

    sam_text = "@HD\tVN:1.0\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs)
    header = BamHeader(text=sam_text.encode(),
                       ref_names=[n for n, _ in refs],
                       ref_lens=[int(l) for _, l in refs])
    write_bam(path, header, out.tobytes())
