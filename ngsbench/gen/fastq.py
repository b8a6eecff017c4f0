"""Seeded FASTQ lanes for the benchmark, made from a configuration file.

Frozen copies of the port's fixture generators (ngstpu_torch/testing/
fixtures.py: name_matrix, fastq_records, illumina_names, _plant),
so that later changes to the port do not move the inputs. Three departures,
each needed to make a configuration's numbers come out as it states them:

- Duplicates. The fixtures copy `dup_frac` of the rows from a source drawn
  over all rows, which leaves a unique share of 1 - p * exp(-p), never under
  63%. Here n - round(dup_frac * n) distinct reads (pairs) are drawn and
  the N calls and adapters planted in them; the other rows copy one of
  them, or one of the hot sequences, and the rows are shuffled. So a file
  holds exactly n - round(dup_frac * n) + hot distinct reads (pairs): the
  unique share that the configuration states, planting included.
- Qualities follow the configuration's model: uniform over an ASCII range,
  or binned values with given shares.
- Tile numbers follow the configuration's flow cell: surface * 1000 +
  swath * 100 + tile, over surfaces x swaths x tiles per swath.

The same configuration, read count and seed give the same bytes.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# FastQC's shipped adapter list (Configuration/adapter_list.txt upstream)
ADAPTERS = (b"AGATCGGAAGAG", b"TGGAATTCTCGG", b"GATCGTCGGACT",
            b"CTGTCTCTTATA", b"CGCCTTGGCCGT")
ADAPTER_BYTES = np.frombuffer(b"".join(ADAPTERS), np.uint8).reshape(
    len(ADAPTERS), -1)
HOT_SHARE = 0.002  # reads per hot sequence: above FastQC's 0.1% threshold
_BLOCK = 1 << 20  # rows per block when writing a file


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of draws; any whole seed, negative too."""
    return np.random.default_rng([seed % (1 << 64), *stream])


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


def fastq_records(names: np.ndarray, seqs: np.ndarray,
                  quals: np.ndarray) -> bytes:
    """FASTQ text from uint8 names [n, W] and reads [n, L], built as one
    [n, record] byte matrix."""
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
    return rec.tobytes()


def tile_numbers(n: int, flowcell: dict) -> np.ndarray:
    """Tile number of each of n reads in lane order: read i on tile ordinal
    i * T // n, ordinals running surface fastest, then tile, then swath,
    as illumina_names numbers them."""
    s, w, t = (flowcell["surfaces"], flowcell["swaths"],
               flowcell["tiles_per_swath"])
    if not (0 < s <= 9 and 0 < w <= 9 and 0 < t <= 99):
        raise ValueError(f"flow cell out of range: {flowcell}")
    o = np.arange(n, dtype=np.int64) * (s * w * t) // max(n, 1)
    return ((1 + o % s) * 1000 + (1 + o // s // t) * 100
            + 1 + o // s % t)


def illumina_names(n: int, flowcell: dict, prefix: bytes, rng,
                   mate: int = 1) -> np.ndarray:
    """uint8 [n, W] CASAVA 1.8 names, prefix + {tile}:{x}:{y} {mate}:N:0:1,
    with 5-digit x and y drawn from `rng` (the same draws give both mates
    the same coordinates)."""
    return name_matrix(n, [prefix, (tile_numbers(n, flowcell), 4), b":",
                           (rng.integers(10000, 32768, n), 5), b":",
                           (rng.integers(10000, 37000, n), 5),
                           b" %d:N:0:1" % mate])


def draw_quals(rng, shape: tuple, model: dict) -> np.ndarray:
    """uint8 qualities: "uniform" over ASCII lo..hi, or "binned" values
    with their shares (to a thousandth)."""
    if model["kind"] == "uniform":
        return rng.integers(model["lo"], model["hi"] + 1, shape,
                            dtype=np.uint8)
    if model["kind"] == "binned":
        per_mille = [round(s * 1000) for s in model["shares"]]
        if sum(per_mille) != 1000 or len(per_mille) != len(model["values"]):
            raise ValueError(f"binned shares must sum to 1: {model}")
        lut = np.repeat(np.frombuffer(model["values"].encode(), np.uint8),
                        per_mille)
        return lut[rng.integers(0, 1000, shape, dtype=np.uint16)]
    raise ValueError(f"unknown quality model {model['kind']!r}")


def draw_reads(rng, n: int, L: int, mates: int, cfg: dict) -> list:
    """`mates` uint8 [n, L] matrices whose rows (pairs) hold exactly
    n - round(dup_frac * n) distinct reads with N calls and adapters
    planted, and `hot` hot sequences (pairs) that each take about
    HOT_SHARE of the rows from the copies; the rest copy a distinct read.
    Rows shuffled."""
    n_dup = int(round(cfg["dup_frac"] * n))
    n_uniq = n - n_dup
    hot = cfg["hot"]
    base = [BASES[rng.integers(0, 4, (n_uniq + hot, L), dtype=np.uint8)]
            for _ in range(mates)]
    for b in base:
        _plant(rng, b[:n_uniq], cfg["n_frac"], cfg["adapter_frac"])
    src = rng.integers(0, max(n_uniq, 1), n_dup)
    n_hot = min(int(rng.binomial(n, hot * HOT_SHARE)), n_dup)
    src[:n_hot] = n_uniq + rng.integers(0, max(hot, 1), n_hot)
    src = np.concatenate([np.arange(n_uniq), src])[rng.permutation(n)]
    return [b[src] for b in base]


def _plant(rng, s: np.ndarray, n_frac: float, adapter_frac: float) -> None:
    """In place, in the reads [n, L] of one mate: one N at a random cycle
    in an `n_frac` share of them and one of FastQC's adapters at a random
    offset in an `adapter_frac` share."""
    n, L = s.shape
    k = ADAPTER_BYTES.shape[1]
    ln = np.full(n, L)
    rows = np.flatnonzero(rng.random(n) < n_frac)
    s[rows, (rng.random(len(rows)) * ln[rows]).astype(np.int64)] = ord("N")
    rows = np.flatnonzero((rng.random(n) < adapter_frac) & (ln >= k))
    off = (rng.random(len(rows)) * (ln[rows] - k + 1)).astype(np.int64)
    ad = ADAPTER_BYTES[rng.integers(0, len(ADAPTER_BYTES), len(rows))]
    for j in range(k):
        s[rows, off + j] = ad[:, j]


def make_set(cfg: dict, n: int, seed: int, index: int = 0) -> list[dict]:
    """One input set of the configuration: a dict per mate with names,
    seqs and quals (uint8 matrices; every read read_len long). Set
    `index` of a traffic mix draws from its own stream of the seed."""
    mates = 2 if cfg["layout"] == "PE" else 1
    L = cfg["read_len"]
    rng = rng_for(seed, index)
    seqs = draw_reads(rng, n, L, mates, cfg)
    quals = [draw_quals(rng, (n, L), cfg["quality"]) for _ in range(mates)]
    prefix = cfg["names"]["prefix"].encode()
    out = []
    for m in range(mates):
        names = illumina_names(n, cfg["names"]["flowcell"], prefix,
                               rng_for(seed, index, 1), m + 1)
        out.append(dict(names=names, seqs=seqs[m], quals=quals[m]))
    return out


def write_fastq(path, mate: dict) -> tuple[int, int]:
    """Writes one mate's records in row blocks; returns (reads, bases)."""
    names, seqs, quals = mate["names"], mate["seqs"], mate["quals"]
    n = len(seqs)
    with open(path, "wb") as f:
        for lo in range(0, n, _BLOCK):
            hi = min(lo + _BLOCK, n)
            f.write(fastq_records(names[lo:hi], seqs[lo:hi], quals[lo:hi]))
    return n, seqs.size


def write_set(cfg: dict, n: int, seed: int, index: int, paths) -> list:
    """make_set written to `paths` (one per mate); returns [(reads, bases)]
    per mate. The matrices are dropped before it returns."""
    return [write_fastq(p, m) for p, m in zip(paths, make_set(cfg, n, seed,
                                                                 index))]


# BGZF (the SAM/BAM format specification, section 4.1): gzip members that
# each carry a BC extra field with the member's size less one, at most
# 64 KiB a member, and an empty member at the end. A member takes 0xff00
# input bytes, as htslib's bgzf.c fills them.
BGZF_BLOCK = 0xFF00
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_BGZF_HEAD = struct.Struct("<4BI2BH2BHH")


def bgzf_file(src: str, dst: str, level: int) -> int:
    """Compresses `src` into `dst` as BGZF at zlib `level`, the layout in
    which bcl2fastq2 writes its .fastq.gz by default: mtime 0 and no file
    name in any member (the same bytes in give the same bytes out). Syncs
    `dst` to disk, deletes `src` and returns the compressed size."""
    with open(src, "rb") as f:
        data = memoryview(f.read())
    with open(dst, "wb") as out:
        for lo in range(0, len(data), BGZF_BLOCK):
            block = data[lo:lo + BGZF_BLOCK]
            z = zlib.compressobj(level, zlib.DEFLATED, -15)
            body = z.compress(block) + z.flush()
            # BSIZE, the member's size less one, packs as 16 bits or
            # raises: no member passes the format's 64 KiB
            bsize = _BGZF_HEAD.size + len(body) + 8 - 1
            out.write(_BGZF_HEAD.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                                      ord("B"), ord("C"), 2, bsize))
            out.write(body)
            out.write(struct.pack("<II", zlib.crc32(block), len(block)))
        out.write(BGZF_EOF)
        out.flush()
        os.fsync(out.fileno())
        size = out.tell()
    os.unlink(src)
    return size
