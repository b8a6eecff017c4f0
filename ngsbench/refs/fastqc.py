"""Plain reference of `fastqc`: every TSV it writes, worked out with numpy
from the FASTQ files alone.

It imports nothing of the program. The report's rules, written down here
from the tool's documented output (FastQC's modules as Rfastqc.R and the
upstream's Rgzfastq_uniq.c define them):

- Cycle columns run to the longest read rounded up to a multiple of 128
  (at least 128); the quality and nucleotide matrices, the N content and
  the length table stop at 300 cycles.
- Quality: reads per (quality byte 0..127, cycle). Nucleotide: rows T, C,
  A, G, N per cycle; C, A, G count either case, N counts 'N' and '.', T
  every other base of a read. Length: reads per length 1..300.
- GC: each read's G and C (upper case) over its length in float32; the
  mean of those as numpy's float32 mean gives it, and their histogram in
  100 bins over [0, 1].
- N content: the N row over the bases at each cycle, in percent.
- Adapters: reads whose first exact match of an adapter starts at or
  before each cycle, in percent of the reads.
- Per tile: every 10th read from the first (every read under 20,000);
  the tile is field 5 of a CASAVA 1.8 name (7 or more ':' fields) or
  field 3 (5 or 6); each tile's mean Phred score at each cycle less the
  mean over all tiles. No file when a name carries no tile.
- K-mers: 7-mers of ACGT only, every 50th read from the first (every read
  under 5,000), counted per start position; expected at p is
  total * (windows at p / all windows); the 20 k-mers of count 10 or more
  with the highest obs/exp of at least 5, highest first, ties to the
  larger k-mer.
- Duplication: reads grouped by their key (the first 50 bases of a read
  over 75, else the whole read; the two mates' keys joined for a pair).
  Overrepresented: the keys in more than 0.1% of the reads (and at least
  2), most frequent first, ties to the larger key, at most 20.

The counting runs as plain torch operations on the device it is given (the
card, once the program's run is over; the CPU in the tests), the parsing
and the report text in numpy and Python.

`expected(paths, device)` returns the text of every file under its name
suffix; `compare(expected, prefix)` counts, per kind of file, the lines of
the program's files that differ from it. `expected(paths, device, 2)` is
the control: the same report from every second read, counts doubled, which
breaks the configuration's guarantee that every read is counted.
"""

from __future__ import annotations

import gzip

import numpy as np
import torch

MAX_LEN = 300
PAD = 128
KMER_K = 7
ADAPTERS = (("Illumina Universal Adapter", b"AGATCGGAAGAG"),
            ("Illumina Small RNA 3' Adapter", b"TGGAATTCTCGG"),
            ("Illumina Small RNA 5' Adapter", b"GATCGTCGGACT"),
            ("Nextera Transposase Sequence", b"CTGTCTCTTATA"),
            ("SOLID Small RNA Adapter", b"CGCCTTGGCCGT"))
MATE_KINDS = ("quality", "nucleotide", "length", "gc", "adapter",
              "ncontent", "per_tile", "kmer")
PAIR_KINDS = ("duplication", "overrepresented")
KINDS = MATE_KINDS + PAIR_KINDS
LIMITS = {k: 0 for k in KINDS}  # every count is exact, every format fixed
_ROWS = 1 << 18  # rows per block of device work


class Fastq:
    """One FASTQ file, plain or gzip (by its first two bytes): its reads as
    zero-padded byte matrices on `device` (qualities padded with 255,
    which no count takes), their lengths, and the name lines. `sample`
    keeps every sample-th record."""

    def __init__(self, path: str, device, sample: int = 1):
        with open(path, "rb") as f:
            gz = f.read(2) == b"\x1f\x8b"
        if gz:
            with gzip.open(path, "rb") as f:
                data = np.frombuffer(f.read(), np.uint8)
        else:
            data = np.fromfile(path, np.uint8)
        if len(data) and data[-1] != 0x0A:
            data = np.append(data, np.uint8(0x0A))
        ends = np.flatnonzero(data == 0x0A)
        if len(ends) % 4:
            raise ValueError(f"{path}: {len(ends)} lines, not records of 4")
        starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
        rows = np.arange(0, len(ends) // 4, sample)
        self.n = len(rows)
        self.lens = (ends[4 * rows + 1] - starts[4 * rows + 1]).astype(
            np.int64)
        top = int(self.lens.max(initial=0))
        self.width = max(-(-max(top, 1) // PAD) * PAD, PAD)
        self.names = _lines(data, starts[4 * rows], ends[4 * rows], 0)
        self.seq = torch.from_numpy(_lines(
            data, starts[4 * rows + 1], ends[4 * rows + 1], 0,
            self.width)).to(device)
        self.qual = torch.from_numpy(_lines(
            data, starts[4 * rows + 3], ends[4 * rows + 3], 255,
            self.width)).to(device)
        self.lens_t = torch.from_numpy(self.lens).to(device)


def _lines(data, first, end, pad: int, width: int | None = None):
    """uint8 [rows, width] of the lines data[first:end], padded."""
    lens = end - first
    top = int(lens.max(initial=0))
    width = top if width is None else width
    out = np.full((len(first), width), pad, np.uint8)
    if len(first) > 1 and (lens == top).all() and \
            (np.diff(first) == first[1] - first[0]).all():
        # lines of one size at one stride: a strided view of the bytes
        view = np.lib.stride_tricks.as_strided(
            data[first[0]:], (len(first), top), (first[1] - first[0], 1))
        out[:, :top] = view
        return out
    col = np.arange(width)
    for lo in range(0, len(first), _ROWS):
        hi = min(lo + _ROWS, len(first))
        live = col[None, :] < lens[lo:hi, None]
        out[lo:hi][live] = data[(first[lo:hi, None] + col[None, :])[live]]
    return out


def _per_cycle_bytes(mat: torch.Tensor) -> np.ndarray:
    """[W, 256] counts of each byte value at each cycle."""
    n, W = mat.shape
    off = torch.arange(W, device=mat.device, dtype=torch.int64) * 256
    out = torch.zeros(W * 256, dtype=torch.int64, device=mat.device)
    for lo in range(0, n, _ROWS):
        idx = mat[lo:lo + _ROWS].to(torch.int64) + off
        out += torch.bincount(idx.view(-1), minlength=W * 256)
    return out.view(W, 256).cpu().numpy()


def _matrix_tsv(mat, row_names=None) -> str:
    lines = ["#" + "\t".join(str(c + 1) for c in range(mat.shape[1]))]
    for r in range(mat.shape[0]):
        name = row_names[r] if row_names else str(r)
        lines.append(name + "\t" + "\t".join(str(int(v)) for v in mat[r]))
    return "\n".join(lines) + "\n"


def _first_adapter_hits(fq: Fastq, adapter: bytes) -> np.ndarray:
    """Each read's first exact match position of `adapter` (width: none).
    The padding is no base, so a match lies inside the read."""
    k, W = len(adapter), fq.width
    first = torch.full((fq.n,), W, dtype=torch.int64, device=fq.seq.device)
    if k > W:
        return first.cpu().numpy()
    for lo in range(0, fq.n, _ROWS):
        s = fq.seq[lo:lo + _ROWS]
        m = s[:, :W - k + 1] == adapter[0]
        for j in range(1, k):
            m &= s[:, j:W - k + 1 + j] == adapter[j]
        hit = m.any(dim=1)
        at = m.to(torch.uint8).argmax(dim=1)  # the first of the maxima
        first[lo:lo + _ROWS] = torch.where(hit, at, W)
    return first.cpu().numpy()


def _tiles(fq: Fastq):
    """(rows, tile ordinals, sorted tiles) of the per-tile sample, or None
    when a name carries no tile."""
    rows = np.arange(0, fq.n, 10 if fq.n >= 20000 else 1)
    if len(rows) == 0:
        return None
    names = fq.names[rows]
    # the id ends at the first space or tab; its fields are split at ':'
    end = np.where((names == 0x20) | (names == 0x09) | (names == 0),
                   np.arange(names.shape[1]), names.shape[1]).min(axis=1)
    col = np.arange(names.shape[1])[None, :]
    colon = (names == ord(":")) & (col < end[:, None])
    n_fields = colon.sum(axis=1) + 1
    field = np.where(n_fields >= 7, 4, 2)
    if (n_fields < 5).any():
        return None
    which = np.cumsum(colon, axis=1) - colon  # field of each byte
    inside = (which == field[:, None]) & ~colon & (col < end[:, None])
    digit = (names >= ord("0")) & (names <= ord("9"))
    if (inside & ~digit).any() or not inside.any(axis=1).all():
        # not plain digits: read the field as Python's int() would
        tiles = []
        for i in range(len(rows)):
            head = names[i, :end[i]].tobytes()
            try:
                tiles.append(int(head.split(b":")[field[i]]))
            except ValueError:
                return None
        tiles = np.asarray(tiles, np.int64)
    else:
        val = np.where(inside, names.astype(np.int64) - ord("0"), 0)
        tiles = np.zeros(len(rows), np.int64)
        for c in range(names.shape[1]):
            tiles = np.where(inside[:, c], tiles * 10 + val[:, c], tiles)
    uniq = np.unique(tiles)
    if len(uniq) > 2048:
        return None
    return rows, np.searchsorted(uniq, tiles), [int(t) for t in uniq]


def _kmer_counts(fq: Fastq) -> np.ndarray:
    """[W, 4**7] counts of each ACGT 7-mer at each start position."""
    dev = fq.seq.device
    rows = torch.arange(0, fq.n, 50 if fq.n >= 5000 else 1, device=dev)
    seq, lens = fq.seq[rows], fq.lens_t[rows]
    W, n_k = fq.width, 4 ** KMER_K
    code = torch.full(seq.shape, 4, dtype=torch.int64, device=dev)
    for v, ch in enumerate(b"ACGT"):
        code[seq == ch] = v
    P = W - KMER_K + 1
    ids = torch.zeros((len(rows), P), dtype=torch.int64, device=dev)
    ok = torch.arange(P, device=dev)[None, :] + KMER_K <= lens[:, None]
    for j in range(KMER_K):
        ok &= code[:, j:j + P] < 4
        ids = ids * 4 + code[:, j:j + P] % 4
    cell = torch.arange(P, device=dev)[None, :] * n_k + ids
    out = torch.bincount(cell[ok], minlength=W * n_k)
    return out.view(W, n_k).cpu().numpy()


def _kmer_rows(counts: np.ndarray) -> list:
    totals = counts.sum(axis=0)
    win = counts.sum(axis=1)
    all_win = win.sum()
    if all_win == 0:
        return []
    kids = np.flatnonzero(totals >= 10)
    exp = totals[None, kids] * (win / all_win)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(exp > 0, counts[:, kids] / exp, 0.0)
    pos = ratio.argmax(axis=0)
    best = ratio[pos, np.arange(len(kids))]
    rows = sorted(((float(best[j]), int(kids[j]), int(totals[kids[j]]),
                    int(pos[j]) + 1) for j in np.flatnonzero(best >= 5.0)),
                  reverse=True)
    out = []
    for ratio_, kid, total, p in rows[:20]:
        km = "".join("ACGT"[(kid >> 2 * (KMER_K - 1 - j)) & 3]
                     for j in range(KMER_K))
        out.append(f"{km}\t{total}\t{ratio_:.3f}\t{p}")
    return out


def mate_files(fq: Fastq, idx: int, scale: int = 1) -> dict[str, str]:
    """Every per-mate TSV of one mate, under its name suffix."""
    W, n = fq.width, fq.n
    L = min(W, MAX_LEN)
    files = {}
    qcnt = _per_cycle_bytes(fq.qual)[:, :128] * scale  # [W, 128]
    qmat = np.zeros((128, MAX_LEN), np.int64)
    qmat[:, :L] = qcnt[:L].T
    files[f"_quality_mate{idx}.tsv"] = _matrix_tsv(qmat)

    scnt = _per_cycle_bytes(fq.seq) * scale
    short = np.cumsum(np.bincount(np.minimum(fq.lens, W), minlength=W + 1))
    covered = (n - short[:W]) * scale  # reads with a base at each cycle
    c_, a_, g_ = (scnt[:, ord(u)] + scnt[:, ord(u.lower())] for u in "CAG")
    n_ = scnt[:, ord("N")] + scnt[:, ord(".")]
    t_ = covered - c_ - a_ - g_ - n_
    nmat = np.zeros((5, MAX_LEN), np.int64)
    nmat[:, :L] = np.stack([t_, c_, a_, g_, n_])[:, :L]
    files[f"_nucleotide_mate{idx}.tsv"] = _matrix_tsv(nmat, list("TCAGN"))

    lh = np.bincount(fq.lens, minlength=MAX_LEN + 1)[1:MAX_LEN + 1] * scale
    files[f"_length_mate{idx}.tsv"] = "".join(
        f"{i + 1}\t{int(v)}\n" for i, v in enumerate(lh) if v)

    n_gc = torch.cat([((s == ord("G")) | (s == ord("C"))).sum(dim=1)
                      for s in fq.seq.split(_ROWS)]).cpu().numpy() \
        if n else np.zeros(0, np.int64)  # the padding is no G or C
    gc = n_gc.astype(np.float32) / np.maximum(fq.lens, 1).astype(np.float32)
    hist, _ = np.histogram(gc, bins=100, range=(0, 1))
    files[f"_gc_mate{idx}.tsv"] = (
        f"#mean_gc\t{float(gc.mean()) * 100:.6f}\n"
        + "".join(f"{i / 100:.2f}\t{int(v) * scale}\n"
                  for i, v in enumerate(hist)))

    lines = ["#cycle\t" + "\t".join(name for name, _ in ADAPTERS)]
    cum = [np.cumsum(np.bincount(_first_adapter_hits(fq, ad),
                                 minlength=W + 1)[:W]) * scale
           for _, ad in ADAPTERS]
    reads = max(n * scale, 1)
    for i in range(W):
        lines.append(f"{i + 1}\t" + "\t".join(
            f"{c[i] * 100.0 / reads:.4f}" for c in cum))
    files[f"_adapter_mate{idx}.tsv"] = "\n".join(lines) + "\n"

    files[f"_ncontent_mate{idx}.tsv"] = "#cycle\tn_pct\n" + "".join(
        f"{i + 1}\t{nmat[4, i] * 100.0 / covered[i]:.4f}\n"
        for i in range(L) if covered[i])

    tiles = _tiles(fq)
    if tiles is not None:
        rows, ords, uniq = tiles
        T, dev = len(uniq), fq.seq.device
        r = torch.from_numpy(rows).to(dev)
        col = torch.arange(W, device=dev)
        ok = col[None, :] < fq.lens_t[r, None]
        cell = torch.from_numpy(ords).to(dev)[:, None] * W + col[None, :]
        cell = torch.where(ok, cell, T * W)  # cells past a read: spare bin
        phred = (fq.qual[r].to(torch.int64) - 33) * ok
        sums = torch.zeros(T * W + 1, dtype=torch.int64, device=dev)
        sums.index_add_(0, cell.view(-1), phred.view(-1))
        cnts = torch.bincount(cell.view(-1), minlength=T * W + 1)
        sums = sums[:T * W].view(T, W).cpu().numpy()
        cnts = cnts[:T * W].view(T, W).cpu().numpy()
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.where(cnts > 0, sums / np.maximum(cnts, 1), 0.0)
            g_cnt = cnts.sum(axis=0)
            g_mean = np.where(g_cnt > 0,
                              sums.sum(axis=0) / np.maximum(g_cnt, 1), 0.0)
        dev_ = np.where(cnts > 0, mean - g_mean[None, :], 0.0)
        files[f"_per_tile_mate{idx}.tsv"] = (
            "#tile\\cycle\t" + "\t".join(str(c + 1) for c in range(W))
            + "\n" + "".join(f"{tile}\t" + "\t".join(
                f"{dev_[t, c]:.3f}" for c in range(W)) + "\n"
                for t, tile in enumerate(uniq)))

    files[f"_kmer_mate{idx}.tsv"] = "\n".join(
        ["#kmer\tcount\tmax_obs_exp\tposition"]
        + _kmer_rows(_kmer_counts(fq) * scale)) + "\n"
    return files


def _keys(mates: list) -> tuple[torch.Tensor, np.ndarray]:
    """Each read's (pair's) duplication key, zero-padded, and its length."""
    dev = mates[0].seq.device
    kls = [np.where(fq.lens > 75, 50, fq.lens) for fq in mates]
    total = sum(kls)
    n, width = mates[0].n, int(total.max(initial=1))
    if all((kl == kl[:1]).all() for kl in kls):  # keys of one length
        return torch.cat([fq.seq[:, :int(kl[0]) if n else 0]
                          for fq, kl in zip(mates, kls)], dim=1), total
    key = torch.zeros((n, width), dtype=torch.uint8, device=dev)
    at = torch.zeros(n, dtype=torch.int64, device=dev)
    for fq, kl in zip(mates, kls):
        kl_t = torch.from_numpy(kl).to(dev)
        for c in range(int(kl.max(initial=0))):
            rows = torch.nonzero(kl_t > c).view(-1)
            key[rows, at[rows] + c] = fq.seq[rows, c]
        at += kl_t
    return key, total


def _groups(key: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(size of each group of equal keys, one row of each), groups in
    ascending key order. Each byte becomes its rank among the bytes
    present (0 stays lowest), packed into 63-bit words that sort as the
    bytes do; stable sorts from the last word to the first order them."""
    n, width = key.shape
    dev = key.device
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    present = torch.nonzero(torch.bincount(key.reshape(-1).to(torch.int64),
                                           minlength=256)).view(-1)
    rank = torch.zeros(256, dtype=torch.int64, device=dev)
    rank[present] = torch.arange(len(present), device=dev)
    bits = max(int(len(present) - 1).bit_length(), 1)
    per = 63 // bits
    words = []
    for lo in range(0, width, per):
        w = torch.zeros(n, dtype=torch.int64, device=dev)
        for c in range(lo, lo + per):
            w <<= bits
            if c < width:
                w |= rank[key[:, c].to(torch.int64)]
        words.append(w)
    order = torch.arange(n, device=dev)
    for w in reversed(words):
        order = order[torch.sort(w[order], stable=True).indices]
    head = torch.zeros(n, dtype=torch.bool, device=dev)
    head[0] = True
    for w in words:
        sw = w[order]
        head[1:] |= sw[1:] != sw[:-1]
    starts = torch.nonzero(head).view(-1)
    sizes = torch.diff(starts, append=torch.tensor([n], device=dev))
    return sizes.cpu().numpy(), order[starts].cpu().numpy()


def pair_files(mates: list, scale: int = 1) -> dict[str, str]:
    """The duplication and overrepresented TSVs over the reads (pairs)."""
    n = mates[0].n * scale
    key, klen = _keys(mates)
    sizes, rep = _groups(key)
    sizes = sizes * scale
    dups = np.sort(sizes)[::-1]
    levels = np.bincount(np.minimum(dups, 100))
    uniq_pct = (len(dups) / n * 100) if n else 0.0
    dup = f"#unique_reads\t{len(dups)}\t{uniq_pct:.3f}%\n" + "".join(
        f"{lvl}\t{int(levels[lvl])}\n" for lvl in range(1, len(levels))
        if levels[lvl])
    rows = []
    if n:
        min_count = max(int(np.floor(0.001 * n)) + 1, 2)
        hot = [(int(sizes[g]),
                key[int(rep[g]), :klen[rep[g]]].cpu().numpy().tobytes())
               for g in np.flatnonzero(sizes >= min_count)]
        hot.sort(reverse=True)
        rows = [f"{s.decode('latin-1')}\t{c}\t{c * 100.0 / n:.4f}\n"
                for c, s in hot[:20]]
    over = "#sequence\tcount\tpercentage\n" + "".join(rows)
    return {"_duplication.tsv": dup, "_overrepresented.tsv": over}


def expected(paths: list, device="cpu", sample: int = 1) -> dict[str, str]:
    """Every TSV of `fastqc <prefix> paths...`, by name suffix. sample > 1
    is the control: every sample-th read, counts scaled by sample."""
    mates = [Fastq(p, device, sample) for p in paths]
    if len(mates) == 2 and mates[0].n != mates[1].n:
        raise ValueError("mate files hold different numbers of reads")
    files = {}
    for i, fq in enumerate(mates):
        files.update(mate_files(fq, i + 1, sample))
    files.update(pair_files(mates, sample))
    return files


def kind_of(suffix: str) -> str:
    return suffix[1:-4].rsplit("_mate", 1)[0]


def compare(exp: dict[str, str], prefix: str) -> dict[str, int]:
    """Per kind of file, the lines of the program's files at `prefix` that
    differ from the reference's (a missing file: all of its lines)."""
    bad = {k: 0 for k in KINDS}
    for suffix, text in exp.items():
        want = text.splitlines()
        try:
            with open(prefix + suffix, encoding="latin-1") as f:
                got = f.read().splitlines()
        except OSError:
            got = []
        diff = sum(a != b for a, b in zip(want, got))
        bad[kind_of(suffix)] += diff + abs(len(want) - len(got))
    return bad
