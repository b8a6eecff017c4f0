"""FastQC-equivalent statistics on torch tensors.

Mirrors ngstpu/ops/fastqc.py, whose module imports jax, so the host helpers
(the numpy placement of every module, the dedup key, the report tables)
are numpy copies here. The device functions take tensors on one device and
return tensors on it:

- fastqc_stats: the quality matrix [L, 128] and the length histogram come
  from one launch of the QC histogram kernel (kernels/hist_cuda.py) into
  fresh totals of L cycles and max_len + 2 length bins, or from its plain
  version for CPU tensors.
- adapter_content, per_tile_quality, kmer_position_counts: torch ops.

Every count is an integer, and the rows are taken in chunks of _ROWS, so
the [rows, L] temporaries stay bounded at a lane's size (10M reads) and the
results equal the JAX package's exactly. FASTQC counts the device
functions' calls per (op, device type); chip_smoke.py reads it.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..kernels.hist_cuda import N_QUAL, qc_hist_accumulate_
from ..utils.timing import COUNTS

MAX_LEN = 300  # reference Rgzfastq_uniq.c:26
KMER_K = 7  # FastQC Kmer module word size

# FastQC's shipped adapter list (Configuration/adapter_list.txt upstream)
ADAPTERS: tuple[tuple[str, bytes], ...] = (
    ("Illumina Universal Adapter", b"AGATCGGAAGAG"),
    ("Illumina Small RNA 3' Adapter", b"TGGAATTCTCGG"),
    ("Illumina Small RNA 5' Adapter", b"GATCGTCGGACT"),
    ("Nextera Transposase Sequence", b"CTGTCTCTTATA"),
    ("SOLID Small RNA Adapter", b"CGCCTTGGCCGT"),
)
ADAPTER_BYTES = np.frombuffer(b"".join(a for _, a in ADAPTERS),
                              np.uint8).reshape(len(ADAPTERS), -1)

FASTQC: collections.Counter = collections.Counter()

_ROWS = 1 << 19  # rows per chunk: [_ROWS, 128] int64 is 512 MiB


def _chunks(n: int):
    for lo in range(0, n, _ROWS):
        yield lo, min(lo + _ROWS, n)


def _n_rows(n_valid: int, B: int) -> int:
    return max(0, min(int(n_valid), B))


def fastqc_stats(seq: torch.Tensor, qual: torch.Tensor, lens: torch.Tensor,
                 n_valid: int, max_len: int = MAX_LEN) -> dict:
    """seq/qual uint8 [B, L], lens int32 [B], on one device. Returns dict:
    quality int32 [L, 128] (cycle-major; quality bytes >= 128 are not
    counted), ntval int32 [L, 5] (rows T/C/A/G/N as codes 0-4), gc_frac
    float32 [B], len_hist int32 [max_len] (bin i == length i+1), over rows
    < n_valid and cycles < lens[row]."""
    if max_len < 0:
        raise ValueError(f"max_len must be >= 0, got {max_len}")
    B, L = seq.shape
    dev = seq.device
    n = _n_rows(n_valid, B)
    total_q = torch.zeros((max(L, 1), N_QUAL), dtype=torch.int32, device=dev)
    # lengths clip to bin max_len + 1, so bins 1..max_len count exactly
    # the lengths 1..max_len
    total_len = torch.zeros(max_len + 2, dtype=torch.int32, device=dev)
    qc_hist_accumulate_(total_q, total_len, qual, lens, n)
    len_hist = total_len[1:max_len + 1]

    col = torch.arange(L, device=dev, dtype=torch.int64)
    ntval = torch.zeros(L * 5 + 1, dtype=torch.int64, device=dev)
    gc_frac = torch.zeros(B, dtype=torch.float32, device=dev)
    for lo, hi in _chunks(n):
        s = seq[lo:hi]
        ln = lens[lo:hi]
        m = col[None, :] < ln[:, None]
        # ntVal codes: default T(0); C=1, A=2, G=3 (case-insensitive); only
        # uppercase 'N' and '.' are N(4) (reference initNtVal :108)
        up = s & 0xDF
        code = torch.zeros(s.shape, dtype=torch.int64, device=dev)
        code.masked_fill_(up == ord("C"), 1)
        code.masked_fill_(up == ord("A"), 2)
        code.masked_fill_(up == ord("G"), 3)
        code.masked_fill_((s == ord("N")) | (s == ord(".")), 4)
        code += col * 5
        code.masked_fill_(~m, L * 5)  # masked cells land in the spare bin
        ntval += torch.bincount(code.view(-1), minlength=L * 5 + 1)
        del code, up
        is_gc = ((s == ord("G")) | (s == ord("C"))) & m
        gc_frac[lo:hi] = is_gc.sum(dim=1).to(torch.float32) / \
            ln.clamp(min=1).to(torch.float32)
    FASTQC["fastqc_stats", dev.type] += 1
    return dict(quality=total_q[:L],
                ntval=ntval[:L * 5].view(L, 5).to(torch.int32),
                gc_frac=gc_frac, len_hist=len_hist)


def adapter_content(seq: torch.Tensor, lens: torch.Tensor, n_valid: int,
                    adapters: np.ndarray) -> torch.Tensor:
    """Cumulative adapter content, FastQC-style.

    seq uint8 [B, L]; adapters uint8 [A, k] (host bytes). Returns int32
    [A, L] on seq's device: entry [a, i] = number of valid reads where
    adapter a matches starting at some cycle <= i (exact k-mer match, fully
    inside the read and the stored width). Each read's first match
    position is counted once, then the counts are cumulated, which equals
    the JAX package's cummax over the match matrix.
    """
    B, L = seq.shape
    A, k = adapters.shape
    dev = seq.device
    ad = np.asarray(adapters, np.uint8).tolist()
    n = _n_rows(n_valid, B)
    col = torch.arange(L, device=dev)
    firsts = torch.zeros((A, L + 1), dtype=torch.int64, device=dev)
    for lo, hi in _chunks(n):
        s = seq[lo:hi]
        window_ok = col[None, :] + k <= lens[lo:hi, None]
        for a in range(A):
            m = window_ok.clone()
            for j in range(k):
                if j >= L:  # the window runs past the stored bytes
                    m.zero_()
                    break
                m[:, L - j:] = False
                m[:, :L - j] &= s[:, j:] == ad[a][j]
            hit = m.any(dim=1)
            # argmax gives the first maximal index: the first match
            first = torch.where(hit, m.to(torch.uint8).argmax(dim=1), L)
            firsts[a] += torch.bincount(first, minlength=L + 1)
    FASTQC["adapter_content", dev.type] += 1
    return firsts[:, :L].cumsum(dim=1).to(torch.int32)


def per_tile_quality(qual: torch.Tensor, lens: torch.Tensor, n_valid: int,
                     tile_idx: torch.Tensor, n_tiles: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile per-cycle quality sums (FastQC per-tile module).

    qual uint8 [B, L] raw ASCII; tile_idx int [B] tile ordinals in
    [0, n_tiles). Returns (phred_sums int32 [T, L], counts int32 [T, L])
    with phred = ascii - 33 over rows < n_valid, cycles < lens[row]."""
    B, L = qual.shape
    dev = qual.device
    n = _n_rows(n_valid, B)
    col = torch.arange(L, device=dev)
    sums = torch.zeros((n_tiles, L), dtype=torch.int64, device=dev)
    counts = torch.zeros((n_tiles, L), dtype=torch.int64, device=dev)
    for lo, hi in _chunks(n):
        m = (col[None, :] < lens[lo:hi, None]).to(torch.int64)
        t = tile_idx[lo:hi].to(torch.int64)
        sums.index_add_(0, t, (qual[lo:hi].to(torch.int64) - 33) * m)
        counts.index_add_(0, t, m)
    FASTQC["per_tile_quality", dev.type] += 1
    return sums.to(torch.int32), counts.to(torch.int32)


def kmer_position_counts(seq: torch.Tensor, lens: torch.Tensor, n_valid: int,
                         k: int = KMER_K) -> torch.Tensor:
    """Per-start-position k-mer counts (FastQC Kmer module).

    The 2-bit id of the k-mer at every cycle comes from k shifted compares
    (A=0 C=1 G=2 T=3, uppercase only; windows holding any other byte, or
    running past lens or the stored width, are dropped), and one bincount
    over position * 4**k + id gives int32 [L, 4**k]."""
    B, L = seq.shape
    dev = seq.device
    n = _n_rows(n_valid, B)
    n_kmers = 4 ** k
    col = torch.arange(L, device=dev, dtype=torch.int64)
    flat = torch.zeros(L * n_kmers + 1, dtype=torch.int64, device=dev)
    for lo, hi in _chunks(n):
        s = seq[lo:hi]
        code = torch.full(s.shape, 4, dtype=torch.uint8, device=dev)
        for ch, v in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3)):
            code.masked_fill_(s == ch[0], v)
        ids = torch.zeros(s.shape, dtype=torch.int64, device=dev)
        ok = col[None, :] + k <= lens[lo:hi, None].to(torch.int64)
        for j in range(k):
            cj = torch.nn.functional.pad(code[:, j:], (0, j), value=4)
            ok &= cj < 4
            ids = (ids << 2) | torch.where(cj < 4, cj, 0).to(torch.int64)
        ids += col * n_kmers
        ids.masked_fill_(~ok, L * n_kmers)
        flat += torch.bincount(ids.view(-1), minlength=L * n_kmers + 1)
    FASTQC["kmer_position_counts", dev.type] += 1
    return flat[:L * n_kmers].view(L, n_kmers).to(torch.int32)


# --- host placement and report helpers: numpy copies of ngstpu/ops/fastqc.py


def fastqc_stats_host(seq: np.ndarray, qual: np.ndarray, lens: np.ndarray,
                      n: int, n_qual: int = 128, max_len: int = MAX_LEN):
    """Host placement of fastqc_stats (ngstpu/ops/fastqc.py:fastqc_stats_host):
    the native threaded per-cycle histogram and chunked numpy. quality is
    [L, n_qual] for any L."""
    from ..io.native import get_lib

    B, L = seq.shape
    lens32 = np.ascontiguousarray(lens[:n], np.int32)
    quality = np.zeros((L, n_qual), np.int64)
    lib = get_lib()
    if lib is not None and n and qual.flags.c_contiguous:
        hq = np.zeros(L * n_qual, np.uint64)
        hl = np.zeros(L, np.uint64)  # unused: len_hist below is exact
        lib.ngs_qc_hist(qual, lens32, n, L, n_qual, L, hq, hl, 0)
        quality = hq.reshape(L, n_qual).astype(np.int64)
    else:
        for lo in range(0, n, 1 << 18):
            hi = min(lo + (1 << 18), n)
            m = np.arange(L)[None, :] < lens32[lo:hi, None]
            q = np.where(m, qual[lo:hi].astype(np.int64), n_qual)
            for k in range(L):
                quality[k] += np.bincount(q[:, k], minlength=n_qual + 1
                                          )[:n_qual]

    ntval = np.zeros((L, 5), np.int64)
    gc_frac = np.zeros(n, np.float32)
    for lo in range(0, n, 1 << 18):
        hi = min(lo + (1 << 18), n)
        s = seq[lo:hi]
        m = np.arange(L)[None, :] < lens32[lo:hi, None]
        up = s & 0xDF
        for code, sel in ((1, up == ord("C")), (2, up == ord("A")),
                          (3, up == ord("G")),
                          (4, (s == ord("N")) | (s == ord(".")))):
            ntval[:, code] += (sel & m).sum(axis=0)
        is_gc = ((s == ord("G")) | (s == ord("C"))) & m
        gc_frac[lo:hi] = is_gc.sum(axis=1).astype(np.float32) / \
            np.maximum(lens32[lo:hi], 1).astype(np.float32)
    valid = np.zeros(L, np.int64)  # reads covering cycle k
    cnt = np.bincount(np.clip(lens32, 0, L), minlength=L + 1)
    valid[:] = n - np.cumsum(cnt)[:L]
    ntval[:, 0] = valid - ntval[:, 1:].sum(axis=1)  # T = everything else

    lh = np.zeros(max_len, np.int64)
    in_range = (lens32 >= 1) & (lens32 <= max_len)
    lh[:] = np.bincount(lens32[in_range] - 1, minlength=max_len)
    return dict(quality=quality, ntval=ntval, gc_frac=gc_frac, len_hist=lh)


def truncated_key(seq: np.ndarray, lens: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The dedup key rule: first 50bp when len > 75, else whole read
    (reference Rgzfastq_uniq.c:172)."""
    key_lens = np.where(lens > 75, 50, lens).astype(np.int32)
    width = max(((int(key_lens.max(initial=1)) + 3) // 4) * 4, 4)
    key = seq[:, :width].copy()
    colm = np.arange(width)[None, :] < key_lens[:, None]
    key *= colm
    return key, key_lens


def adapter_content_host(seq: np.ndarray, lens: np.ndarray, n: int,
                         adapters: np.ndarray, k: int = 12) -> np.ndarray:
    """Host placement of adapter_content: a rolling big-endian u32 window
    per chunk turns each 12-byte match into three word compares; the
    cumulative count comes from each read's first match position."""
    B, L = seq.shape
    A = adapters.shape[0]
    out = np.zeros((A, L), np.int32)
    # positions past L-k can never hold a full adapter in the stored bytes,
    # and unclamped lens would push the sparse verify's gathers out of range
    lens32 = np.minimum(np.asarray(lens[:n], np.int32), L)
    words = k // 4 if k % 4 == 0 else 0
    for lo in range(0, n, 1 << 17):
        hi = min(lo + (1 << 17), n)
        s = seq[lo:hi]
        window_ok = np.arange(L)[None, :] + k <= lens32[lo:hi, None]
        u = None
        if words and L >= 4:
            # u[:, i] = bytes i..i+3, built in place, width L-3
            u = s[:, :L - 3].astype(np.uint32)
            u <<= 8
            u |= s[:, 1:L - 2]
            u <<= 8
            u |= s[:, 2:L - 1]
            u <<= 8
            u |= s[:, 3:L]
        for a in range(A):
            if u is not None:
                # first-word prescreen, then a sparse verify of the rest
                vals = [np.uint32(int.from_bytes(
                    adapters[a, 4 * w:4 * w + 4].tobytes(), "big"))
                    for w in range(words)]
                m = window_ok[:, :L - 3] & (u == vals[0])
                ri, cj = np.nonzero(m)
                for w in range(1, words):
                    keep = u[ri, cj + 4 * w] == vals[w]
                    ri, cj = ri[keep], cj[keep]
                firsts = np.full(hi - lo, L, np.int64)
                np.minimum.at(firsts, ri, cj)
                first = firsts[firsts < L]
            else:  # k not a multiple of 4: byte compares
                m = window_ok.copy()
                for j in range(k):
                    m[:, L - j:] = False
                    m[:, :L - j] &= s[:, j:] == adapters[a, j]
                hit = m.any(axis=1)
                first = m.argmax(axis=1)[hit]
            out[a] += np.cumsum(np.bincount(first, minlength=L)[:L]
                                ).astype(np.int32)
    return out


def per_tile_quality_host(qual: np.ndarray, lens: np.ndarray, n: int,
                          tile_idx: np.ndarray, n_tiles: int):
    """Host placement of per_tile_quality (np.add.at row scatter)."""
    B, L = qual.shape
    mask = np.arange(L)[None, :] < np.asarray(lens[:n], np.int32)[:, None]
    phred = (qual[:n].astype(np.int32) - 33) * mask
    sums = np.zeros((n_tiles, L), np.int32)
    counts = np.zeros((n_tiles, L), np.int32)
    np.add.at(sums, tile_idx[:n], phred)
    np.add.at(counts, tile_idx[:n], mask.astype(np.int32))
    return sums, counts


def kmer_position_counts_host(seq: np.ndarray, lens: np.ndarray, n: int,
                              k: int = KMER_K) -> np.ndarray:
    """Host placement of kmer_position_counts (bincount over flattened
    (position, kmer-id) cells)."""
    B, L = seq.shape
    code = np.full(seq.shape, 4, np.int8)
    for ch, v in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3)):
        code[seq == ch[0]] = v
    ids = np.zeros((B, L), np.int32)
    ok = np.ones((B, L), bool)
    for j in range(k):
        cj = np.full((B, L), 4, np.int8)
        cj[:, :L - j] = code[:, j:]
        ok &= cj < 4
        ids = (ids << 2) | np.where(cj < 4, cj, 0).astype(np.int32)
    lens32 = np.asarray(lens[:n], np.int32)
    valid = ok[:n] & (np.arange(L)[None, :] + k <= lens32[:, None])
    n_kmers = 4 ** k
    seg = (np.arange(L, dtype=np.int64)[None, :] * n_kmers
           + ids[:n]).ravel()[valid.ravel()]
    flat = np.bincount(seg, minlength=L * n_kmers)
    return flat.reshape(L, n_kmers).astype(np.int32)


def dedup_groups_host_native(key: np.ndarray, key_lens: np.ndarray):
    """Host dedup for the duplication/overrepresented modules: the
    bucketed parallel native sort and group extraction when the native
    library is there, else the numpy lexsort spill engine over raw-byte
    words (the port's sortengine._dedup_host). Both return (counts, rep)
    in key-ascending group order, as the device dedup_groups does."""
    from ..io.native import get_lib
    from .hostsort import bytes_to_words_host, classify_alphabet
    from .sortengine import _dedup_host, pack_words

    B = len(key_lens)
    if B == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lens32 = np.ascontiguousarray(key_lens, np.int32)
    lib = get_lib()
    if lib is None:
        # raw-byte packing collates as any rank packing does, so the group
        # order (and thus counts/rep) matches the device path
        words = bytes_to_words_host(key)
        perm, is_head = _dedup_host(words, lens32, np.zeros(B, np.uint32),
                                    B, length_first=False)
        head_pos = np.flatnonzero(is_head)
        counts = np.diff(np.append(head_pos, B)).astype(np.int64)
        return counts, perm[head_pos].astype(np.int64)
    import ctypes

    kind = classify_alphabet(key)
    words = np.ascontiguousarray(pack_words(key, kind, torch.device("cpu")))
    use_len = 0 if kind == "dna3" else 1
    perm = np.empty(B, np.int32)
    rep = np.empty(B, np.int64)
    counts = np.empty(B, np.int64)
    zeros = np.zeros(B, np.uint32)
    g = lib.ngs_dedup_groups_host(
        words, lens32.ctypes.data_as(ctypes.c_void_p), zeros, use_len, B,
        words.shape[1], perm, rep, counts, 0)
    return counts[:g].copy(), rep[:g].copy()


def overrepresented(key: np.ndarray, key_lens: np.ndarray,
                    counts: np.ndarray, rep: np.ndarray, n_reads: int,
                    threshold: float = 0.001, limit: int = 20
                    ) -> list[tuple[bytes, int, float]]:
    """FastQC's overrepresented-sequences table: the dedup keys occurring
    in more than `threshold` of reads, most frequent first, at most
    `limit` rows. counts/rep: group sizes and representative original
    indices from dedup_groups."""
    if n_reads == 0 or len(counts) == 0:
        return []
    min_count = max(int(np.floor(threshold * n_reads)) + 1, 2)
    hot = np.flatnonzero(counts >= min_count)
    if len(hot) == 0:
        return []
    order = hot[np.argsort(counts[hot], kind="stable")[::-1]][:limit]
    rows = []
    for g in order:
        i = int(rep[g])
        s = key[i, : int(key_lens[i])].tobytes()
        rows.append((s, int(counts[g]), counts[g] * 100.0 / n_reads))
    return rows


def parse_tile_ids(batch, step: int = 1):
    """Illumina tile numbers from read names (host side). FastQC's rule:
    split the id on ':'; >= 7 fields (CASAVA 1.8+) -> field 5, 5..6
    fields -> field 3. Returns (row_idx int64 [Bs], tile_ordinal int32
    [Bs], sorted unique tiles) or None when names carry no tiles.

    Fast path: one native pass over the batch's name blob
    (io/native.tile_ids) reads every sampled row's tile, and np.unique
    gives the ordinals. It falls back to the per-name loop
    (_parse_tile_ids_loop, the rule's definition) when the batch has no
    name blob, the native library is unavailable, or any sampled name has
    fewer than 5 fields or a tile field that is not 1 to 18 ASCII digits
    (int() also takes '+12', '-12', '1_2' or a leading vertical tab, and
    the loop decides what those mean). Both give the same result, types
    included.
    COUNTS["tile_rows_native"] / ["tile_rows_loop"] count the sampled rows
    each path was handed."""
    from ..io.native import tile_ids

    rows = np.arange(0, batch.n, step, dtype=np.int64)
    names = getattr(batch, "names", None)
    tiles = (None if names is None else
             tile_ids(names, batch.name_starts, batch.name_lens, rows))
    if tiles is None:
        COUNTS["tile_rows_loop"] += len(rows)
        return _parse_tile_ids_loop(batch, step)
    COUNTS["tile_rows_native"] += len(rows)
    if not len(tiles):
        return None
    uniq, ords = np.unique(tiles, return_inverse=True)
    if len(uniq) > 2048:  # not plausibly tile numbers
        return None
    return rows, ords.astype(np.int32), uniq.tolist()


def _parse_tile_ids_loop(batch, step: int):
    """parse_tile_ids, one name at a time in Python: the definition, and
    the fallback for names the native pass does not read."""
    rows, tiles = [], []
    for i in range(0, batch.n, step):
        name = batch.name(i)
        head = name.split(b" ", 1)[0].split(b"\t", 1)[0]
        parts = head.split(b":")
        if len(parts) >= 7:
            f = parts[4]
        elif len(parts) >= 5:
            f = parts[2]
        else:
            return None
        try:
            t = int(f)
        except ValueError:
            return None
        rows.append(i)
        tiles.append(t)
    if not tiles:
        return None
    uniq = sorted(set(tiles))
    if len(uniq) > 2048:  # not plausibly tile numbers
        return None
    lut = {t: j for j, t in enumerate(uniq)}
    ords = np.asarray([lut[t] for t in tiles], np.int32)
    return np.asarray(rows, np.int64), ords, uniq


def kmer_id_to_str(kid: int, k: int = KMER_K) -> str:
    out = []
    for _ in range(k):
        out.append("ACGT"[kid & 3])
        kid >>= 2
    return "".join(reversed(out))


def kmer_report(counts: np.ndarray, k: int = KMER_K, limit: int = 20,
                min_total: int = 10, min_ratio: float = 5.0
                ) -> list[tuple[str, int, float, int]]:
    """FastQC-style enrichment table from kmer_position_counts output.

    expected[p, K] = total(K) * windows(p) / total_windows; rows =
    (kmer, total count, max obs/expected, 1-based position of the max),
    kmers with max ratio >= min_ratio, strongest first, at most limit."""
    counts = np.asarray(counts, np.int64)
    totals = counts.sum(axis=0)
    win_per_pos = counts.sum(axis=1)
    total_windows = win_per_pos.sum()
    if total_windows == 0:
        return []
    hot = np.flatnonzero(totals >= min_total)
    if len(hot) == 0:
        return []
    exp = (totals[None, hot] *
           (win_per_pos[:, None] / total_windows))  # [L, |hot|]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(exp > 0, counts[:, hot] / exp, 0.0)
    best_pos = ratio.argmax(axis=0)
    best = ratio[best_pos, np.arange(len(hot))]
    keep = np.flatnonzero(best >= min_ratio)
    order = keep[np.argsort(best[keep], kind="stable")[::-1]][:limit]
    return [(kmer_id_to_str(int(hot[j]), k), int(totals[hot[j]]),
             float(best[j]), int(best_pos[j]) + 1) for j in order]
