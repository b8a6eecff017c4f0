"""Device sort/dedup engine on torch tensors.

Mirrors the device half of ngstpu/ops/sortengine.py: rows are packed into
collation-preserving uint32 words (on the host by ops/hostsort.py's
native packers, or on the device by bytes_to_words / dna2_words /
dna3_words), and a stable LSD chain of one-key sorts gives the
lexicographic order; duplicate groups are equal-neighbour runs of the
sorted rows. dedup_groups spills key sets too large for the card to a
numpy lexsort with the same order.

torch's uint32 support is thin, so every key is widened to int64 before it
is sorted: words (which exceed 2**31 whenever a 2-bit row starts with G or
T) travel as their int32 bit pattern and are widened with
``w.to(torch.int64) & 0xFFFFFFFF``; signed keys and bools widen directly.
Both packages sort stably on the same keys, so the permutations are equal.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch

from ..utils.device import upload
from ..utils.timing import span
from .hostsort import (_pack_host, bytes_to_words_host, classify_alphabet,
                       is_dna3_compatible)

# sorts run per device type by lex_argsort / sort_partition / dedup_sorted,
# and device packs per (packer, device type): chip_smoke.py reads both to
# show that the card did the work
SORTS: collections.Counter = collections.Counter()
PACKS: collections.Counter = collections.Counter()


def words_tensor(words_np: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 [B, W] host words -> int64 [B, W] on `device`, values 0..2**32-1.

    The copy is synchronous: `words_np` may be reused when this returns."""
    w = np.ascontiguousarray(words_np, dtype=np.uint32).view(np.int32)
    return upload(w, device).to(torch.int64).bitwise_and_(0xFFFFFFFF)


def bytes_to_words(padded: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 (L % 4 == 0) -> [B, L//4] big-endian words, int64."""
    B, L = padded.shape
    w = padded.reshape(B, L // 4, 4).to(torch.int32)
    # int32 arithmetic wraps at the top byte; the mask restores 0..2**32-1
    words = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) \
        | w[..., 3]
    PACKS["bytes_to_words", padded.device.type] += 1
    return words.to(torch.int64).bitwise_and_(0xFFFFFFFF)


def _rank_words(padded: torch.Tensor, alphabet: bytes, per: int,
                bits: int) -> torch.Tensor:
    """Pack `per` ranks of `bits` bits per word, first base most
    significant; byte alphabet[i] ranks i + 1, any other byte 0."""
    B, L = padded.shape
    ranks = torch.zeros_like(padded)
    for i, c in enumerate(alphabet):
        ranks = torch.where(padded == c, i + 1, ranks)
    groups = (L + per - 1) // per
    ranks = torch.nn.functional.pad(ranks, (0, groups * per - L))
    shifts = torch.arange((per - 1) * bits, -1, -bits, device=padded.device)
    return (ranks.reshape(B, groups, per).to(torch.int64) << shifts).sum(-1)


def dna2_words(padded: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 pure-ACGT -> [B, ceil(L/16)] int64 words: sixteen 2-bit
    ranks per word (A=0 C=1 G=2 T=3; padding packs as 'A', so callers keep
    an explicit length key)."""
    PACKS["dna2_words", padded.device.type] += 1
    return _rank_words(padded, b"CGT", 16, 2)


def dna3_words(padded: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 DNA -> [B, ceil(L/10)] int64 words: ten 3-bit ranks per
    word, byte order on {., A, C, G, N, T} with 0 reserved for padding
    (the caller checks the alphabet with is_dna3_compatible)."""
    PACKS["dna3_words", padded.device.type] += 1
    return _rank_words(padded, b".ACGNT", 10, 3)


def pack_words(padded_np: np.ndarray, kind: str,
               device: torch.device) -> np.ndarray:
    """Collation-preserving uint32 sort words for `kind`, on the host.

    ngstpu's hostsort.pack_words_host without its jax fallback: the
    native threaded packer, or the device packers on `device` when the
    native library is missing."""
    if kind in ("dna2", "dna3"):
        out = _pack_host(padded_np, kind)
        if out is not None:
            return out
        fn = dna2_words if kind == "dna2" else dna3_words
        words = fn(upload(padded_np, device))
        return words.cpu().numpy().astype(np.uint32)
    return bytes_to_words_host(padded_np)


def seq_words(padded_np: np.ndarray, device: torch.device,
              dna3: bool | None = None) -> torch.Tensor:
    """Sort words for sequence bytes on `device` (int64): 3-bit packed when
    the data is plain DNA (on the host through ngs_dna3_pack when the
    native library is there, by dna3_words on the device otherwise), raw
    big-endian bytes packed on the device otherwise."""
    if dna3 is None:
        dna3 = is_dna3_compatible(padded_np, None)
    padded_np = np.ascontiguousarray(padded_np)
    if dna3:
        out = _pack_host(padded_np, "dna3")
        if out is not None:
            return words_tensor(out, device)
        return dna3_words(upload(padded_np, device))
    return bytes_to_words(upload(padded_np, device))


def pack_for_dedup(padded_np: np.ndarray, device: torch.device,
                   kind: str | None = None) -> tuple[torch.Tensor, bool]:
    """Narrowest sort-key packing for the dedup engine.

    Returns (int64 words on `device`, words_encode_len): the flag is True
    only for dna3 packing, whose reserved padding rank makes equal words
    imply equal lengths.
    """
    if kind is None:
        kind = classify_alphabet(padded_np)
    return (words_tensor(pack_words(padded_np, kind, device), device),
            kind == "dna3")


def _order_key(key: torch.Tensor) -> torch.Tensor:
    """Order-preserving widening to int64 (words are already widened)."""
    return key if key.dtype == torch.int64 else key.to(torch.int64)


def _lsd_perm(keys_msf: list[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort via LSD passes of one-key stable sorts.

    keys_msf: key tensors in most-significant-first order. Stability makes
    the original index the implicit final tiebreaker. Returns int64 [B].
    """
    B = keys_msf[0].shape[0]
    perm = torch.arange(B, device=keys_msf[0].device)
    for key in reversed(keys_msf):
        k = _order_key(key)[perm]
        perm = perm[torch.sort(k, stable=True).indices]
    return perm


def lex_argsort(words: torch.Tensor, lens: torch.Tensor,
                length_first: bool = False) -> torch.Tensor:
    """Stable argsort of rows by word-tuple lexicographic order.

    words: int64 [B, W] (widened uint32); lens: int [B], the leading key
    when length_first. Returns perm int64 [B].
    """
    ops = [lens] if length_first else []
    ops.extend(words[:, w] for w in range(words.shape[1]))
    perm = _lsd_perm(ops)
    SORTS[words.device.type] += 1
    return perm


def _heads(s_words: torch.Tensor, s_valid: torch.Tensor,
           s_lens: torch.Tensor | None) -> torch.Tensor:
    same = (s_words[1:] == s_words[:-1]).all(dim=1)
    if s_lens is not None:
        same &= s_lens[1:] == s_lens[:-1]
    same &= s_valid[1:] & s_valid[:-1]
    first = torch.ones(1, dtype=torch.bool, device=s_words.device)
    return torch.cat([first, ~same]) & s_valid


def dedup_sorted(words: torch.Tensor, lens: torch.Tensor, sumq: torch.Tensor,
                 n_valid: int, length_first: bool = False,
                 words_encode_len: bool = False, maybe_padding: bool = True):
    """Sort rows and mark duplicate-group heads (ngstpu's dedup_sorted).

    Sort keys, most significant first: [padding-last sentinel, (len if
    length_first), words..., (len unless words_encode_len or
    length_first), -sumQ as int32]; stability supplies the original-index
    tiebreak, so each group's first sorted row is the representative the
    reference keeps (gzfastq_uniq.c:226, strict >).

    Returns dict: perm int64 [B] (padding rows last), is_head bool [B],
    n_groups int64 scalar tensor.
    """
    B = words.shape[0]
    dev = words.device
    valid = torch.arange(B, device=dev) < int(n_valid)
    ops: list[torch.Tensor] = []
    if maybe_padding:
        ops.append(~valid)
    if length_first:
        ops.append(lens)
    ops.extend(words[:, w] for w in range(words.shape[1]))
    if not (words_encode_len or length_first):
        ops.append(lens)
    # JAX negates sumq after an int32 cast; the same wraparound here
    ops.append(-(sumq.to(torch.int32)))
    perm = _lsd_perm(ops)
    SORTS[dev.type] += 1
    is_head = _heads(words[perm], valid[perm], lens[perm])
    return dict(perm=perm, is_head=is_head, n_groups=is_head.sum())


def sort_partition(words: torch.Tensor, lens: torch.Tensor, n_valid: int,
                   length_key: bool = True, maybe_padding: bool = True):
    """Key-only stable sort + group heads for one key-range partition
    (ngstpu's sort_partition): no quality-sum key; the representative is
    recovered on the host by rep_counts_host. length_key=False skips the
    length pass when all row lengths are equal.

    Returns (perm int64 [B], is_head bool [B]); padding rows sort last and
    are never heads.
    """
    B = words.shape[0]
    dev = words.device
    valid = torch.arange(B, device=dev) < int(n_valid)
    ops: list[torch.Tensor] = [~valid] if maybe_padding else []
    ops.extend(words[:, w] for w in range(words.shape[1]))
    if length_key:
        ops.append(lens)
    perm = _lsd_perm(ops)
    SORTS[dev.type] += 1
    is_head = _heads(words[perm], valid[perm],
                     lens[perm] if length_key else None)
    return perm, is_head


def rep_counts_host(perm: np.ndarray, is_head: np.ndarray, n_valid: int,
                    sumq: np.ndarray):
    """Group sizes + representative rows from a stable key-only sort.

    A numpy copy of ngstpu's sortengine.rep_counts_host, whose module
    imports jax. perm/is_head: from sort_partition, trimmed to valid rows;
    sumq: per-row quality sums (partition-local indexing, same as perm).
    Returns (rep_local [G], counts [G]) with groups in key order; rep is
    the earliest row achieving the group's max sumq.
    """
    head_pos = np.flatnonzero(is_head)
    if len(head_pos) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    counts = np.diff(np.append(head_pos, n_valid))
    s = sumq[perm].astype(np.int64)
    maxv = np.maximum.reduceat(s, head_pos)
    cand = s >= np.repeat(maxv, counts)
    p64 = np.where(cand, perm.astype(np.int64), np.iinfo(np.int64).max)
    rep_local = np.minimum.reduceat(p64, head_pos)
    return rep_local, counts


# Key sets above this many bytes of uint32 key words (B * W * 4: the unit
# of ngstpu's NGSTPU_DEVICE_DEDUP_LIMIT, whose 4 GB default was sized for
# TPU HBM) spill to the host. Device bytes per row of dedup_sorted on the
# port, W key words per row:
#   upload: int32 staging 4W + int64 words 8W                   = 12W
#   each LSD pass: int64 words 8W; lens, sumq, -sumq, valid,
#     ~valid 14; perm 8; gathered key 8; sorted keys 8 + indices
#     8; radix scratch ~16 (keys + indices again); next perm 8  = 8W + 78
#   group heads: words 8W + gathered rows 8W + equality mask W
#     + gathered lens/valid and head flags ~30                  = 17W + 30
# The peak is max(8W + 78, 17W + 30): 86 bytes at W = 1, the worst case
# per key byte (86 / 4 = 21.5; 149 / 28 = 5.3 at W = 7, 100 bp in 2-bit
# words). On an H100 (torch 2.11, CUDA 12.8) dedup_groups measured 77.2
# bytes per row at W = 1 and 146.1 at W = 7, at 2M and at 10M rows
# (chip_smoke.py prints both). Budget 60 GiB of the H100's 80 GB, leaving
# the rest for the CUDA context, the caching allocator's rounding and the
# caller's tensors: 60 GiB / 22 = 2.73 GiB of key words.
_DEDUP_DEVICE_BUDGET = 60 << 30
_DEDUP_PEAK_PER_KEY_BYTE = 22
DEVICE_DEDUP_LIMIT = int(os.environ.get(
    "NGSTPU_DEVICE_DEDUP_LIMIT",
    _DEDUP_DEVICE_BUDGET // _DEDUP_PEAK_PER_KEY_BYTE))


def _dedup_host(words_np: np.ndarray, lens_np: np.ndarray,
                sumq_np: np.ndarray, n_valid: int, length_first: bool):
    """Host spill path: numpy lexsort with the device path's key order.

    A numpy copy of ngstpu's sortengine._dedup_host, whose module imports
    jax. The full key set is used; the device chain only skips keys that
    cannot change the order."""
    # np.lexsort: LAST key is primary. Significance (most->least):
    # validity, (lens if length_first), words[0..W-1], lens, -sumq, idx.
    keys = [np.arange(len(lens_np))]           # idx (least significant)
    keys.append(-sumq_np.astype(np.int64))
    keys.append(lens_np)
    keys.extend(words_np[:, w] for w in range(words_np.shape[1] - 1, -1, -1))
    if length_first:
        keys.append(lens_np)
    keys.append(np.arange(len(lens_np)) >= n_valid)  # padding rows last
    perm = np.lexsort(tuple(keys)).astype(np.int32)[:n_valid]
    sw = words_np[perm]
    sl = lens_np[perm]
    same = (sw[1:] == sw[:-1]).all(axis=1) & (sl[1:] == sl[:-1])
    is_head = np.concatenate([[True], ~same])
    return perm, is_head


def dedup_groups(words_np: np.ndarray, lens_np: np.ndarray,
                 sumq_np: np.ndarray, n_valid: int, device: torch.device,
                 length_first: bool = False, words_encode_len: bool = False):
    """Host-side wrapper around dedup_sorted (ngstpu's dedup_groups).

    words_np: uint32 [B, W] host words; lens_np: int32 [B]; sumq_np: uint32
    [B]. The spill decision is taken on the host words, so a key set over
    DEVICE_DEDUP_LIMIT bytes never goes to the card.

    Returns dict of numpy arrays:
      perm      sorted order (original indices)
      head_pos  [G] sorted-row index of each group head
      counts    [G] group sizes
      rep       [G] original index of the representative (first max-sumQ)
      n_groups  int
    Groups are in key-ascending order; heads are the representatives.
    """
    words_np = np.ascontiguousarray(words_np, np.uint32)
    lens_np = np.ascontiguousarray(lens_np, np.int32)
    sumq_np = np.ascontiguousarray(sumq_np, np.uint32)
    if words_np.size * 4 > DEVICE_DEDUP_LIMIT:
        perm, is_head = _dedup_host(words_np, lens_np, sumq_np, n_valid,
                                    length_first)
    else:
        res = dedup_sorted(words_tensor(words_np, device),
                           upload(lens_np, device),
                           upload(sumq_np.view(np.int32), device),
                           n_valid, length_first=length_first,
                           words_encode_len=words_encode_len,
                           maybe_padding=words_np.shape[0] != n_valid)
        perm = res["perm"].cpu().numpy()
        is_head = res["is_head"].cpu().numpy()
    head_pos = np.flatnonzero(is_head)
    counts = np.diff(np.concatenate([head_pos, [n_valid]]))
    rep = perm[head_pos]
    return dict(perm=perm, head_pos=head_pos, counts=counts, rep=rep,
                n_groups=len(head_pos))


def dedup_rows(padded_np: np.ndarray, lens_np: np.ndarray,
               sumq_np: np.ndarray, n_valid: int, device: torch.device):
    """dedup_groups over the narrowest key packing of zero-padded sequence
    rows (ngstpu's pack_for_dedup + dedup_groups, lexicographic order),
    in spans dedup.pack and dedup.groups."""
    with span("dedup.pack"):
        kind = classify_alphabet(padded_np)
        words = pack_words(padded_np, kind, device)
    with span("dedup.groups"):
        return dedup_groups(words, lens_np, sumq_np, n_valid, device,
                            words_encode_len=kind == "dna3")
