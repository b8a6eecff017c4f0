"""Device sort/dedup engine on torch tensors.

Mirrors the device half of ngstpu/ops/sortengine.py: rows are packed into
collation-preserving uint32 words on the host (ngstpu.ops.hostsort), and
a stable LSD chain of one-key sorts gives the lexicographic order; duplicate
groups are equal-neighbour runs of the sorted rows.

torch's uint32 support is thin, so every key is widened to int64 before it
is sorted: words (which exceed 2**31 whenever a 2-bit row starts with G or
T) travel as their int32 bit pattern and are widened with
``w.to(torch.int64) & 0xFFFFFFFF``; signed keys and bools widen directly.
Both packages sort stably on the same keys, so the permutations are equal.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

# sorts run per device type by sort_partition / dedup_sorted (chip_smoke.py
# reads it to show that the device sort ran)
SORTS: collections.Counter = collections.Counter()


def words_tensor(words_np: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 [B, W] host words -> int64 [B, W] on `device`, values 0..2**32-1.

    The copy is synchronous: `words_np` may be reused when this returns."""
    w = np.ascontiguousarray(words_np, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(w).to(device).to(torch.int64) & 0xFFFFFFFF


def pack_for_dedup(padded_np: np.ndarray, device: torch.device,
                   kind: str | None = None) -> tuple[torch.Tensor, bool]:
    """Narrowest sort-key packing for the dedup engine.

    Returns (int64 words on `device`, words_encode_len): the flag is True
    only for dna3 packing, whose reserved padding rank makes equal words
    imply equal lengths.
    """
    from ngstpu.ops.hostsort import classify_alphabet, pack_words_host

    if kind is None:
        kind = classify_alphabet(padded_np)
    return (words_tensor(pack_words_host(padded_np, kind), device),
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
    return _lsd_perm(ops)


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

    A numpy copy of ngstpu.ops.sortengine.rep_counts_host, whose module
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
