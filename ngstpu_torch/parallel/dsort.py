"""Distributed dedup and sort over a mesh's 'dp' axis
(ngstpu/parallel/dsort.py).

The global dedup (gzfastq_uniq at 10M+ reads) across shards:

1. every shard owns a row slice of the packed key matrix;
2. rows go to the shard that owns their key's hash bucket through one
   all_to_all (equal keys share a hash, so a duplicate group lands whole
   on one shard);
3. each shard sorts what it received with the stable LSD chain
   (ops/sortengine._lsd_perm) and marks the group heads;
4. the host merges the shards' heads into global key order.

The distributed sort (gzfastq_sort -m) is a sample sort: local sorts,
all_gather'd splitters, a bucket all_to_all and a local re-sort.

Buckets hold pad_factor x a fair share; a row past its bucket's capacity
is dropped by the scatter (it writes the dump slot n_dp * cap, which is
cut off), so both entry points count the rows that arrived and raise on
overflow. The original row index rides every exchange as the last sort
key, so the results equal the single-device dedup_groups and lex_argsort
bit for bit.

Keys travel as int64: uint32 words widened with & 0xFFFFFFFF (the port's
sortengine convention), so every comparison and sort orders them as the
JAX package's uint32 keys.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sortengine import _heads, _lsd_perm
from . import collectives
from .dist import shard_batch_arrays
from .mesh import Mesh

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF

def _hash_rows(words: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """32-bit FNV-1a over each row's words (4 bytes each, least
    significant first) and its length; int64 [b] in 0..2**32-1.

    int64 arithmetic with a mask after every multiply: h < 2**32 and the
    prime < 2**25, so the product fits."""
    h = torch.full(words.shape[:1], FNV_OFFSET, dtype=torch.int64,
                   device=words.device)
    for w in range(words.shape[1]):
        col = words[:, w].to(torch.int64) & _U32
        for shift in (0, 8, 16, 24):
            h = ((h ^ ((col >> shift) & 0xFF)) * FNV_PRIME) & _U32
    return ((h ^ (lens.to(torch.int64) & _U32)) * FNV_PRIME) & _U32


def _bucket_scatter(rows: torch.Tensor, dest: torch.Tensor, n_dp: int,
                    cap: int) -> torch.Tensor:
    """rows [b, C] to a zero-filled [n_dp, cap, C] at flat slots dest.
    Rows aimed at slot n_dp * cap (the dump slot: invalid or past their
    bucket's capacity) may land there in any order; the slot is cut off."""
    flat = torch.zeros((n_dp * cap + 1, rows.shape[1]), dtype=rows.dtype,
                       device=rows.device)
    flat[dest] = rows
    return flat[:-1].view(n_dp, cap, rows.shape[1])


def _slots(bucket: torch.Tensor, keep: torch.Tensor, n_dp: int,
           cap: int) -> torch.Tensor:
    """Flat destination of each row of a nondecreasing `bucket`: its
    bucket's base plus its rank in the bucket, or the dump slot when not
    `keep` or past `cap`."""
    idx = torch.arange(bucket.shape[0], device=bucket.device)
    pos = idx - torch.searchsorted(bucket, bucket)
    ok = (pos < cap) & keep
    return torch.where(ok, bucket * cap + pos, n_dp * cap)


def exchange_dedup(mesh: Mesh, pad_factor: float = 2.0):
    """The hash-bucket exchange and per-shard dedup sort.

    Returns fn(words, lens, sumq, gidx, valid) -> (s_words, s_lens, s_gidx,
    is_head, s_valid), each a list of local shards ([b, W] int64 words,
    int32 lens, int64 uint32 sums and global indices, bool valid, as
    shard_batch_arrays splits them; words may also come as int32 bit
    patterns). Each result shard holds n_dp * cap rows sorted by (valid
    first, key words, len, -sumq as int32, global index), so each group's
    first row is the representative the single-device path keeps (max
    sumQ, earliest original index; gzfastq_uniq.c:226)."""
    comm = collectives.of(mesh)
    n_dp = mesh.size

    def send(words, lens, sumq, gidx, valid):
        b, W = words.shape
        cap = int(pad_factor * b / n_dp) + 8
        words = words.to(torch.int64) & _U32
        bucket = torch.where(valid, _hash_rows(words, lens) % n_dp, n_dp)
        order = torch.sort(bucket, stable=True).indices
        s_bucket = bucket[order]
        dest = _slots(s_bucket, s_bucket < n_dp, n_dp, cap)
        rows = torch.cat([words, lens.to(torch.int64)[:, None],
                          sumq.to(torch.int64)[:, None] & _U32,
                          gidx.to(torch.int64)[:, None],
                          valid.to(torch.int64)[:, None]], dim=1)
        return _bucket_scatter(rows[order], dest, n_dp, cap)

    def dedup(recv):
        r = recv.reshape(-1, recv.shape[-1])
        W = r.shape[1] - 4
        rw, rl, rq, ri = r[:, :W], r[:, W], r[:, W + 1], r[:, W + 2]
        rv = r[:, W + 3] == 1
        # the JAX package negates sumq after an int32 cast; so does this
        perm = _lsd_perm([~rv, *(rw[:, w] for w in range(W)), rl,
                          -(rq.to(torch.int32)), ri])
        sw, sl, sv = rw[perm], rl[perm], rv[perm]
        return sw, sl.to(torch.int32), ri[perm], _heads(sw, sv, sl), sv

    def fn(words, lens, sumq, gidx, valid):
        sent = [send(*a) for a in zip(words, lens, sumq, gidx, valid)]
        out = [dedup(r) for r in comm.all_to_all(sent)]
        return tuple(list(col) for col in zip(*out))

    return fn


def _lex_gt_key(rows: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """rows [b, C] > key [C], lexicographically and strictly."""
    gt = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    eq = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    for c in range(rows.shape[1]):
        gt |= eq & (rows[:, c] > key[c])
        eq &= rows[:, c] == key[c]
    return gt


def _host_u32(words: np.ndarray) -> np.ndarray:
    """uint32 words as their int32 bit patterns, for sharding (torch has
    no general uint32); the shards widen them back."""
    return np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)


def _pull(comm, xs: list[torch.Tensor]) -> np.ndarray:
    """Every shard's tensor, concatenated in shard order, on the host."""
    return torch.cat([x.cpu() for x in comm.collect(xs)]).numpy()


def distributed_sort(mesh: Mesh, words: np.ndarray, lens: np.ndarray,
                     length_first: bool = True, pad_factor: float = 2.0
                     ) -> np.ndarray:
    """Sample sort over 'dp': the multi-device gzfastq_sort.

    words: uint32 [B, W] collation words, lens [B]. Returns int64 perm,
    the original row indices in global key order, equal to the
    single-device lex_argsort(words, lens, length_first): the original
    index is the last key column, so ties resolve as the stable sort
    does."""
    comm = collectives.of(mesh)
    n_dp = mesh.size
    B, W = words.shape
    pad = (-B) % n_dp
    if pad:
        words = np.pad(words, ((0, pad), (0, 0)))
        lens = np.pad(lens, (0, pad))
    gidx = np.arange(len(lens), dtype=np.int32)
    valid = gidx < B
    # Round-robin re-shard: shard d gets rows d, d + n_dp, ... Contiguous
    # shards break the cap when keys follow input position (name sorts of
    # sequentially named reads): one sender would route its whole slice
    # to one bucket. gidx keeps the original index, so perm is unchanged.
    rr = np.arange(len(lens)).reshape(-1, n_dp).T.reshape(-1)
    args = shard_batch_arrays(mesh, _host_u32(words[rr]),
                              np.asarray(lens, np.int32)[rr], gidx[rr],
                              valid[rr])

    def local_sort(words, lens, gidx, valid):
        b = words.shape[0]
        cols = [~valid]
        if length_first:
            cols.append(lens.to(torch.int64) & _U32)
        cols.extend(words[:, w].to(torch.int64) & _U32 for w in range(W))
        cols.append(gidx)
        K = torch.stack([c.to(torch.int64) for c in cols], dim=1)
        perm = _lsd_perm([K[:, c] for c in range(K.shape[1])])
        sK, sv = K[perm], valid[perm]
        samp = torch.arange(n_dp, device=K.device) * b // n_dp
        return sK, sv, sK[samp]

    def route(sK, sv, allsamp):
        b, C = sK.shape
        cap = int(pad_factor * b / n_dp) + 8
        sperm = _lsd_perm([allsamp[:, c] for c in range(C)])
        spl = allsamp[sperm][torch.arange(1, n_dp, device=sK.device) * n_dp
                             - 1]
        # bucket = splitters strictly below the row: nondecreasing over
        # the sorted rows, so a row's place in its bucket is arithmetic
        bucket = torch.zeros(b, dtype=torch.int64, device=sK.device)
        for s in range(n_dp - 1):
            bucket += _lex_gt_key(sK, spl[s])
        rows = torch.cat([sK, sv.to(torch.int64)[:, None]], dim=1)
        return _bucket_scatter(rows, _slots(bucket, sv, n_dp, cap), n_dp,
                               cap)

    def final_sort(recv):
        r = recv.reshape(-1, recv.shape[-1])
        rv = r[:, -1] == 1
        rK = r[:, :-1].clone()
        rK[:, 0] = (~rv).to(torch.int64)  # filler rows last
        perm = _lsd_perm([rK[:, c] for c in range(rK.shape[1])])
        return rK[perm, -1], rv[perm]

    sorted_ = [local_sort(*a) for a in zip(*args)]
    allsamp = comm.all_gather([s[2] for s in sorted_])
    sent = [route(sK, sv, a) for (sK, sv, _), a in zip(sorted_, allsamp)]
    del sorted_
    out = [final_sort(r) for r in comm.all_to_all(sent)]
    oi = _pull(comm, [o[0] for o in out])
    ov = _pull(comm, [o[1] for o in out])
    if int(ov.sum()) != B:
        raise RuntimeError(
            f"bucket overflow: kept {int(ov.sum())} of {B} rows — "
            f"increase pad_factor")
    return oi[ov].astype(np.int64)


def distributed_dedup(mesh: Mesh, words: np.ndarray, lens: np.ndarray,
                      sumq: np.ndarray, pad_factor: float = 2.0):
    """Shard, exchange and dedup per shard (exchange_dedup), then merge.

    words: uint32 [B, W], lens [B], sumq uint32 [B]. Returns (keys uint32
    [G, W], klens int32, counts int64, rep int64) as host arrays in global
    key order (words, then length). rep holds each group's representative
    as an original row index, the first occurrence with the highest
    quality sum: equal to the single-device dedup_groups."""
    comm = collectives.of(mesh)
    n_dp = mesh.size
    B, W = words.shape
    pad = (-B) % n_dp
    if pad:
        words = np.pad(words, ((0, pad), (0, 0)))
        lens = np.pad(lens, (0, pad))
        sumq = np.pad(sumq, (0, pad))
    valid = np.arange(len(lens)) < B
    gidx = np.arange(len(lens), dtype=np.int32)
    args = shard_batch_arrays(mesh, _host_u32(words),
                              np.asarray(lens, np.int32),
                              _host_u32(sumq), gidx, valid)
    sw, sl, si, ih, sv = exchange_dedup(mesh, pad_factor)(*args)
    sw, sl, si, ih, sv = (_pull(comm, x) for x in (sw, sl, si, ih, sv))
    if int(sv.sum()) != B:
        raise RuntimeError(
            f"bucket overflow: received {int(sv.sum())} of {B} rows — "
            f"increase pad_factor")

    # group math per shard slice (valid rows sort first within a shard)
    per = sw.shape[0] // n_dp
    out_keys, out_counts, out_lens, out_rep = [], [], [], []
    for d in range(n_dp):
        sl_ = slice(d * per, (d + 1) * per)
        nv = int(sv[sl_].sum())
        if nv == 0:
            continue
        head_pos = np.flatnonzero(ih[sl_][:nv])
        out_counts.append(np.diff(np.append(head_pos, nv)))
        out_keys.append(sw[sl_][head_pos])
        out_lens.append(sl[sl_][head_pos])
        out_rep.append(si[sl_][head_pos])
    if not out_keys:
        return (np.zeros((0, W), np.uint32), np.zeros(0, np.int32),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    keys = np.concatenate(out_keys).astype(np.uint32)
    klens = np.concatenate(out_lens)
    counts = np.concatenate(out_counts)
    rep = np.concatenate(out_rep).astype(np.int64)
    # global key order: host lexsort over (words..., len)
    order = np.lexsort(tuple([klens] + [keys[:, w]
                                        for w in range(W - 1, -1, -1)]))
    return keys[order], klens[order], counts[order], rep[order]
