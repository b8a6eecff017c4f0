"""Entry points of the parallel layer: one QC step, and a dry run of every
sharded path on small shapes (the port's counterpart of the repo root's
__graft_entry__.py, entry and dryrun_multichip).

entry() returns the QC step that backs fastq_count, fastqc and
fastq2twobit with example tensors. dryrun_multichip(n) builds an n-shard
mesh and runs five phases, each checked against a host oracle:
data-parallel QC (psum over 'dp'), a pileup over a ('dp', 'coord') mesh
whose prefix sum is sharded over 'coord', the distributed dedup, the
distributed sort, and the paired-end dedup.

    python -m ngstpu_torch.parallel.dryrun [N] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..io.native import concat_pairs
from ..ops.pileup import depth_deltas
from ..ops.qcstep import qc_step
from ..ops.sortengine import pack_words
from ..utils.device import resolve_device
from . import collectives
from .dist import shard_batch_arrays, sharded_qc_step
from .dsort import distributed_dedup, distributed_sort
from .mesh import make_mesh, spread_devices


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun: {msg}")


def entry(device: str | torch.device = "cuda"):
    """(qc_step, (seq, qual, lens, n_valid)) at B = 1024, L = 128."""
    dev = resolve_device(device)
    B, L = 1024, 128
    rng = np.random.default_rng(0)
    seq = torch.from_numpy(rng.integers(65, 85, (B, L), dtype=np.uint8))
    qual = torch.from_numpy(rng.integers(33, 75, (B, L), dtype=np.uint8))
    lens = torch.full((B,), 100, dtype=torch.int32)
    return qc_step, (seq.to(dev), qual.to(dev), lens.to(dev), B)


def pe_key(seq1: np.ndarray, l1: np.ndarray, seq2: np.ndarray,
           l2: np.ndarray, device: torch.device):
    """The paired-end dedup key (gzfastq_uniq.c:212-216): each pair's
    mates concatenated, zero-padded to a multiple of 16 bytes, and packed
    into 2-bit words. Returns (key bytes, uint32 words, int32 key lens)."""
    key_pad = -(-(seq1.shape[1] + seq2.shape[1]) // 16) * 16
    key = concat_pairs(seq1, l1, seq2, l2, key_pad)
    return (key, pack_words(key, "dna2", device),
            (l1.astype(np.int64) + l2).astype(np.int32))


def pileup_2d(mesh, n_pos: int):
    """fn(starts, ends, valid) -> int32 depth [n_pos] on a ('dp', 'coord')
    mesh: each shard scatters its 'dp' slice of events over the whole
    range, the deltas are psum-merged over 'dp', and each shard sweeps
    only its 'coord' block (a local prefix sum plus the sum of the deltas
    before the block), so the prefix sum is sharded over 'coord'."""
    comm = collectives.of(mesh)
    blk = n_pos // mesh.axis_size("coord")

    def fn(starts, ends, valid):
        d = [depth_deltas(s, e, v, n_pos)[:-1]
             for s, e, v in zip(starts, ends, valid)]
        d = comm.psum(d, "dp")
        out = []
        for dd, k in zip(d, comm.axis_index("coord")):
            block = dd[k * blk:(k + 1) * blk]
            offset = dd[:k * blk].sum(dtype=torch.int32)
            out.append(torch.cumsum(block, 0, dtype=torch.int32) + offset)
        # out_specs P('coord'): the blocks of the shards at dp 0, in order
        parts = comm.collect(out)
        return torch.cat([parts[s].cpu() for s in range(mesh.size)
                          if mesh.coords(s)[0] == 0])

    return fn


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda"
                     ) -> None:
    """The five phases on n_devices shards of `device` (shards cycle over
    the cards; all on the CPU for "cpu"). Raises RuntimeError on a
    mismatch."""
    dev = resolve_device(device)
    devs = spread_devices(n_devices, dev)

    # ---- Phase 1: data-parallel QC over a 1-D 'dp' mesh
    mesh = make_mesh(n_devices, devices=devs)
    n_dp = n_devices
    B, L = 64 * n_dp, 128
    rng = np.random.default_rng(0)
    seq = rng.integers(65, 85, (B, L), dtype=np.uint8)
    qual = rng.integers(33, 75, (B, L), dtype=np.uint8)
    lens = np.full(B, 100, dtype=np.int32)
    n_valid = np.full(n_dp, 64, dtype=np.int32)
    merged, gc, packed = sharded_qc_step(mesh)(
        *shard_batch_arrays(mesh, seq, qual, lens), n_valid)
    _check(int(merged["len_hist"].sum()) == B, "QC length histogram")
    _check(int(merged["cycle_hist"].sum()) == B * 100, "QC cycle histogram")

    # ---- Phase 2: pileup over a 2-D mesh, events over 'dp', the prefix
    # sum over 'coord' (sequence parallelism)
    coord = 2 if n_devices % 2 == 0 else 1
    mesh2 = make_mesh(n_devices, coord=coord, devices=devs)
    n_pos = 512 * coord
    E = 32 * (n_devices // coord)
    starts = rng.integers(0, n_pos - 50, E).astype(np.int32)
    ends = (starts + rng.integers(1, 50, E)).astype(np.int32)
    valid = np.ones(E, dtype=bool)
    depth = pileup_2d(mesh2, n_pos)(
        *shard_batch_arrays(mesh2, starts, ends, valid)).numpy()
    oracle = np.zeros(n_pos, dtype=np.int64)
    for s, e in zip(starts, ends):
        oracle[s:e] += 1
    _check((depth == oracle).all(), "sharded pileup mismatch")

    # ---- Phase 3: distributed dedup (hash-bucket all_to_all over 'dp')
    Bd, W = 64 * n_devices, 4
    words = rng.integers(0, 5, (Bd, W)).astype(np.uint32)
    lens_d = np.full(Bd, 16, np.int32)
    sumq = rng.integers(0, 100, Bd).astype(np.uint32)
    keys, klens, counts, rep = distributed_dedup(mesh, words, lens_d, sumq)
    _check(counts.sum() == Bd, "distributed dedup lost rows")
    _check(len(rep) == len(counts) and (rep < Bd).all(),
           "distributed dedup representatives")

    # ---- Phase 4: distributed sort (sample sort) against a host lexsort
    Bs = 48 * n_devices
    words_s = rng.integers(0, 1 << 16, (Bs, 3)).astype(np.uint32)
    lens_s = rng.integers(1, 40, Bs).astype(np.int32)
    perm = distributed_sort(mesh, words_s, lens_s, length_first=True)
    # the bytes of the big-endian word view collate like the words
    padded = np.ascontiguousarray(words_s).astype(">u4").view(np.uint8) \
        .reshape(Bs, -1)
    expect = np.lexsort([padded[:, i] for i in range(padded.shape[1] - 1,
                                                      -1, -1)] + [lens_s])
    _check((perm == expect).all(), "distributed sort order mismatch")

    # ---- Phase 5: paired-end dedup (key = both mates, sumQ over both,
    # gzfastq_uniq.c:212-216) against a brute-force groupby
    Bp = 40 * n_devices
    L1, L2 = 11, 14
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pool1 = acgt[rng.integers(0, 4, (6, L1))]
    pool2 = acgt[rng.integers(0, 4, (6, L2))]
    pick = rng.integers(0, 6, Bp)  # 6 distinct pairs: heavy duplication
    seq1 = np.ascontiguousarray(pool1[pick])
    seq2 = np.ascontiguousarray(pool2[pick])
    key, words_pe, key_lens = pe_key(seq1, np.full(Bp, L1, np.int32), seq2,
                                     np.full(Bp, L2, np.int32), dev)
    sumq_pe = rng.integers(0, 1000, Bp).astype(np.uint32)
    _, _, counts_pe, rep_pe = distributed_dedup(mesh, words_pe, key_lens,
                                                sumq_pe)
    _check(counts_pe.sum() == Bp, "PE distributed dedup lost rows")
    # count and first strictly-best-sumQ representative, in key order
    order = {}
    for i in range(Bp):
        g = order.setdefault(key[i].tobytes(), [0, i])
        g[0] += 1
        if sumq_pe[i] > sumq_pe[g[1]]:
            g[1] = i
    exp = sorted(order.items())
    _check([c for _, (c, _) in exp] == list(counts_pe), "PE dedup counts")
    _check([r for _, (_, r) in exp] == list(rep_pe), "PE dedup reps")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    dev = resolve_device(device)
    n = int(argv[0]) if argv else (
        torch.cuda.device_count() if dev.type == "cuda" else 1)
    fn, args = entry(dev)
    out = fn(*args)
    _check(int(out["len_hist"].sum()) == args[0].shape[0], "entry()")
    print("entry() ran OK")
    dryrun_multichip(n, dev)
    print(f"dryrun_multichip({n}) on {dev.type} OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
