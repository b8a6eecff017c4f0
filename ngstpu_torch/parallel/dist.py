"""Sharded QC step and pileup over a mesh (ngstpu/parallel/dist.py).

The reference's single-machine parallelism (per-file pthreads,
fastq_count.c:213-231; the reduceStats merge, fastq_count_kthread.c:180-210;
bam2depth's hash tables, :86-110) becomes read batches sharded over the
mesh's 'dp' axis with the per-shard histograms and pileup deltas merged by
psum (parallel/collectives.py).

Sharded arguments and results are lists of this process's shards, one per
entry of Mesh.shards, as shard_batch_arrays makes them; a replicated
result is one tensor, on the first local shard's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pileup import depth_deltas
from ..ops.qcstep import qc_step
from . import collectives
from .mesh import Mesh

MERGED = ("cycle_hist", "len_hist", "composition")


def shard_batch_arrays(mesh: Mesh, *arrays) -> tuple[list[torch.Tensor], ...]:
    """Each array (numpy or tensor) split by rows over 'dp' and replicated
    over any other axis: for each, a list of this process's shards, each a
    fresh tensor on its shard's device that owns its storage (so a shard
    on the card is aligned and contiguous, as qc_hist needs). Rows must
    divide evenly over 'dp'."""
    n_dp = mesh.axis_size("dp")
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % n_dp:
            raise ValueError(f"{t.shape[0]} rows do not split evenly over "
                             f"{n_dp} 'dp' shards")
        b = t.shape[0] // n_dp
        shards = []
        for s, dev in zip(mesh.shards, mesh.devices):
            r = mesh.coords(s)[0]
            piece = t[r * b:(r + 1) * b]
            own = torch.empty(piece.shape, dtype=piece.dtype, device=dev)
            shards.append(own.copy_(piece))
        out.append(shards)
    return tuple(out)


def sharded_qc_step(mesh: Mesh):
    """Returns fn(seq, qual, lens, n_valid) -> (merged, gc, packed).

    seq/qual [b, L] and lens [b] are sharded over 'dp' (shard_batch_arrays);
    n_valid: the real rows of each 'dp' shard, host ints indexed by the
    shard's 'dp' position. qc_step runs per shard (one qc_hist launch
    each on the card); merged holds the psum of cycle_hist, len_hist and
    composition, replicated; gc and packed stay sharded."""
    comm = collectives.of(mesh)

    def step(seq, qual, lens, n_valid):
        nv = np.asarray(n_valid).reshape(-1)
        outs = [qc_step(s, q, ln, int(nv[mesh.coords(i)[0]]))
                for i, s, q, ln in zip(mesh.shards, seq, qual, lens)]
        merged = {k: comm.psum([o[k] for o in outs])[0] for k in MERGED}
        return merged, [o["gc"] for o in outs], [o["packed"] for o in outs]

    return step


def sharded_pileup(mesh: Mesh, n_pos: int):
    """Returns fn(starts, ends, valid) -> int32 depth [n_pos], replicated.

    Block events are sharded over 'dp'; each shard scatters its deltas,
    the deltas are psum-merged, and one prefix sum gives the depth."""
    comm = collectives.of(mesh)

    def fn(starts, ends, valid):
        d = [depth_deltas(s, e, v, n_pos)
             for s, e, v in zip(starts, ends, valid)]
        total = comm.psum(d)[0]
        return torch.cumsum(total, 0, dtype=torch.int32)[:-1]

    return fn
