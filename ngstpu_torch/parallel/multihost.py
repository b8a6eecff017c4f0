"""Multi-host scale-out helpers (ngstpu/parallel/multihost.py).

The reference scales out only by thread-per-file on one machine
(fastq_count.c:213-231). Across hosts:

- files are assigned to ranks deterministically (size-descending,
  round-robin onto the least-loaded rank), so every process computes the
  same assignment with no communication;
- each rank processes its files locally;
- fixed-shape statistics (the quality matrix, length histograms,
  counters) are summed over the process group: the reduceStats
  map-reduce (fastq_count_kthread.c:180-210) as a collective.

Start the processes with torchrun (it sets MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE and LOCAL_RANK) and call torch.distributed.init_process_group
("nccl" on cards, "gloo" on the CPU) before use; without a group every
helper is the one-process case.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import group_device


def process_info() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def assign_shards(paths: list[str], rank: int | None = None,
                  world: int | None = None) -> list[str]:
    """Deterministic file-shard assignment: stable size-descending order,
    round-robin over ranks (longest-processing-time heuristic). Every rank
    computes the same global assignment with no communication."""
    r, w = process_info()
    rank = r if rank is None else rank
    world = w if world is None else world
    sizes = []
    for p in paths:
        try:
            sizes.append(os.path.getsize(p))
        except OSError:
            sizes.append(0)
    order = sorted(range(len(paths)), key=lambda i: (-sizes[i], paths[i]))
    loads = [0] * world
    mine = []
    for i in order:
        tgt = min(range(world), key=lambda k: loads[k])
        loads[tgt] += max(sizes[i], 1)
        if tgt == rank:
            mine.append(paths[i])
    return mine


def allreduce_stats(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Sum fixed-shape host statistics over the process group, on the
    group's device (the card under NCCL); one process: the identity.

    The sums keep each array's dtype. The JAX package's version goes
    through jnp.asarray, which makes int64 statistics int32 (no x64) and
    returns np.sum's int64; the two agree wherever the sums fit int32."""
    import torch.distributed as dist

    _, world = process_info()
    if world == 1:
        return arrays
    dev = group_device()
    out = {}
    for k, v in arrays.items():
        t = torch.tensor(np.asarray(v), device=dev)  # a copy: reduced in place
        dist.all_reduce(t)
        out[k] = t.cpu().numpy()
    return out
