"""Coverage as a scatter of block events (ngstpu/ops/pileup.py).

The reference sweeps per-chromosome hash tables of alignment-block starts
and ends (bam2depth.c:86-110, 203-236). Here +1 lands at each block start
and -1 at each block end in a coordinate-indexed delta array; depth is
its prefix sum. Only depth_deltas is ported: the sharded pileup
(parallel/dist.py) is its one caller.
"""

from __future__ import annotations

import torch


def depth_deltas(starts: torch.Tensor, ends: torch.Tensor,
                 valid: torch.Tensor, n_pos: int) -> torch.Tensor:
    """Block events into an int32 delta array of n_pos + 1.

    starts/ends: int [E], 0-based blocks [start, end), clipped to
    0..n_pos; valid: bool [E]. Depth over [0, n_pos) is
    cumsum(deltas)[:-1]."""
    w = valid.to(torch.int32)
    d = torch.zeros(n_pos + 1, dtype=torch.int32, device=starts.device)
    d.index_add_(0, starts.clamp(0, n_pos).to(torch.int64), w)
    d.index_add_(0, ends.clamp(0, n_pos).to(torch.int64), -w)
    return d
