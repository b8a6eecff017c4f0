"""The per-batch QC step on torch tensors (ngstpu/ops/qcstep.py:qc_step).

One call over a padded read batch gives what the QC-side tools need
(reference fastq_count.c, bam_sliding_count.c's GC, Rgzfastq_uniq.c's
matrices, twoBit.h's packing):

- the per-cycle quality histogram [L, 128] (fastq_count.c:29-35);
- the read length histogram [512] (fastq_count.c:110-121);
- per-read GC counts [B] (bam_sliding_count.c:84-91);
- per-cycle A/C/G/T/N composition [L, 5] (Rgzfastq_uniq.c:50-57);
- the 2-bit packed sequence [B, L // 4] (twoBit.h:135-181).

The two histograms are the qc_hist kernel's function (a cell counts where
col < lens[row] and row < n_valid, quality bytes >= 128 never, lengths
clip to 0..n_len-1), so they go through kernels/hist_cuda.py: the CUDA
kernel for tensors on the card, its plain version for CPU tensors; an
n_qual below 128 is the kernel's table cut to its first n_qual columns.
GC, composition and the pack are torch ops.
"""

from __future__ import annotations

import torch

from ..kernels.hist_cuda import N_CYCLE, N_QUAL, qc_hist_accumulate_
from .twobit import base_codes

NT_ORDER = b"ACGTN"  # composition column order (Rfastqc's ACGTN)


def qc_step(seq: torch.Tensor, qual: torch.Tensor, lens: torch.Tensor,
            n_valid: int, n_qual: int = N_QUAL, n_len: int = N_CYCLE
            ) -> dict[str, torch.Tensor]:
    """seq/qual uint8 [B, L] (L % 4 == 0), lens int32 [B]; rows from
    n_valid on are padding. Returns int32 cycle_hist [L, n_qual], len_hist
    [n_len], gc [B], composition [L, 5] and uint8 packed [B, L // 4].

    The histograms are one qc_hist_accumulate_ into zeroed totals, so the
    tensors must meet the kernel's preconditions on the card (contiguous,
    qual 16-byte aligned). The kernel counts quality bytes below 128, so
    n_qual may be 1..128."""
    B, L = seq.shape
    if L % 4:
        raise ValueError(f"qc_step packs 4 bases a byte: L={L} is not a "
                         "multiple of 4")
    if not 1 <= n_qual <= N_QUAL:
        raise ValueError(f"qc_step counts quality bytes below {N_QUAL}: "
                         f"n_qual={n_qual}")
    dev = seq.device
    cycle_hist = torch.zeros((L, N_QUAL), dtype=torch.int32, device=dev)
    len_hist = torch.zeros(n_len, dtype=torch.int32, device=dev)
    qc_hist_accumulate_(cycle_hist, len_hist, qual, lens, n_valid)
    cycle_hist = cycle_hist[:, :n_qual].contiguous()
    col = torch.arange(L, device=dev)
    rows = torch.arange(B, device=dev) < int(n_valid)
    mask = (col[None, :] < lens[:, None]) & rows[:, None]
    up = seq & 0xDF  # ASCII uppercase for letters
    gc = (((up == ord("C")) | (up == ord("G"))) & mask).sum(
        1, dtype=torch.int32)
    composition = torch.stack([((up == (b & 0xDF)) & mask).sum(
        0, dtype=torch.int32) for b in NT_ORDER], dim=-1)
    codes = base_codes(seq).reshape(B, L // 4, 4)
    packed = ((codes[..., 0] << 6) | (codes[..., 1] << 4)
              | (codes[..., 2] << 2) | codes[..., 3])
    return dict(cycle_hist=cycle_hist, len_hist=len_hist, gc=gc,
                composition=composition, packed=packed)
