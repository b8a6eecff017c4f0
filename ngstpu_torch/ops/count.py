"""QC counting: per-cycle quality histogram + read-length histogram (torch).

Mirrors ngstpu/ops/count.py. Totals accumulate ON the device across
batches (updated in place by kernels/hist_cuda.py) and are pulled to the
host once per file. On CUDA the hand-written kernel always runs; on the
CPU its plain PyTorch version does.

Parity notes (same as the JAX package):
- Q20/Q30 thresholds are raw ASCII >=53 / >=63 (reference fastq_count.c:124).
- 128 quality rows x 512 cycles, 512 length bins; longer reads are clipped.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..kernels.hist_cuda import (N_CYCLE, N_QUAL, masked_hist,
                                 qc_hist_accumulate_)
from ..utils.device import resolve_device
from ..utils.linkprobe import link_verdict, probe_link

Q20_ASCII = 53
Q30_ASCII = 63


def qc_histograms(qual: torch.Tensor, lens: torch.Tensor, n_valid: int,
                  n_qual: int = N_QUAL, n_len: int = N_CYCLE):
    """Per-batch QC histograms, plain torch (ngstpu/ops/count.py:qc_histograms).

    qual: uint8 [B, L]; lens: int32 [B]; n_valid: rows that count.
    Returns (cycle_hist int32 [L, n_qual], len_hist int32 [n_len]): the
    kernel's plain version (hist_cuda.masked_hist) without the clip at 512
    cycles.
    """
    return masked_hist(qual, lens, n_valid, qual.shape[1], n_qual, n_len)


class QCAccumulator:
    """Accumulates batch histograms into the C-layout totals.

    Device accumulation is the default (int32 totals on `device`, updated
    in place); NGSTPU_QC=host, or an 'auto' link verdict of host, counts
    with the native threaded histogram instead. Both count exactly.
    """

    def __init__(self, device: str | torch.device):
        self.device = resolve_device(device)
        self._dev_q = torch.zeros((N_CYCLE, N_QUAL), dtype=torch.int32,
                                  device=self.device)  # [cycle, qual]
        self._dev_len = torch.zeros(N_CYCLE, dtype=torch.int32,
                                    device=self.device)
        self._host_q: np.ndarray | None = None
        self._host_len: np.ndarray | None = None
        self._acc_q: np.ndarray | None = None  # host-side partials
        self._acc_len: np.ndarray | None = None
        # NGSTPU_QC = device | host | auto (ngstpu/ops/count.py:_qc_placement)
        self._mode = os.environ.get("NGSTPU_QC", "auto")

    @classmethod
    def from_host_partials(cls, hist_q: np.ndarray,
                           hist_len: np.ndarray) -> "QCAccumulator":
        """Wrap host histograms (e.g. the fused native index pass) without
        touching a device. hist_q: [N_CYCLE, N_QUAL]; hist_len: [N_CYCLE]."""
        acc = cls.__new__(cls)
        acc.device = None
        acc._dev_q = None
        acc._dev_len = None
        acc._host_q = hist_q.astype(np.int64).T  # [qual, cycle]
        acc._host_len = hist_len.astype(np.int64)
        acc._acc_q = None
        acc._acc_len = None
        acc._mode = "host"
        return acc

    @classmethod
    def from_state(cls, dev_q: np.ndarray, dev_len: np.ndarray,
                   device: str | torch.device) -> "QCAccumulator":
        """Continue from another accumulator's device totals, given as host
        arrays: int32 [N_CYCLE, N_QUAL] and int32 [N_CYCLE] (for the JAX
        package's accumulator: np.asarray(acc._dev_q), acc._dev_len)."""
        acc = cls(device)
        acc._dev_q.copy_(torch.tensor(np.asarray(dev_q, dtype=np.int32)))
        acc._dev_len.copy_(torch.tensor(np.asarray(dev_len, dtype=np.int32)))
        return acc

    def _add_host(self, qual: np.ndarray, lens: np.ndarray,
                  n_valid: int) -> bool:
        from ..io.native import get_lib

        lib = get_lib()
        if lib is None:
            return False
        if self._acc_q is None:
            self._acc_q = np.zeros((N_CYCLE, N_QUAL), np.uint64)
            self._acc_len = np.zeros(N_CYCLE, np.uint64)
        q = np.ascontiguousarray(qual[:n_valid])
        l32 = np.ascontiguousarray(lens[:n_valid], np.int32)
        if n_valid:
            lib.ngs_qc_hist(q, l32, n_valid, q.shape[1], N_QUAL, N_CYCLE,
                            self._acc_q, self._acc_len, 0)
        self._host_q = None
        return True

    def add_batch(self, qual: np.ndarray, lens: np.ndarray,
                  n_valid: int | None = None) -> None:
        """Accumulate one batch; rows >= n_valid are ignored. The batch is
        copied to the device synchronously, so the caller may reuse its
        buffers as soon as this returns."""
        if n_valid is None:
            n_valid = qual.shape[0]
        mode = self._mode
        if mode == "auto":
            # probe the link once per process with an ~8MB copy; tiny
            # batches skip the probe (device path)
            if link_verdict() is None and qual.nbytes >= (8 << 20):
                probe_link(qual)
            mode = link_verdict() or "device"
        if mode == "host" and self._add_host(qual, lens, n_valid):
            return
        self._host_q = None
        q = torch.from_numpy(np.ascontiguousarray(qual)).to(self.device)
        ln = torch.from_numpy(np.ascontiguousarray(lens, np.int32)).to(
            self.device)
        qc_hist_accumulate_(self._dev_q, self._dev_len, q, ln, n_valid)

    def _materialize(self) -> None:
        if self._host_q is None:
            dq = self._dev_q.cpu().numpy().astype(np.int64)
            dl = self._dev_len.cpu().numpy().astype(np.int64)
            if self._acc_q is not None:
                dq = dq + self._acc_q.astype(np.int64)
                dl = dl + self._acc_len.astype(np.int64)
            self._host_q = dq.T  # [qual, cycle]
            self._host_len = dl

    @property
    def quality(self) -> np.ndarray:
        self._materialize()
        return self._host_q

    @property
    def seq_len(self) -> np.ndarray:
        self._materialize()
        return self._host_len

    def merge(self, other: "QCAccumulator") -> None:
        self._materialize()
        other._materialize()
        self._host_q = self._host_q + other._host_q
        self._host_len = self._host_len + other._host_len

    def stats(self) -> dict:
        """Reproduces statSeqLen + statQ (reference fastq_count.c:37-74)."""
        freq = self.seq_len
        nz = np.flatnonzero(freq)
        sum_freq = int(freq.sum())
        total_len = float(np.sum(freq.astype(np.float64) * np.arange(N_CYCLE)))
        # C quirk (fastq_count.c:70): minLen is only set while it is still 0,
        # so a length-0 bin can never register; min is the first nonzero index.
        min_len = int(nz[0]) if len(nz) else 0
        max_len = int(nz[-1]) if len(nz) else 0
        qsum = int(self.quality.sum())
        q20 = int(self.quality[Q20_ASCII:, :].sum())
        q30 = int(self.quality[Q30_ASCII:, :].sum())
        return dict(read_count=sum_freq, base_count=total_len,
                    mean_len=(total_len / sum_freq) if sum_freq else float("nan"),
                    min_len=min_len, max_len=max_len,
                    q20_pct=(q20 / qsum * 100.0) if qsum else float("nan"),
                    q30_pct=(q30 / qsum * 100.0) if qsum else float("nan"),
                    qual_sum=qsum)
