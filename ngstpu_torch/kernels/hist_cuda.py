"""Per-cycle quality histogram: the CUDA kernel and its plain version.

Mirrors ngstpu/kernels/hist_pallas.py (qc_hist_pallas) plus the XLA glue of
ngstpu/ops/count.py:_accumulate_pallas. The kernel (csrc/qc_hist.cu) adds
one batch into the device totals in place: int32 [512, 128] cycle-major
quality counts and int32 [512] length counts. That in-place update replaces
the JAX package's donated buffers (count.py:62).

The wrapper launches the kernel for CUDA tensors and runs the plain PyTorch
version only for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import threading

import torch

N_QUAL = 128
N_CYCLE = 512

# kernel launches made through qc_hist_accumulate_ (read by chip_smoke.py);
# fastq_count's per-file threads launch concurrently, hence the lock
LAUNCHES = 0
_launch_lock = threading.Lock()


def masked_hist(qual: torch.Tensor, lens: torch.Tensor, n_valid: int,
                n_cycle: int, n_qual: int = N_QUAL, n_len: int = N_CYCLE
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked bincount over cycle * n_qual + q, the one plain histogram.

    qual uint8 [B, L], lens int32 [B]. Returns (int32 [n_cycle, n_qual]
    cycle-major, int32 [n_len]) counts over rows < n_valid, cycles
    < min(lens[row], n_cycle) and quality bytes < n_qual; lengths clip to
    0..n_len-1.
    """
    B, L = qual.shape
    n = max(0, min(int(n_valid), B))
    C = min(L, n_cycle)
    q = qual[:n, :C].to(torch.int64)
    ln = lens[:n].to(torch.int64)
    col = torch.arange(C, device=qual.device)
    mask = (col[None, :] < ln[:, None]) & (q < n_qual)
    cells = (col[None, :] * n_qual + q)[mask]
    hq = torch.bincount(cells, minlength=n_cycle * n_qual)
    hl = torch.bincount(ln.clamp(0, n_len - 1), minlength=n_len)
    return hq.to(torch.int32).view(n_cycle, n_qual), hl.to(torch.int32)


def qc_hist_plain(qual: torch.Tensor, lens: torch.Tensor, n_valid: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: masked_hist clipped to 512
    cycles, as (int32 [512, 128], int32 [512])."""
    return masked_hist(qual, lens, n_valid, N_CYCLE)


def _check(total_q, total_len, qual, lens) -> None:
    dev = qual.device
    if qual.dtype != torch.uint8 or qual.dim() != 2:
        raise ValueError(f"qual must be uint8 [B, L], got {qual.dtype} "
                         f"{tuple(qual.shape)}")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (qual.shape[0],):
        raise ValueError(f"lens must be int32 [{qual.shape[0]}], got "
                         f"{lens.dtype} {tuple(lens.shape)}")
    if total_q.dtype != torch.int32 or \
            tuple(total_q.shape) != (N_CYCLE, N_QUAL):
        raise ValueError("total_q must be int32 [512, 128]")
    if total_len.dtype != torch.int32 or tuple(total_len.shape) != (N_CYCLE,):
        raise ValueError("total_len must be int32 [512]")
    for t in (total_q, total_len, lens):
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")


def _lib():
    from .build import load

    lib = load("qc_hist")
    if lib.qc_hist_cuda.argtypes is None:
        vp = ctypes.c_void_p
        lib.qc_hist_cuda.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int,
                                     vp, vp, ctypes.c_int, vp]
        lib.qc_hist_cuda.restype = ctypes.c_int
        lib.qc_hist_cuda_error.argtypes = [ctypes.c_int]
        lib.qc_hist_cuda_error.restype = ctypes.c_char_p
    return lib


def qc_hist_accumulate_(total_q: torch.Tensor, total_len: torch.Tensor,
                        qual: torch.Tensor, lens: torch.Tensor,
                        n_valid: int) -> None:
    """Add one batch's histograms into total_q / total_len IN PLACE.

    The port's counterpart of count.py's donated-buffer _accumulate_pallas:
    the caller's device totals are updated where they lie instead of being
    returned as new buffers. CUDA tensors go through the kernel, which is
    launched on the current stream without synchronising; CPU tensors go
    through qc_hist_plain. The caller may drop its input tensors as soon
    as this returns: the caching allocator reuses their memory only in
    the current stream's order, after the kernel.
    """
    global LAUNCHES
    _check(total_q, total_len, qual, lens)
    dev = qual.device
    if dev.type == "cpu":
        hq, hl = qc_hist_plain(qual, lens, n_valid)
        total_q += hq
        total_len += hl
        return
    if dev.type != "cuda":
        raise ValueError(f"qc_hist_accumulate_: unsupported device {dev}")
    for t in (total_q, total_len, qual, lens):
        if not t.is_contiguous():
            raise ValueError("qc_hist_accumulate_ needs contiguous tensors")
    B, L = qual.shape
    n_rows = max(0, min(int(n_valid), B))
    if n_rows == 0:
        return
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.qc_hist_cuda(qual.data_ptr(), lens.data_ptr(), n_rows, L,
                           total_q.data_ptr(), total_len.data_ptr(),
                           dev.index, stream)
    if err != 0:
        raise RuntimeError("qc_hist kernel launch failed: "
                           f"{lib.qc_hist_cuda_error(err).decode()}")
    with _launch_lock:
        LAUNCHES += 1
