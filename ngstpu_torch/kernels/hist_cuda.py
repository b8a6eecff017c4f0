"""Per-cycle quality histogram: the CUDA kernel and its plain version.

Mirrors ngstpu/kernels/hist_pallas.py (qc_hist_pallas) plus the XLA glue of
ngstpu/ops/count.py:_accumulate_pallas. The kernel (csrc/qc_hist.cu) adds
one batch into the device totals in place: int32 [n_cycle, 128]
cycle-major quality counts and int32 [n_len] length counts, where n_cycle
and n_len are the totals' own sizes (512/512 for QCAccumulator, as
count.py:_accumulate clips; L and max_len + 2 for fastqc_stats). That
in-place update replaces the JAX package's donated buffers (count.py:62).

plan_launch sizes a launch (tiles, ring stages, shared memory, grid) in
Python, so the CPU tests reach it. The wrapper launches the kernel for
CUDA tensors and runs the plain PyTorch version only for CPU tensors;
there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

N_QUAL = 128
N_CYCLE = 512

# kernel launches made through qc_hist_accumulate_ (read by chip_smoke.py);
# fastq_count's per-file threads launch concurrently, hence the lock
LAUNCHES = 0
_launch_lock = threading.Lock()

TILE_MAX = 128        # cycles per tile: a [128 x 128] int32 table is 64 KB
WARPS = 32            # warps per block, one block per SM; a warp counts
                      # whole rows
STAGES = 3            # ring stages (csrc/qc_hist.cu:kStages)
CHUNK_ROWS_MAX = 512  # rows of one ring stage
LEN_BINS_MAX = 512    # length bins counted in shared memory
SMEM_MAX = 232448     # shared memory one H100 block may take (227 KB)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of csrc/qc_hist.cu. grid_y tiles of tile_c cycles; each
    block streams row chunks of rows_per_chunk rows through STAGES ring
    stages, each row's live tile bytes in a slot of `pitch` bytes; smem is
    the dynamic shared memory of one block."""
    n_rows: int
    n_cycle: int
    n_len: int
    tile_c: int
    grid_x: int
    grid_y: int
    threads: int
    rows_per_chunk: int
    pitch: int
    row_shift: int
    len_bins: int
    smem: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan_launch(B: int, L: int, n_cycle: int = N_CYCLE, n_len: int = N_CYCLE,
                n_rows: int | None = None, slots: int | None = None) -> Plan:
    """The launch for a [B, L] batch counted into [n_cycle, 128] and
    [n_len] totals over its first n_rows rows (default B).

    Cycles min(L, n_cycle) split into equal tiles of at most TILE_MAX,
    rounded up to a multiple of 32 (a lane counts one cycle of each 32);
    a block has WARPS warps, each staging and counting whole rows. A
    row's tile segment spans at most tile_c // 16 + 2 aligned 16-byte
    words, the slot's pitch. The table, the length bins and the ring fill
    one SM's shared memory, with as many rows per stage as fit, a
    multiple of WARPS, at most CHUNK_ROWS_MAX. `slots` is the card's
    resident blocks (SMs x blocks per SM): the grid strides over the row
    chunks with at most slots // grid_y blocks per tile; without `slots`,
    one block per chunk."""
    n_rows = B if n_rows is None else max(0, min(int(n_rows), B))
    C = max(1, min(L, n_cycle))
    grid_y = _ceil(C, TILE_MAX)
    tile_c = _ceil(_ceil(C, grid_y), 32) * 32
    pitch = 16 * ((tile_c + 14) // 16 + 1)
    len_bins = _ceil(min(n_len, LEN_BINS_MAX), 4) * 4
    table = 4 * (N_QUAL * tile_c + len_bins)
    # each stage: the rows' slots, lengths and (live, offset) int pairs
    rows_per_chunk = max(WARPS, min(CHUNK_ROWS_MAX, (SMEM_MAX - table)
                                    // (STAGES * (pitch + 12)))
                         // WARPS * WARPS)
    smem = table + STAGES * rows_per_chunk * (pitch + 12)
    # 2**row_shift threads stage one row: as many as the block has to spare
    row_shift = max(0, (32 * WARPS // rows_per_chunk).bit_length() - 1)
    chunks = max(1, _ceil(n_rows, rows_per_chunk))
    grid_x = chunks
    if slots is not None:
        grid_x = min(grid_x, max(1, slots // grid_y))
    return Plan(n_rows=n_rows, n_cycle=n_cycle, n_len=n_len, tile_c=tile_c,
                grid_x=grid_x, grid_y=grid_y, threads=32 * WARPS,
                rows_per_chunk=rows_per_chunk, pitch=pitch,
                row_shift=row_shift, len_bins=len_bins, smem=smem)


def bound_bytes(lens: torch.Tensor, n_rows: int, L: int, n_cycle: int
                ) -> int:
    """Bytes one launch must move at least: each live quality byte
    (c < min(lens[r], L, n_cycle)) and 4 bytes of lens per row, read once,
    as csrc/qc_hist.cu defines its bound. The totals are left out: at most
    min(L, n_cycle) x 128 + n_len cells, the same for any batch size."""
    live = int(lens[:n_rows].to(torch.int64).clamp(0, min(L, n_cycle)).sum())
    return live + 4 * n_rows


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


def qc_hist_plain(qual: torch.Tensor, lens: torch.Tensor, n_valid: int,
                  n_cycle: int = N_CYCLE, n_len: int = N_CYCLE
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: masked_hist into
    (int32 [n_cycle, 128], int32 [n_len])."""
    return masked_hist(qual, lens, n_valid, n_cycle, N_QUAL, n_len)


def _check(total_q, total_len, qual, lens) -> None:
    dev = qual.device
    if qual.dtype != torch.uint8 or qual.dim() != 2:
        raise ValueError(f"qual must be uint8 [B, L], got {qual.dtype} "
                         f"{tuple(qual.shape)}")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (qual.shape[0],):
        raise ValueError(f"lens must be int32 [{qual.shape[0]}], got "
                         f"{lens.dtype} {tuple(lens.shape)}")
    if total_q.dtype != torch.int32 or total_q.dim() != 2 or \
            total_q.shape[0] < 1 or total_q.shape[1] != N_QUAL:
        raise ValueError("total_q must be int32 [n_cycle, 128], got "
                         f"{total_q.dtype} {tuple(total_q.shape)}")
    if total_len.dtype != torch.int32 or total_len.dim() != 1 or \
            total_len.shape[0] < 1:
        raise ValueError("total_len must be int32 [n_len], got "
                         f"{total_len.dtype} {tuple(total_len.shape)}")
    for t in (total_q, total_len, lens):
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")


def _lib():
    from .build import load

    lib = load("qc_hist")
    if lib.qc_hist_cuda.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qc_hist_cuda.argtypes = [vp, vp, i64, i64] + [i32] * 11 \
            + [i64, vp, vp, i32, vp]
        lib.qc_hist_cuda.restype = i32
        lib.qc_hist_cuda_occupancy.argtypes = [
            i32, i64, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
        lib.qc_hist_cuda_occupancy.restype = i32
        lib.qc_hist_cuda_error.argtypes = [i32]
        lib.qc_hist_cuda_error.restype = ctypes.c_char_p
    return lib


_slots: dict[tuple, int] = {}


def resident_blocks(dev: torch.device, threads: int, smem: int) -> int:
    """SMs x resident blocks per SM for one block shape on `dev`."""
    key = (dev.index, threads, smem)
    if key not in _slots:
        lib = _lib()
        bps, sms = ctypes.c_int(0), ctypes.c_int(0)
        err = lib.qc_hist_cuda_occupancy(threads, smem, dev.index,
                                         ctypes.byref(bps), ctypes.byref(sms))
        if err != 0 or bps.value < 1:
            raise RuntimeError("qc_hist occupancy query failed: "
                               f"{lib.qc_hist_cuda_error(err).decode()} "
                               f"({bps.value} blocks per SM)")
        _slots[key] = bps.value * sms.value
    return _slots[key]


def qc_hist_accumulate_(total_q: torch.Tensor, total_len: torch.Tensor,
                        qual: torch.Tensor, lens: torch.Tensor,
                        n_valid: int) -> None:
    """Add one batch's histograms into total_q / total_len IN PLACE.

    The port's counterpart of count.py's donated-buffer _accumulate_pallas:
    the caller's device totals ([n_cycle, 128] and [n_len], any sizes) are
    updated where they lie instead of being returned as new buffers. CUDA
    tensors go through the kernel, which is launched on the current stream
    without synchronising; CPU tensors go through qc_hist_plain. The
    caller may drop its input tensors as soon as this returns: the caching
    allocator reuses their memory only in the current stream's order,
    after the kernel.
    """
    global LAUNCHES
    _check(total_q, total_len, qual, lens)
    n_cycle, n_len = total_q.shape[0], total_len.shape[0]
    dev = qual.device
    if dev.type == "cpu":
        hq, hl = qc_hist_plain(qual, lens, n_valid, n_cycle, n_len)
        total_q += hq
        total_len += hl
        return
    if dev.type != "cuda":
        raise ValueError(f"qc_hist_accumulate_: unsupported device {dev}")
    for t in (total_q, total_len, qual, lens):
        if not t.is_contiguous():
            raise ValueError("qc_hist_accumulate_ needs contiguous tensors")
    if qual.data_ptr() % 16:
        raise ValueError("qc_hist_accumulate_ needs qual 16-byte aligned")
    B, L = qual.shape
    n_rows = max(0, min(int(n_valid), B))
    if n_rows == 0:
        return
    plan = plan_launch(B, L, n_cycle, n_len, n_rows)
    plan = plan_launch(B, L, n_cycle, n_len, n_rows,
                       slots=resident_blocks(dev, plan.threads, plan.smem))
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.qc_hist_cuda(
        qual.data_ptr(), lens.data_ptr(), n_rows, B * L, L, n_cycle, n_len,
        plan.tile_c, plan.rows_per_chunk, plan.pitch, plan.row_shift,
        plan.len_bins, plan.grid_x, plan.grid_y, plan.threads, plan.smem,
        total_q.data_ptr(), total_len.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError("qc_hist kernel launch failed: "
                           f"{lib.qc_hist_cuda_error(err).decode()}")
    with _launch_lock:
        LAUNCHES += 1
