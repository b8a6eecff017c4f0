// Per-cycle quality histogram + read-length histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ngstpu/kernels/hist_pallas.py
// (_hist_kernel, launched by qc_hist_pallas) together with the XLA work
// around it in ngstpu/ops/count.py:_accumulate_pallas (the [L, 128]
// transpose, the cycle clip, the length histogram and the add into the
// running totals). One launch adds one batch into int32 totals in place:
//
//   total_q[c, q] += #{r < n_rows : c < min(lens[r], n_cycle), qual[r, c] == q}
//                    for q < 128 (bytes >= 128 are never counted)
//   total_len[clip(lens[r], 0, n_len - 1)] += 1   for r < n_rows
//
// n_cycle and n_len are launch parameters: QCAccumulator passes 512/512,
// fastqc_stats passes n_cycle = L and max_len + 2 length bins.
//
// Bound. The function must read each live quality byte (c < lens[r]) and
// 4 bytes of lens per row once; at 3.35 TB/s that is the least time the
// card could take (hist_cuda.bound_bytes). The totals, at most
// min(L, n_cycle) x 128 + n_len cells whatever the batch, are left out.
// The arithmetic is one compare and one add per byte, far under any peak
// rate.
//
// Design (kernels/hist_cuda.py:plan_launch computes every size below):
// - One 1024-thread block per SM and cycle tile. A tile is up to 128
//   cycles (a multiple of 32); its [128 q x tile] int32 table lives in
//   dynamic shared memory (64 KB at 128 cycles) beside the ring; longer
//   batches (fastqc at L = 600, the 512-cycle clip at L = 640) take more
//   tiles. The blocks of tile 0 count the length histogram as they stage
//   each row.
// - Bank spread. Cell (q, c) is table[q * tile + c], and lane l of a warp
//   counts cycles l + 32 g of one row, so the 32 lanes fall in 32 banks
//   whatever qualities they hold: binned NovaSeq data (4 values, mostly
//   'F') and uniform data alike are free of bank conflicts.
// - The batch streams through a three-stage shared-memory ring with
//   16-byte cp.async copies: while the block counts chunk k, the copies of
//   chunks k + 1 and k + 2 are in flight, and the lengths of chunk k + 4
//   (they decide which words chunk k + 2 copies). Only the 16-byte words
//   that hold live bytes of the tile are copied, so the padding past each
//   read is never read from device memory. Words are 16-byte aligned in
//   device memory and each row's segment lands at its own offset mod 16
//   in its slot, so any L works (100, 128, 600, 640); a word past the
//   tensor's end is copied byte by byte. Threads share the rows of a chunk
//   for the copies, so every warp stages about the same number of words.
// - Counting: a warp takes whole rows; each lane loads its live bytes of
//   the row first and then adds them to its cells with shared atomics
//   that depend on nothing, so they stream. (On the H100 three other
//   designs were slower: a per-lane run counter for repeated values,
//   private per-warp tables without atomics, and one TMA bulk copy per row
//   completing on an mbarrier in place of the cp.async words.)
// - Persistent grid: SMs / tiles blocks stride over the row chunks, and
//   each block merges its nonzero cells into the totals once, at the end,
//   with global atomics (red.global.add). Every count is an integer, so
//   the result is exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNQual = 128;
constexpr int kStages = 3;  // ring stages: the words of two chunks in flight
constexpr int kGroups = 4;  // 32-cycle groups of a tile: tile_c <= 128

struct Params {
  const uint8_t* qual;
  const int32_t* lens;
  long long n_rows;       // rows counted (min(n_valid, B))
  long long total_bytes;  // B * L: no byte at or past it is read
  int L;
  int n_cycle;            // cycles counted: c < min(L, n_cycle)
  int n_len;              // length bins; lengths clip to n_len - 1
  int tile_c;             // cycles per tile, a multiple of 32
  int rows_per_chunk;     // rows staged per ring stage
  int pitch;              // bytes per staged row, a multiple of 16
  int row_shift;          // log2(threads that stage one row)
  int len_bins;           // length bins counted in shared memory
  int32_t* total_q;       // [n_cycle, 128]
  int32_t* total_len;     // [n_len]
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int chunk_rows(const Params& p, long long chunk) {
  return static_cast<int>(min(static_cast<long long>(p.rows_per_chunk),
                              p.n_rows - chunk * p.rows_per_chunk));
}

// Copy the lengths of chunk `chunk` into `dst` (none past the last chunk).
__device__ __forceinline__ void copy_lens(const Params& p, long long chunk,
                                           long long n_chunks, int32_t* dst) {
  if (chunk >= n_chunks) return;
  const long long r0 = chunk * p.rows_per_chunk;
  const int nr = chunk_rows(p, chunk);
  for (int i = threadIdx.x; i < nr; i += blockDim.x)
    cp_async4(dst + i, p.lens + r0 + i);
}

// Stage chunk `chunk`, whose lengths are in `lens`. 2**row_shift threads
// share a row: the first counts its length into the length histogram
// (tile 0) and writes its (live cycles of the tile, slot offset of cycle
// c0); together they copy the 16-byte words that hold the row's live tile
// bytes into its slot.
__device__ __forceinline__ void copy_words(const Params& p, long long chunk,
                                            long long n_chunks, int c0,
                                            int c1, bool do_len,
                                            const int32_t* lens,
                                            int32_t* s_len, int2* meta,
                                            uint8_t* st) {
  if (chunk >= n_chunks) return;
  const long long r0 = chunk * p.rows_per_chunk;
  const int nr = chunk_rows(p, chunk);
  const int share = 1 << p.row_shift;
  const int sub = threadIdx.x & (share - 1);
  for (int row = threadIdx.x >> p.row_shift; row < nr;
       row += blockDim.x >> p.row_shift) {
    const int len = lens[row];
    const int live_end = min(max(len, c0), c1);
    const long long start = (r0 + row) * p.L + c0;  // the segment's start
    const long long end = start - c0 + live_end;     // past its last live byte
    if (sub == 0) {
      meta[row] = make_int2(live_end - c0,
                            row * p.pitch + static_cast<int>(start & 15));
      if (do_len) {
        const int bin = min(max(len, 0), p.n_len - 1);
        if (bin < p.len_bins)
          atomicAdd(&s_len[bin], 1);
        else
          atomicAdd(&p.total_len[bin], 1);
      }
    }
    uint8_t* dst = st + row * p.pitch + 16 * sub;
    for (long long a = (start & ~15LL) + 16 * sub; a < end;
         a += 16 * share, dst += 16 * share) {
      if (a + 16 <= p.total_bytes) {
        cp_async16(dst, p.qual + a);
      } else {
        for (int b = 0; b < 16 && a + b < p.total_bytes; ++b)
          dst[b] = p.qual[a + b];
      }
    }
  }
}

__global__ void qc_hist_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rc = p.rows_per_chunk;
  const int cells = kNQual * p.tile_c;
  int32_t* s_q = reinterpret_cast<int32_t*>(smem);  // [128 q][tile_c]
  int32_t* s_len = s_q + cells;
  int32_t* s_lens = s_len + p.len_bins;                     // kStages slots
  int2* s_meta = reinterpret_cast<int2*>(s_lens + kStages * rc);  // kStages
  uint8_t* stage = reinterpret_cast<uint8_t*>(s_meta + kStages * rc);

  const int c0 = blockIdx.y * p.tile_c;
  const int c1 = min(min(p.L, p.n_cycle), c0 + p.tile_c);
  const bool do_len = blockIdx.y == 0;

  for (int i = threadIdx.x; i < cells; i += blockDim.x) s_q[i] = 0;
  for (int i = threadIdx.x; i < p.len_bins; i += blockDim.x) s_len[i] = 0;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  // cell (q, c) is s_q[q * tile_c + c]: lane l counts cycles l + 32 g, so
  // a warp's lanes fall in 32 banks whatever their qualities
  int32_t* col = s_q + lane;

  // Chunk j of this block (chunk first + j * step) uses ring slot j % 3.
  // Copy group G_j, committed in iteration j, holds the words of chunk
  // j + 2 and the lengths of chunk j + 4; iteration j waits for G_{j-2}.
  const long long n_chunks = (p.n_rows + rc - 1) / rc;
  const long long step = gridDim.x;
  const long long first = blockIdx.x;
  auto lens_at = [&](int j) { return s_lens + (j % kStages) * rc; };
  auto meta_at = [&](int j) { return s_meta + (j % kStages) * rc; };
  auto stage_at = [&](int j) { return stage + (j % kStages) * rc * p.pitch; };
  copy_lens(p, first, n_chunks, lens_at(0));
  copy_lens(p, first + step, n_chunks, lens_at(1));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the tables are zero and two chunks' lengths are in
  for (int j = 0; j < 2; ++j) {  // G_{-2}, G_{-1}
    if (j) __syncthreads();  // chunk 0's lengths are read: slot 0 is free
    copy_words(p, first + j * step, n_chunks, c0, c1, do_len, lens_at(j),
                s_len, meta_at(j), stage_at(j));
    copy_lens(p, first + (j + 2) * step, n_chunks, lens_at(j + 2));
    cp_async_commit();
  }

  int j = 0;
  for (long long chunk = first; chunk < n_chunks; chunk += step, ++j) {
    cp_async_wait<1>();  // G_{j-2}: this chunk's words, chunk j + 2's lengths
    __syncthreads();     // ... for every thread; slot (j + 2) % 3 is free
    copy_words(p, chunk + 2 * step, n_chunks, c0, c1, do_len, lens_at(j + 2),
                s_len, meta_at(j + 2), stage_at(j + 2));
    copy_lens(p, chunk + 4 * step, n_chunks, lens_at(j + 4));
    cp_async_commit();

    // a warp takes whole rows; each lane loads its bytes of the row
    // (cycles lane + 32 g below the row's live end), then adds them to its
    // cells: no add depends on another, so the shared atomics stream
    const int2* meta = meta_at(j);
    const uint8_t* st = stage_at(j);
    const int nr = chunk_rows(p, chunk);
    for (int row = warp; row < nr; row += warps) {
      const int2 m = meta[row];
      int qv[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int lc = lane + 32 * g;
        qv[g] = lc < m.x ? st[m.y + lc] : kNQual;
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        if (qv[g] < kNQual) atomicAdd(col + qv[g] * p.tile_c + 32 * g, 1);
    }
  }
  __syncthreads();

  // cells of cycles past c1 stay zero, so the merge never writes there
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const int v = s_q[k];
    if (v) {
      const int q = k / p.tile_c;
      atomicAdd(&p.total_q[static_cast<long long>(c0 + k - q * p.tile_c)
                           * kNQual + q], v);
    }
  }
  if (do_len) {
    for (int k = threadIdx.x; k < p.len_bins; k += blockDim.x) {
      const int v = s_len[k];
      if (v) atomicAdd(&p.total_len[k], v);
    }
  }
}

int prepare(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(qc_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
  return static_cast<int>(err);
}

}  // namespace

// Resident blocks per SM for a block of `threads` threads and `smem_bytes`
// of dynamic shared memory, and the device's SM count.
extern "C" int qc_hist_cuda_occupancy(int threads, long long smem_bytes,
                                      int device, int* blocks_per_sm,
                                      int* sms) {
  int err = prepare(device);
  if (err != 0) return err;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, qc_hist_kernel, threads,
      static_cast<size_t>(smem_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaDeviceGetAttribute(
      sms, cudaDevAttrMultiProcessorCount, device));
}

// qual: uint8 [B, L] row-major, 16-byte aligned; lens: int32 [B];
// total_q: int32 [n_cycle, 128] cycle-major; total_len: int32 [n_len].
// n_rows = min(n_valid, B) > 0; the plan's sizes as hist_cuda.plan_launch
// gives them. Launches on `stream` without synchronising; returns
// cudaGetLastError() of the launch.
extern "C" int qc_hist_cuda(const void* qual, const void* lens,
                            long long n_rows, long long total_bytes, int L,
                            int n_cycle, int n_len, int tile_c,
                            int rows_per_chunk, int pitch, int row_shift,
                            int len_bins, int grid_x, int grid_y, int threads,
                            long long smem_bytes, void* total_q,
                            void* total_len, int device, void* stream) {
  static int prepared_device = -1;
  if (prepared_device != device) {
    const int err = prepare(device);
    if (err != 0) return err;
    prepared_device = device;
  } else {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Params p;
  p.qual = static_cast<const uint8_t*>(qual);
  p.lens = static_cast<const int32_t*>(lens);
  p.n_rows = n_rows;
  p.total_bytes = total_bytes;
  p.L = L;
  p.n_cycle = n_cycle;
  p.n_len = n_len;
  p.tile_c = tile_c;
  p.rows_per_chunk = rows_per_chunk;
  p.pitch = pitch;
  p.row_shift = row_shift;
  p.len_bins = len_bins;
  p.total_q = static_cast<int32_t*>(total_q);
  p.total_len = static_cast<int32_t*>(total_len);
  qc_hist_kernel<<<dim3(grid_x, grid_y), threads,
                   static_cast<size_t>(smem_bytes),
                   static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qc_hist_cuda_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
