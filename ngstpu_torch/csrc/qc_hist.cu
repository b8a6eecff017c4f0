// Per-cycle quality histogram + read-length histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ngstpu/kernels/hist_pallas.py
// (_hist_kernel, launched by qc_hist_pallas) together with the XLA work
// around it in ngstpu/ops/count.py:_accumulate_pallas (the [L, 128]
// transpose, the clip at 512 cycles, the 512-bin length histogram and the
// add into the running totals). One launch adds one batch into the int32
// totals in place:
//
//   total_q[c, q] += #{r < n_valid : c < lens[r], qual[r, c] == q}
//                    for c < 512, q < 128 (bytes >= 128 are never counted)
//   total_len[clip(lens[r], 0, 511)] += 1   for r < n_valid
//
// Design. The TPU kernel walks 512-row blocks in order and keeps the whole
// [128, L] table resident in VMEM across the grid. Hopper's blocks run in
// parallel, in no order, and the full 512 x 128 int32 table (256 KB) does
// not fit in one block's 227 KB of shared memory. So the grid is row
// blocks x 64-cycle tiles: each block owns a 64 x 128 int32 tile (32 KB of
// static shared memory), counts into it with shared-memory atomics, then
// merges its nonzero cells into the global totals with global atomics. The
// blocks of the first cycle tile also build the length histogram. All sums
// are integers, so the result is exact whatever order the atomics run in.
//
// Bound: one read of the B x L quality bytes (a warp reads 32 consecutive
// cycles of one row). The known limit is skew in the shared-memory atomics:
// a cycle holds about 42 live quality values, so warps counting the same
// cycle of different rows collide on a few hot cells. Per-warp private
// tables or register pre-aggregation are left to a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNQual = 128;
constexpr int kNCycle = 512;
constexpr int kTileC = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerIter = kThreads / kTileC;
constexpr int kRowsPerBlock = 2048;

__global__ void __launch_bounds__(kThreads)
qc_hist_kernel(const uint8_t* __restrict__ qual,
               const int32_t* __restrict__ lens, int64_t n_rows, int L,
               int32_t* __restrict__ total_q, int32_t* __restrict__ total_len) {
  __shared__ int32_t s_q[kTileC * kNQual];
  __shared__ int32_t s_len[kNCycle];
  const bool do_len = blockIdx.y == 0;

  for (int i = threadIdx.x; i < kTileC * kNQual; i += kThreads) s_q[i] = 0;
  if (do_len)
    for (int i = threadIdx.x; i < kNCycle; i += kThreads) s_len[i] = 0;
  __syncthreads();

  const int c0 = blockIdx.y * kTileC;
  const int c_end = min(min(L, kNCycle), c0 + kTileC);
  const int lc = threadIdx.x % kTileC;
  const int c = c0 + lc;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t r1 =
      n_rows < r0 + kRowsPerBlock ? n_rows : r0 + kRowsPerBlock;

  if (c < c_end) {
    for (int64_t r = r0 + threadIdx.x / kTileC; r < r1; r += kRowsPerIter) {
      if (c < lens[r]) {
        const int q = qual[r * L + c];
        if (q < kNQual) atomicAdd(&s_q[lc * kNQual + q], 1);
      }
    }
  }
  if (do_len) {
    for (int64_t r = r0 + threadIdx.x; r < r1; r += kThreads) {
      const int len = min(max(lens[r], 0), kNCycle - 1);
      atomicAdd(&s_len[len], 1);
    }
  }
  __syncthreads();

  // cells of cycles past c_end stay zero, so the merge never writes there
  for (int i = threadIdx.x; i < kTileC * kNQual; i += kThreads) {
    const int v = s_q[i];
    if (v) atomicAdd(&total_q[c0 * kNQual + i], v);
  }
  if (do_len) {
    for (int i = threadIdx.x; i < kNCycle; i += kThreads) {
      const int v = s_len[i];
      if (v) atomicAdd(&total_len[i], v);
    }
  }
}

}  // namespace

// qual: uint8 [n_rows.., L] row-major; lens: int32 [n_rows..];
// total_q: int32 [512, 128] cycle-major; total_len: int32 [512].
// n_rows = min(n_valid, B) > 0. Launches on `stream` without
// synchronising; returns cudaGetLastError() of the launch.
extern "C" int qc_hist_cuda(const void* qual, const void* lens,
                            long long n_rows, int L, void* total_q,
                            void* total_len, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cycles = L < kNCycle ? L : kNCycle;
  const unsigned tiles = cycles > 0 ? (cycles + kTileC - 1) / kTileC : 1;
  const unsigned blocks =
      static_cast<unsigned>((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  qc_hist_kernel<<<dim3(blocks, tiles), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qual), static_cast<const int32_t*>(lens),
      n_rows, L, static_cast<int32_t*>(total_q),
      static_cast<int32_t*>(total_len));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qc_hist_cuda_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
