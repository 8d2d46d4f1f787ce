// y = A @ x over the routed plan: the fixed-structure serving SpMV.
//
// Replaces the Pallas kernels of spmm_tpu/ops/kernels/spmv_routed.py
// (`_spmv_routed_call`: `_fused_kernel`, `_fused_kernel_seg`,
// `_fused_kernel_dense`, `_fused_kernel_dense_y`).  The TPU plan edge-colours
// each 128-row group so that a lane gather, one static lane permute and a
// sublane sum place every product in its row's lane.  What it keeps is the
// serving idea: analyse the structure once, re-lay A so the kernel streams
// it with no index work.  On Hopper that layout is SELL-32-sigma
// (spmv_routed.py builds it once, on the device):
//
//   * rows of length <= cut, sorted by length (longest first) within
//     windows of sigma rows, 32 rows to a slice; a slice is as wide as its
//     longest row and is stored column-major, so lane r of the slice's warp
//     reads row r's j-th entry at slice_ptr[s] + 32*j + r and a warp's loads
//     coalesce.  Dead slots carry val = 0.0, col = 0, as the TPU plan's
//     val_tbl does; each lane adds its row's slots in entry order.
//   * rows longer than cut stay out of the slices: they are cut into chunks
//     of at most `ch` entries, a warp sums each chunk (strided lanes, fixed
//     shuffle tree) into `partial`, and one thread per long row adds its
//     chunks' partials in chunk order.  No thread walks a long row alone.
//
// Every row is written once (slice rows, empty ones included, by the slice
// kernel; long rows by the combine), so y needs no zero-fill; no atomics,
// bitwise on rerun.
//
// Bound: bytes.  8 bytes per slot (value, column) at the slack the plan
// reports as slots / nnz, plus the x gather.

#include <cuda_runtime.h>

#include "row_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void sell_slices(const long long* __restrict__ slice_ptr,
                            const int* __restrict__ slice_rows,
                            const int* __restrict__ sell_col,
                            const float* __restrict__ sell_val, int nslices,
                            const float* __restrict__ x,
                            float* __restrict__ y) {
  const long long slice =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slice >= nslices) return;
  const long long end = slice_ptr[slice + 1];
  float acc = 0.0f;
  for (long long p = slice_ptr[slice] + lane; p < end; p += 32) {
    acc = fmaf(sell_val[p], __ldg(x + sell_col[p]), acc);
  }
  const int row = slice_rows[slice * 32 + lane];
  if (row >= 0) y[row] = acc;
}

__global__ void chunk_partials(const int* __restrict__ indices,
                               const float* __restrict__ data,
                               const int* __restrict__ chunk_start,
                               const int* __restrict__ chunk_end,
                               int nchunks, const float* __restrict__ x,
                               float* __restrict__ partial) {
  const long long c =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= nchunks) return;  // whole warps leave together
  float acc = spmm::strided_dot(indices, data, x, chunk_start[c],
                                chunk_end[c], lane, 32);
  acc = spmm::group_tree_sum<32>(acc);
  if (lane == 0) partial[c] = acc;
}

__global__ void combine_long(const int* __restrict__ long_rows,
                             const int* __restrict__ long_chunk_ptr,
                             int nlong, const float* __restrict__ partial,
                             float* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nlong) return;
  float acc = 0.0f;
  for (int c = long_chunk_ptr[i]; c < long_chunk_ptr[i + 1]; ++c) {
    acc += partial[c];
  }
  y[long_rows[i]] = acc;
}

int blocks_for(long long items, int per_block) {
  return static_cast<int>((items + per_block - 1) / per_block);
}

}  // namespace

// Launches on `stream`; returns the first cudaGetLastError() that is not
// success.  Either part may be empty (nslices == 0 or nlong == 0); the
// caller guarantees the plan is not empty as a whole.
extern "C" int spmm_spmv_routed(const long long* slice_ptr,
                                const int* slice_rows, const int* sell_col,
                                const float* sell_val, int nslices,
                                const int* indices, const float* data,
                                const int* chunk_start, const int* chunk_end,
                                int nchunks, const int* long_rows,
                                const int* long_chunk_ptr, int nlong,
                                const float* x, float* partial, float* y,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nslices > 0) {
    sell_slices<<<blocks_for(nslices, kWarps), kThreads, 0, s>>>(
        slice_ptr, slice_rows, sell_col, sell_val, nslices, x, y);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nlong > 0) {
    chunk_partials<<<blocks_for(nchunks, kWarps), kThreads, 0, s>>>(
        indices, data, chunk_start, chunk_end, nchunks, x, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    combine_long<<<blocks_for(nlong, kThreads), kThreads, 0, s>>>(
        long_rows, long_chunk_ptr, nlong, partial, y);
  }
  return static_cast<int>(cudaGetLastError());
}
