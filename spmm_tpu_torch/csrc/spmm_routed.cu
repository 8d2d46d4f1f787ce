// Y = A @ X over the routed plan (X (n, k), Y (m, k), both row-major f32).
//
// Replaces the Pallas kernels of spmm_tpu/ops/kernels/spmv_routed.py's
// multi-vector path (`_spmm_routed_call`, `_spmm_routed_call_matsum`,
// `_spmm_routed_call_fused`: `_gather_route_kernel_m`, `_sum_kernel_m`,
// `_fused_kernel_seg_m`, `_fused_kernel_dense_m`).  The TPU streams its
// routing tables once per 8 columns of X.  On Hopper a row of X is
// contiguous, so a warp takes one row of A and 32 columns of X across its
// lanes: for each entry (a broadcast load of index and value) every lane
// reads its column of X's row indices[e] (128 coalesced bytes) and adds
// value * X[indices[e], c] in the row's entry order.
//
//   * spmm_rows: one warp per (row, 32-column block), rows taken in the
//     plan's order (longest first within windows, so the warps of a block
//     do similar work) or in index order when `order` is null.  Rows
//     longer than `cut` are left to the chunk path.
//   * spmm_chunk_partials: each chunk of at most `ch` entries of a long row
//     (the plan's chunks) gives one partial row of k sums, a warp per
//     (chunk, 32 columns), summed in entry order.
//   * spmm_combine_long: one thread per (long row, column) adds its chunks'
//     partials in chunk order.
//
// Every output cell is written once, by a sum whose order is fixed by the
// plan: no atomics, bitwise on rerun.  Offsets into X, Y and the partials
// are 64-bit (row * k passes 2^31 at 2^20 rows and k = 2^11).
//
// Bound: bytes.  Per entry and 32 columns: 8 bytes of A (shared by the
// warp, cached) and 128 bytes of X, mostly from L2 when rows repeat; Y is
// written once (4 bytes a cell).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void spmm_rows(const int* __restrict__ indptr,
                          const int* __restrict__ indices,
                          const float* __restrict__ data,
                          const int* __restrict__ order, int nrows, int cut,
                          const float* __restrict__ x, int k,
                          float* __restrict__ y) {
  const int ncb = (k + 31) / 32;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(nrows) * ncb) return;
  const int i = static_cast<int>(w / ncb);
  const int c = static_cast<int>(w % ncb) * 32 + (threadIdx.x & 31);
  const int row = order != nullptr ? order[i] : i;
  const int s = indptr[row];
  const int e = indptr[row + 1];
  if (e - s > cut || c >= k) return;
  float acc = 0.0f;
  for (int t = s; t < e; ++t) {
    acc = fmaf(data[t], __ldg(x + static_cast<long long>(indices[t]) * k + c),
               acc);
  }
  y[static_cast<long long>(row) * k + c] = acc;
}

__global__ void spmm_chunk_partials(const int* __restrict__ indices,
                                    const float* __restrict__ data,
                                    const int* __restrict__ chunk_start,
                                    const int* __restrict__ chunk_end,
                                    int nchunks, const float* __restrict__ x,
                                    int k, float* __restrict__ partial) {
  const int ncb = (k + 31) / 32;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(nchunks) * ncb) return;
  const long long ch = w / ncb;
  const int c = static_cast<int>(w % ncb) * 32 + (threadIdx.x & 31);
  if (c >= k) return;
  float acc = 0.0f;
  for (int t = chunk_start[ch]; t < chunk_end[ch]; ++t) {
    acc = fmaf(data[t], __ldg(x + static_cast<long long>(indices[t]) * k + c),
               acc);
  }
  partial[ch * k + c] = acc;
}

__global__ void spmm_combine_long(const int* __restrict__ long_rows,
                                  const int* __restrict__ long_chunk_ptr,
                                  int nlong, const float* __restrict__ partial,
                                  int k, float* __restrict__ y) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(nlong) * k) return;
  const int i = static_cast<int>(t / k);
  const int c = static_cast<int>(t % k);
  float acc = 0.0f;
  for (int ch = long_chunk_ptr[i]; ch < long_chunk_ptr[i + 1]; ++ch) {
    acc += partial[static_cast<long long>(ch) * k + c];
  }
  y[static_cast<long long>(long_rows[i]) * k + c] = acc;
}

unsigned blocks_for(long long items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace

// Launches on `stream`; returns the first cudaGetLastError() that is not
// success.  `order` may be null (rows 0..nrows-1).  The caller guarantees
// k > 0 and that nrows > 0 or nlong > 0.
extern "C" int spmm_spmm_routed(const int* indptr, const int* indices,
                                const float* data, const int* order,
                                int nrows, int cut, const int* chunk_start,
                                const int* chunk_end, int nchunks,
                                const int* long_rows,
                                const int* long_chunk_ptr, int nlong,
                                const float* x, int k, float* partial,
                                float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ncb = (k + 31) / 32;
  if (nrows > 0) {
    spmm_rows<<<blocks_for(nrows * ncb, kWarps), kThreads, 0, s>>>(
        indptr, indices, data, order, nrows, cut, x, k, y);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nlong > 0) {
    spmm_chunk_partials<<<blocks_for(nchunks * ncb, kWarps), kThreads, 0,
                          s>>>(indices, data, chunk_start, chunk_end, nchunks,
                               x, k, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    spmm_combine_long<<<blocks_for(static_cast<long long>(nlong) * k,
                                   kThreads),
                        kThreads, 0, s>>>(long_rows, long_chunk_ptr, nlong,
                                          partial, k, y);
  }
  return static_cast<int>(cudaGetLastError());
}
