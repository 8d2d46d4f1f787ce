// y = A @ x for a canonical f32 CSR, over a per-call plan of row-length
// bins.
//
// Replaces the Pallas kernels of spmm_tpu/ops/kernels/spmv_binned.py
// (`_spmv_binned_call`: `_gather_kernel` and `_reduce_kernel`).  The TPU
// cannot gather across sublanes, so its plan bins entries by column class
// for a lane gather and reduces rows with a masked select.  Hopper gathers
// x directly; what a GPU SpMV must balance instead is row length, so the
// plan (spmv_binned.py, built on the device per call, no host sync) sorts
// the rows stably into four length classes, and each class gets a width:
//
//   class 0  len <= 4      one thread per row
//   class 1  len <= 64     8 lanes per row
//   class 2  len <= 2048   one warp per row
//   class 3  len >  2048   one block of 1024 threads per row (the hub rows
//                          of a power-law matrix, up to a full row)
//
// Lanes stride the row and combine by a fixed shuffle tree (row_sum.cuh), so
// the order depends on the row's length only: bitwise on rerun, no atomics.
// Every row, empty ones included, is written by exactly one group, so y
// needs no zero-fill.  The row count of a class lives on the device; each
// kernel runs a grid sized from m, capped, and strides over its class.
//
// Bound: bytes.  8 bytes of (index, value) per entry plus the x gather
// (4 bytes, cached when columns repeat), and 16 bytes per row (indptr
// twice, the row id, y).

#include <cuda_runtime.h>

#include "row_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHubThreads = 1024;
constexpr int kMaxGrid = 4096;
constexpr int kHubGrid = 528;  // 4 blocks for each of 132 SMs

// Rows of class `cls`, W lanes each, kThreads / W rows per block step.
template <int W>
__global__ void group_rows(const int* __restrict__ indptr,
                           const int* __restrict__ indices,
                           const float* __restrict__ data,
                           const float* __restrict__ x,
                           const int* __restrict__ rows,
                           const int* __restrict__ class_off, int cls,
                           float* __restrict__ y) {
  constexpr int kGroups = kThreads / W;
  const int begin = class_off[cls];
  const int count = class_off[cls + 1] - begin;
  const int lane = threadIdx.x % W;
  const int g = threadIdx.x / W;
  // `base` is the same for every thread of the block, so all lanes reach
  // the shuffles together
  for (int base = blockIdx.x * kGroups; base < count;
       base += gridDim.x * kGroups) {
    const int i = base + g;
    const bool valid = i < count;
    const int row = valid ? rows[begin + i] : 0;
    const int s = valid ? indptr[row] : 0;
    const int e = valid ? indptr[row + 1] : 0;
    float acc = spmm::strided_dot(indices, data, x, s, e, lane, W);
    acc = spmm::group_tree_sum<W>(acc);
    if (valid && lane == 0) y[row] = acc;
  }
}

// The hub rows: one block of kHubThreads per row.
__global__ void hub_rows(const int* __restrict__ indptr,
                         const int* __restrict__ indices,
                         const float* __restrict__ data,
                         const float* __restrict__ x,
                         const int* __restrict__ rows,
                         const int* __restrict__ class_off, int cls,
                         float* __restrict__ y) {
  __shared__ float smem[kHubThreads / 32];
  const int begin = class_off[cls];
  const int count = class_off[cls + 1] - begin;
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const int row = rows[begin + i];
    float acc = spmm::strided_dot(indices, data, x, indptr[row],
                                  indptr[row + 1], threadIdx.x, kHubThreads);
    acc = spmm::block_tree_sum<kHubThreads>(acc, smem);
    if (threadIdx.x == 0) y[row] = acc;
  }
}

int grid_for(int m, int rows_per_block, int cap) {
  const long long g = (static_cast<long long>(m) + rows_per_block - 1) /
                      rows_per_block;
  return static_cast<int>(g < cap ? g : cap);
}

}  // namespace

// Launches the four class kernels on `stream`; returns the first
// cudaGetLastError() that is not success.  `rows` is a permutation of
// [0, m) sorted by class, `class_off` (5 ints, on the device) the class
// boundaries in it.  The caller guarantees m > 0.
extern "C" int spmm_spmv_binned(const int* indptr, const int* indices,
                                const float* data, const float* x,
                                const int* rows, const int* class_off,
                                float* y, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  group_rows<1><<<grid_for(m, kThreads, kMaxGrid), kThreads, 0, s>>>(
      indptr, indices, data, x, rows, class_off, 0, y);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  group_rows<8><<<grid_for(m, kThreads / 8, kMaxGrid), kThreads, 0, s>>>(
      indptr, indices, data, x, rows, class_off, 1, y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  group_rows<32><<<grid_for(m, kThreads / 32, kMaxGrid), kThreads, 0, s>>>(
      indptr, indices, data, x, rows, class_off, 2, y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hub_rows<<<grid_for(m, 1, kHubGrid), kHubThreads, 0, s>>>(
      indptr, indices, data, x, rows, class_off, 3, y);
  return static_cast<int>(cudaGetLastError());
}
