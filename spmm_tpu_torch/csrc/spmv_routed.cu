// y = A @ x over the routed plan: the fixed-structure serving SpMV, one
// launch, no memset.
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
//     longest row and is stored column-major, so lane r reads row r's j-th
//     slot at slice_ptr[s] + 32*j + r and a warp's loads coalesce.  Dead
//     slots carry val = 0.0, col = 0, as the TPU plan's val_tbl does.
//   * rows longer than cut stay out of the slices: they are cut into chunks
//     of at most `ch` entries.
//
// Bound on this card: bytes (8 bytes a slot of (column, value) at the
// plan's slack, the x gather, y once).  What holds a simple kernel back is
// latency, not bandwidth: one warp walking a slice of ~100 columns, one
// dependent x gather a slot, puts 512 warps on the card at 16384^2/5e-3.
// The design:
//
//   * One grid, one launch.  Slice blocks come first, then chunk blocks.
//   * A slice is split across 1, 2, 4 or 8 warps (its class, from its width
//     in the plan: at most COLS = 16 columns a warp where 8 warps suffice)
//     by contiguous ranges of its columns; lane r of every warp still reads
//     row r's slots, so loads stay coalesced.  The plan orders slices by
//     class, widest class first, so a block of 8 warps holds 8 / P slices
//     of one class P.  Each lane issues K slots' (column, value) loads and
//     their x gathers before its FMAs, adding its slots in column order;
//     the warps' parts of a row are then added in warp order through shared
//     memory.  16384^2/5e-3: 512 blocks, 4096 warps.
//   * A chunk of a long row is a warp: lanes stride its entries (K in
//     flight), a fixed shuffle tree sums them.  The row is closed in the
//     same launch by `spmm::join_piece`: each chunk stores its partial and
//     bumps the row's integer counter (zeroed when the plan is built, reset
//     by the closing warp); the warp that sees the last count adds the
//     partials in chunk order (`warp_ordered_sum`, 32 lanes, not one thread).
//
// Every row is written once (slice rows, empty ones included, by part 0 of
// their slice; long rows by their closing warp), so y needs no zero-fill; no
// float atomics, bitwise on rerun.  A plan's counters and partials serve
// one launch at a time: a plan is not shared by launches on two streams at
// once.
//
// The value type T is float or double (`spmm_spmv_routed`,
// `spmm_spmv_routed_f64`): one layout, one order of every sum, fma in T
// (fmaf at float).  A float64 slot is 12 bytes, not 8, and a lane's K
// slots in flight twice the bytes; the float instantiation is the float
// kernel it was.

#include <cuda_runtime.h>

#include "row_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 8;  // slots (or entries) a lane keeps in flight

__device__ __forceinline__ float fma_in(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_in(double a, double b, double c) {
  return fma(a, b, c);
}

// Lane `lane`'s part of a slice row: the slots of columns [j0, j1) at
// base + 32*j, K at a time, loads before FMAs, added in column order.
template <typename T>
__device__ __forceinline__ T slice_part(const int* __restrict__ col,
                                        const T* __restrict__ val,
                                        const T* __restrict__ x,
                                        long long base, int j0, int j1) {
  T acc = T(0);
  for (int j = j0; j < j1; j += kK) {
    int c[kK];
    T v[kK];
#pragma unroll
    for (int q = 0; q < kK; ++q) {
      const bool in = j + q < j1;
      const long long p = base + 32LL * (j + q);
      c[q] = in ? __ldg(col + p) : 0;
      v[q] = in ? __ldg(val + p) : T(0);
    }
    T g[kK];
#pragma unroll
    for (int q = 0; q < kK; ++q) g[q] = __ldg(x + c[q]);
#pragma unroll
    for (int q = 0; q < kK; ++q) {
      if (j + q < j1) acc = fma_in(v[q], g[q], acc);
    }
  }
  return acc;
}

// Sum of data[e] * x[indices[e]] over the chunk [s, e1) by one warp: lane l
// adds entries s + l, s + l + 32, ... in order (K in flight), then a fixed
// shuffle tree; lane 0 returns the sum.
template <typename T>
__device__ __forceinline__ T chunk_dot(const int* __restrict__ indices,
                                       const T* __restrict__ data,
                                       const T* __restrict__ x, long long s,
                                       long long e1, int lane) {
  T acc = T(0);
  for (long long b = s + lane; b < e1; b += 32LL * kK) {
    int c[kK];
    T v[kK];
#pragma unroll
    for (int q = 0; q < kK; ++q) {
      const long long e = b + 32LL * q;
      const bool in = e < e1;
      c[q] = in ? __ldcs(indices + e) : 0;
      v[q] = in ? __ldcs(data + e) : T(0);
    }
    T g[kK];
#pragma unroll
    for (int q = 0; q < kK; ++q) g[q] = __ldg(x + c[q]);
#pragma unroll
    for (int q = 0; q < kK; ++q) {
      if (b + 32LL * q < e1) acc = fma_in(v[q], g[q], acc);
    }
  }
  return spmm::group_tree_sum<32>(acc);
}

// `cls[i]`: the number of slices of class i (8 >> i warps each), in the
// plan's slice order.
struct Classes {
  int n[4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    routed_spmv(const long long* __restrict__ slice_ptr,
                const int* __restrict__ slice_rows,
                const int* __restrict__ sell_col,
                const T* __restrict__ sell_val, Classes cls,
                const int* __restrict__ indices, const T* __restrict__ data,
                const int* __restrict__ chunk_start,
                const int* __restrict__ chunk_end,
                const int* __restrict__ chunk_row, int nchunks,
                const int* __restrict__ long_rows,
                const int* __restrict__ long_chunk_ptr,
                const T* __restrict__ x, int* __restrict__ counters,
                T* __restrict__ partial, T* __restrict__ y) {
  __shared__ T s_part[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int b = blockIdx.x;
  int first = 0;  // the first slice of the class
  for (int i = 0; i < 4; ++i) {
    const int per = 1 << i;  // slices a block of this class holds
    const int nb = (cls.n[i] + per - 1) / per;
    if (b < nb) {
      const int parts = kWarps >> i;  // warps a slice
      const int s = first + b * per + warp / parts;
      const int part = warp % parts;
      const bool live = s < first + cls.n[i];
      T acc = T(0);
      long long base = 0;
      if (live) {
        base = slice_ptr[s];
        const int width = static_cast<int>((slice_ptr[s + 1] - base) >> 5);
        const int q = (width + parts - 1) / parts;
        const int j0 = min(part * q, width);
        acc = slice_part(sell_col, sell_val, x, base + lane, j0,
                         min(j0 + q, width));
      }
      if (parts > 1) {  // uniform over the block
        s_part[warp][lane] = acc;
        __syncthreads();
        if (part == 0) {
          for (int w = 1; w < parts; ++w) acc += s_part[warp + w][lane];
        }
      }
      if (live && part == 0) {
        const int row = slice_rows[static_cast<long long>(s) * 32 + lane];
        if (row >= 0) y[row] = acc;
      }
      return;
    }
    b -= nb;
    first += cls.n[i];
  }
  // a chunk block: a warp per chunk of a long row
  const int c = b * kWarps + warp;
  if (c >= nchunks) return;  // whole warps leave together
  const T piece =
      chunk_dot(indices, data, x, chunk_start[c], chunk_end[c], lane);
  const int i = chunk_row[c];
  const int c0 = long_chunk_ptr[i];
  spmm::join_piece(
      piece, partial + c, counters + i, long_chunk_ptr[i + 1] - c0,
      [&](int k) { return __ldcg(partial + c0 + k); }, y + long_rows[i]);
}

// `spmm_spmv_routed` in value type T.
template <typename T>
int launch(const long long* slice_ptr, const int* slice_rows,
           const int* sell_col, const T* sell_val, const Classes& cls,
           const int* indices, const T* data, const int* chunk_start,
           const int* chunk_end, const int* chunk_row, int nchunks,
           const int* long_rows, const int* long_chunk_ptr, const T* x,
           int* counters, T* partial, T* y, void* stream) {
  long long blocks = (nchunks + kWarps - 1) / kWarps;
  for (int i = 0; i < 4; ++i) blocks += (cls.n[i] + (1 << i) - 1) >> i;
  if (blocks <= 0 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  routed_spmv<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      slice_ptr, slice_rows, sell_col, sell_val, cls, indices, data,
      chunk_start, chunk_end, chunk_row, nchunks, long_rows, long_chunk_ptr,
      x, counters, partial, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream`; returns its cudaGetLastError().  `n8, n4, n2, n1`:
// the plan's slices of each class, in that order; either part may be empty
// (no slices, or nchunks == 0), not both.  `counters` (one a long row: zeros,
// or as the last launch left them) and `partial` (one a chunk) come from the
// plan.
extern "C" int spmm_spmv_routed(const long long* slice_ptr,
                                const int* slice_rows, const int* sell_col,
                                const float* sell_val, int n8, int n4, int n2,
                                int n1, const int* indices, const float* data,
                                const int* chunk_start, const int* chunk_end,
                                const int* chunk_row, int nchunks,
                                const int* long_rows,
                                const int* long_chunk_ptr, const float* x,
                                int* counters, float* partial, float* y,
                                void* stream) {
  return launch<float>(slice_ptr, slice_rows, sell_col, sell_val,
                       Classes{{n8, n4, n2, n1}}, indices, data, chunk_start,
                       chunk_end, chunk_row, nchunks, long_rows,
                       long_chunk_ptr, x, counters, partial, y, stream);
}

// The same over a float64 plan: sell_val, data, x, partial and y double.
extern "C" int spmm_spmv_routed_f64(
    const long long* slice_ptr, const int* slice_rows, const int* sell_col,
    const double* sell_val, int n8, int n4, int n2, int n1,
    const int* indices, const double* data, const int* chunk_start,
    const int* chunk_end, const int* chunk_row, int nchunks,
    const int* long_rows, const int* long_chunk_ptr, const double* x,
    int* counters, double* partial, double* y, void* stream) {
  return launch<double>(slice_ptr, slice_rows, sell_col, sell_val,
                        Classes{{n8, n4, n2, n1}}, indices, data,
                        chunk_start, chunk_end, chunk_row, nchunks, long_rows,
                        long_chunk_ptr, x, counters, partial, y, stream);
}
