// Fixed-order row reductions shared by the SpMV/SpMM kernels.
//
// Every sum here has an order that depends only on the shapes (row length,
// lane-group width, piece count), never on timing: each lane of a group
// adds its strided entries in entry order, then a fixed __shfl_down_sync
// tree combines the lanes.  A row cut into pieces that several blocks sum
// is closed by `join_piece`: an integer counter picks the block that adds
// the pieces, and the pieces are added in piece order whichever block that
// is.  So reruns are bitwise equal, and no float atomics are used.
// `group_tree_sum`, `warp_ordered_sum` and `join_piece` take the value
// type of their operands (float, or double for the float64 routed SpMV);
// at float they are the float code they were.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace spmm {

// Sum of `v` over each aligned group of W lanes (W a power of two, W <= 32)
// by a fixed tree; lane 0 of the group holds the result.  Every lane of the
// warp must call it.
template <int W, typename T>
__device__ __forceinline__ T group_tree_sum(T v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, o, W);
  }
  return v;
}

// Lane `lane` of a group of `stride` lanes: sum of data[e] * x[indices[e]]
// over e = start + lane, start + lane + stride, ... < end, in that order.
__device__ __forceinline__ float strided_dot(const int* __restrict__ indices,
                                             const float* __restrict__ data,
                                             const float* __restrict__ x,
                                             long long start, long long end,
                                             int lane, int stride) {
  float acc = 0.0f;
#pragma unroll 4
  for (long long e = start + lane; e < end; e += stride) {
    acc = fmaf(data[e], __ldg(x + indices[e]), acc);
  }
  return acc;
}

// Sum of `v` over a block of kBlock threads (a multiple of 32, at most
// 1024): warp trees, then one tree over the warp sums.  Thread 0 holds the
// result.  `smem` holds kBlock / 32 floats; every thread must call it.
template <int kBlock>
__device__ __forceinline__ float block_tree_sum(float v, float* smem) {
  constexpr int kWarps = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = group_tree_sum<32>(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? smem[lane] : 0.0f;
    v = group_tree_sum<32>(v);
  }
  __syncthreads();  // smem is rewritten by the next call
  return v;
}

// Sum of the pieces piece(0), ..., piece(n - 1) by one warp, in piece
// order: lane l adds the run [l*g, min((l+1)*g, n)) in order (g = ceil(n /
// 32)), then the runs are added in lane order.  A lane reads its run 8
// pieces at a time, all 8 loads in flight before their adds (a row of 2048
// pieces is 64 a lane: 8 waits on L2, not 64).  Every lane of the warp
// must call it; every lane returns the sum, in the type `piece` returns.
template <typename Piece>
__device__ __forceinline__ auto warp_ordered_sum(Piece piece, int n) {
  using T = std::decay_t<decltype(piece(0))>;
  constexpr int kBatch = 8;
  const int lane = threadIdx.x & 31;
  const int g = (n + 31) / 32;
  const int b = lane * g;
  const int e = min(b + g, n);
  T run = T(0);
  if (b < e) {
    run = piece(b);
    for (int i = b + 1; i < e; i += kBatch) {
      T v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) v[q] = i + q < e ? piece(i + q) : T(0);
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (i + q < e) run += v[q];
      }
    }
  }
  T sum = __shfl_sync(0xffffffffu, run, 0);
  for (int l = 1; l < 32; ++l) {
    const T r = __shfl_sync(0xffffffffu, run, l);
    if (l * g < n) sum += r;
  }
  return sum;
}

// One of the `parts` pieces of a row that several blocks sum.  A whole warp
// calls it.  Lane 0 stores `piece` to *slot, fences, and adds one to the
// row's integer counter; the warp whose increment is the last sums all the
// pieces in order (`pieces(i)`, read from L2, since other blocks stored
// them), writes the sum to *out, and resets the counter to 0 for the next
// launch.  The atomic decides only who sums, never the order of the sum.
template <typename T, typename Pieces>
__device__ __forceinline__ void join_piece(T piece, T* slot, int* counter,
                                           int parts, Pieces pieces,
                                           T* out) {
  int last = 0;
  if ((threadIdx.x & 31) == 0) {
    *slot = piece;
    __threadfence();
    last = atomicAdd(counter, 1) == parts - 1;
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  if (!last) return;
  __threadfence();
  const T sum = warp_ordered_sum(pieces, parts);
  if ((threadIdx.x & 31) == 0) {
    *out = sum;
    *counter = 0;
  }
}

}  // namespace spmm
