// Fixed-order row reductions shared by the SpMV/SpMM kernels.
//
// Every sum here has an order that depends only on the shapes (row length,
// lane-group width), never on timing: each lane of a group adds its strided
// entries in entry order, then a fixed __shfl_down_sync tree combines the
// lanes.  So reruns are bitwise equal, and no float atomics are used.

#pragma once

#include <cuda_runtime.h>

namespace spmm {

// Sum of `v` over each aligned group of W lanes (W a power of two, W <= 32)
// by a fixed tree; lane 0 of the group holds the result.  Every lane of the
// warp must call it.
template <int W>
__device__ __forceinline__ float group_tree_sum(float v) {
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

}  // namespace spmm
