// In-order segment sums: out[s, w] = ((0 + v[p0, w]) + v[p0 + 1, w]) + ...
// over the rows p0 = starts[s] .. starts[s] + lengths[s] - 1 of values
// (L, W), row-major.
//
// The port's own kernel, not a TPU kernel: the JAX package sums these
// segments with `jax.ops.segment_sum` and `.at[].add`, which on the CPU add
// each segment in stored order from +0.0 (duplicate sums, axis sums,
// `diagonal`, the BSR block-row sum).  The port keeps those bits.  On the
// card `index_add_` adds with atomics in no fixed order and
// `segment_reduce` with a tree, so neither gives them; here one thread owns
// one (segment, column) and adds its rows in order.
//
// Bound: bytes, each value read once and each sum written once.  The cost
// is linear in the entries, but a segment's adds are serial in one thread,
// so a long segment is bound by the latency of its adds: a thread loads its
// values kBatch at a time into registers and, for one column, prefetches
// into L2 the lines kAhead batches ahead, so that the loads stay out of the
// chain of adds.
// Neighbouring threads take neighbouring columns of one segment, so wide
// values load coalesced.
//
// Types: float, double, int32, int64 added as such; half and bfloat16 added
// in float and rounded back after every step, as PyTorch's CPU
// `index_add_` does, so the bits match the plain version.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ T add_in_order(T a, T b) {
  return a + b;
}

template <>
__device__ __forceinline__ __half add_in_order(__half a, __half b) {
  return __float2half(__half2float(a) + __half2float(b));
}

template <>
__device__ __forceinline__ __nv_bfloat16 add_in_order(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
  return __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0);
}

template <>
__device__ __forceinline__ __half zero_of() {
  return __float2half(0.0f);
}

template <>
__device__ __forceinline__ __nv_bfloat16 zero_of() {
  return __float2bfloat16(0.0f);
}

constexpr int kBatch = 64;  // values in registers ahead of their adds
constexpr int kAhead = 8;   // batches prefetched ahead (past the HBM latency)

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename T>
__global__ void segment_sum_inorder(const T* __restrict__ values,
                                    const long long* __restrict__ starts,
                                    const long long* __restrict__ lengths,
                                    long long nseg, int width,
                                    T* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= nseg * width) return;
  const long long s = i / width;
  const int w = static_cast<int>(i - s * width);
  const long long p0 = starts[s];
  const long long len = lengths[s];
  const T* v = values + p0 * width + w;
  T acc = zero_of<T>();
  long long j = 0;
  for (; j + kBatch <= len; j += kBatch) {
    if (width == 1 && j + (kAhead + 1) * kBatch <= len) {
      constexpr int kLine = 128 / sizeof(T);  // values in a 128-byte line
      for (int q = 0; q < kBatch; q += kLine) {
        prefetch_l2(v + j + kAhead * kBatch + q);
      }
    }
    T buf[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) buf[k] = v[(j + k) * width];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) acc = add_in_order(acc, buf[k]);
  }
  for (; j < len; ++j) acc = add_in_order(acc, v[j * width]);
  out[i] = acc;
}

template <typename T>
int launch(const void* values, const long long* starts,
           const long long* lengths, long long nseg, int width, void* out,
           cudaStream_t s) {
  constexpr int kThreads = 256;
  const long long total = nseg * width;
  const long long blocks = (total + kThreads - 1) / kThreads;
  segment_sum_inorder<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(values), starts, lengths, nseg, width,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 int32, 3 int64, 4 float16, 5 bfloat16.
// starts and lengths are int64 on the device; every segment lies inside
// values.  Returns the cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown dtype.  The caller guarantees
// nseg * width > 0.
extern "C" int spmm_segment_sum(const void* values, const long long* starts,
                                const long long* lengths, long long nseg,
                                int width, int dtype, void* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(values, starts, lengths, nseg, width, out, s);
    case 1: return launch<double>(values, starts, lengths, nseg, width, out, s);
    case 2: return launch<int32_t>(values, starts, lengths, nseg, width, out,
                                   s);
    case 3: return launch<long long>(values, starts, lengths, nseg, width,
                                     out, s);
    case 4: return launch<__half>(values, starts, lengths, nseg, width, out, s);
    case 5: return launch<__nv_bfloat16>(values, starts, lengths, nseg, width,
                                         out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
