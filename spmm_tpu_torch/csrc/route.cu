// Fixed-structure data movement of the serving plan: CSR values -> dense,
// and dense -> the values of a fixed output structure.
//
// Replaces the Pallas kernels of spmm_tpu/ops/kernels/route.py:
//
//   expand_routed    <- `_expand_call` (kernel body `_expand_kernel`,
//                       entry `densify_routed`)
//   compress_routed  <- `_compress_call` (kernel body `_compress_kernel`,
//                       entry `extract_routed`)
//
// The TPU cannot scatter or gather across lanes, so its plans route each
// 128-entry block through two static lane-gather tables and two
// transposes.  Hopper addresses memory per thread, so the plan keeps only
// the idea: every entry's flat dense position row*cols + col, computed once
// at plan time (int64, so m*n past 2^31 is fine) and kept on the card.  Per
// call one thread per entry moves one value:
//
//   expand_routed:   val[pos[i]] = vals[i]     (and pat[pos[i]] = bf16 1.0)
//   compress_routed: out[i] = alpha * c[pos[i]], or with `prev`
//                    out[i] = beta * prev[i] + alpha * c[pos[i]]
//
// Positions are unique, so the scatter needs no atomics and both kernels are
// deterministic.  Values are moved bitwise; an explicit stored zero writes
// 0.0 to the values and 1 to the pattern, so it stays structural.  The
// arithmetic of compress_routed is spelled with __fmul_rn / __fadd_rn: nvcc
// contracts a*b + c into one FMA by default (--fmad=true), which would round
// once where the JAX package (serving.py `_serve_acc`) and the plain PyTorch
// version round twice.  `prev` may alias `out` (the in-place accumulate):
// each thread reads and writes only its own slot.
//
// Bound: bytes.  expand_routed is bound by the zero-fill the wrapper launches
// (4 bytes per dense cell, 6 with the pattern), not by its scatter of 4 + 8
// bytes read and 4 written per entry; compress_routed reads 8 bytes of
// position and 4 of value per entry, the value a random 4-byte read from a
// dense row (a 32-byte sector per read where a row's entries are sparse).
// The design streams the position and value arrays in coalesced order, one
// entry per thread; a later version writes whole dense rows from the
// kernel (no memset) and fuses compress into the GEMM's epilogue.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned short kBf16One = 0x3F80;  // bf16 bit pattern of 1.0

__global__ void expand_routed(const float* __restrict__ vals,
                              const long long* __restrict__ pos,
                              float* __restrict__ val,
                              unsigned short* __restrict__ pat,
                              long long nnz) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < nnz; i += stride) {
    const long long p = pos[i];
    val[p] = vals[i];
    if (pat != nullptr) pat[p] = kBf16One;
  }
}

__global__ void compress_routed(const float* __restrict__ c,
                                const long long* __restrict__ pos,
                                const float* prev, float* out, long long cap,
                                float alpha, float beta) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += stride) {
    const float v = __fmul_rn(alpha, c[pos[i]]);
    out[i] = prev == nullptr ? v : __fadd_rn(__fmul_rn(beta, prev[i]), v);
  }
}

int blocks_for(long long n) {
  // a grid-stride loop covers what a capped grid does not
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < (1LL << 20) ? b : (1LL << 20));
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() of the launch.  The
// caller guarantees n > 0, zero-filled `val`/`pat`, and positions inside
// the dense array.  `pat` and `prev` may be null.
extern "C" int spmm_expand_routed(const float* vals, const long long* pos,
                                  float* val, unsigned short* pat,
                                  long long nnz, void* stream) {
  expand_routed<<<blocks_for(nnz), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(vals, pos, val, pat,
                                                       nnz);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spmm_compress_routed(const float* c, const long long* pos,
                                    const float* prev, float* out,
                                    long long cap, float alpha, float beta,
                                    void* stream) {
  compress_routed<<<blocks_for(cap), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(c, pos, prev, out,
                                                         cap, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}
