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
// at plan time and kept on the card (expand: int64, rising, with a window
// table; compress: int32 where m*n < 2^31, else int64).  Per call:
//
//   expand_routed:   val = 0, pat = 0, then val[pos[i]] = vals[src[i]]
//                    (pat[pos[i]] = bf16 1.0), every cell written once
//   compress_routed: out[i] = alpha * c[pos[i]], or with `prev`
//                    out[i] = beta * prev[i] + alpha * c[pos[i]]
//
// Positions are unique, so neither kernel needs atomics and both are
// deterministic.  Values are moved bitwise; an explicit stored zero writes
// 0.0 to the values and 1 to the pattern, so it stays structural.  The
// arithmetic of compress_routed is spelled with __fmul_rn / __fadd_rn: nvcc
// contracts a*b + c into one FMA by default (--fmad=true), which would round
// once where the JAX package (serving.py `_serve_acc`) and the plain PyTorch
// version round twice.  `prev` may alias `out` (the in-place accumulate):
// each thread reads and writes only its own slots.
//
// Bound: bytes.  expand_routed must write every dense cell (4 bytes, 6 with
// the pattern) and read 8 bytes of position and 4 of value an entry (8 more
// of source index for a structure that came out of order).  The design
// writes each cell once: the flat output is cut into windows of kWin cells,
// one CTA each; the CTA zeroes its window in shared memory, sets the cells
// of the entries the plan's window table gives it, and after a barrier
// writes the window out with 16-byte stores, zeros included, the values and
// the pattern in the same launch (the window writer of window.cuh, shared
// with densify.cu).  Windows start at multiples of kWindow cells, so every
// store is aligned whatever k is (only a workspace `val` given off 16-byte
// alignment, and the last window's ragged tail, take narrow stores).  No
// fill runs before it.
//
// compress_routed reads 4 bytes of position (8 past 2^31 cells), writes 4
// of output, and gathers c: 4 bytes an entry where the output structure is
// dense (1024^2/0.1: 8 entries a 32-byte sector), a whole 32-byte sector an
// entry where it is sparse (8192^2/1e-3: ~67 entries in a row of 8192).  The
// design: each thread takes kVec = 4 entries a warp-width apart and issues
// their 4 gathers of c before any arithmetic; the grid is the blocks the
// card holds at once, each looping over tiles of 1024 entries, so no block
// is launched for a handful of entries.  Four consecutive entries a thread
// with 16-byte loads of positions and a float4 store were measured too
// (PERF.md): the same device time at 1024^2/0.1, 6-8 % more at
// 8192^2/1e-3, and a second path for outputs off 16-byte alignment.

#include <cuda_runtime.h>

#include "grid.cuh"
#include "window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                   // entries a thread, per tile
constexpr int kTile = kThreads * kVec;    // entries a block, per tile
constexpr int kWin = spmm::kWindow;       // cells a CTA of expand_routed

// One CTA per window [e0, e0 + n) of the flat (m, k) output: the entries
// pos[win[w]:win[w + 1]] fall inside it (the plan's window table).
__global__ void __launch_bounds__(kThreads)
    expand_routed(const float* __restrict__ vals,
                  const long long* __restrict__ pos,
                  const long long* __restrict__ src,
                  const long long* __restrict__ win,
                  float* __restrict__ val, unsigned short* __restrict__ pat,
                  long long cells) {
  __shared__ uint4 win_val4[kWin / 4];  // 16 KB
  __shared__ uint4 win_pat4[kWin / 8];  // 8 KB
  float* win_val = reinterpret_cast<float*>(win_val4);
  unsigned short* win_pat = reinterpret_cast<unsigned short*>(win_pat4);
  const long long e0 = static_cast<long long>(blockIdx.x) * kWin;
  const int n = static_cast<int>(min(static_cast<long long>(kWin),
                                     cells - e0));
  const int t = threadIdx.x;
  spmm::zero_window(win_val4, kWin / 4, t, kThreads);
  if (pat != nullptr) spmm::zero_window(win_pat4, kWin / 8, t, kThreads);
  const long long end = win[blockIdx.x + 1];
  __syncthreads();
  for (long long i = win[blockIdx.x] + t; i < end; i += kThreads) {
    const int w = static_cast<int>(pos[i] - e0);
    win_val[w] = vals[src != nullptr ? src[i] : i];
    if (pat != nullptr) win_pat[w] = spmm::kBf16One;
  }
  __syncthreads();
  spmm::store_window(val + e0, win_val, n, t, kThreads);
  if (pat != nullptr) spmm::store_window(pat + e0, win_pat, n, t, kThreads);
}

// Thread t of a block takes entries t, t + 256, t + 512 and t + 768 of
// each tile of 1024: its 4 position loads, then its 4 gathers of c, all in
// flight before the arithmetic.  A warp's load, gather and store
// instructions each cover 32 consecutive entries, so the positions and the
// output move in 128-byte lines and the gathers of one instruction fall in
// one or two rows of c.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
    compress_routed(const float* __restrict__ c,
                    const Index* __restrict__ pos, const float* prev,
                    float* out, long long cap, float alpha, float beta) {
  const long long ntiles = (cap + kTile - 1) / kTile;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long e0 = t * kTile + threadIdx.x;
    long long p[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long e = e0 + j * kThreads;
      p[j] = e < cap ? static_cast<long long>(__ldcs(pos + e)) : 0;
    }
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = e0 + j * kThreads < cap ? __ldg(c + p[j]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long e = e0 + j * kThreads;
      if (e < cap) {
        float r = __fmul_rn(alpha, v[j]);
        if (prev != nullptr) r = __fadd_rn(__fmul_rn(beta, prev[e]), r);
        out[e] = r;
      }
    }
  }
}

template <typename Index>
int launch_compress(const float* c, const Index* pos, const float* prev,
                    float* out, long long cap, float alpha, float beta,
                    cudaStream_t s) {
  static int resident[spmm::kMaxDevices];
  cudaError_t err = cudaSuccess;
  const int most = spmm::resident_blocks(compress_routed<Index>, kThreads,
                                         resident, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ntiles = (cap + kTile - 1) / kTile;
  const int grid = static_cast<int>(ntiles < most ? ntiles : most);
  compress_routed<Index><<<grid, kThreads, 0, s>>>(c, pos, prev, out, cap,
                                                   alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() of the launch.
//
// expand_routed: the caller guarantees cells = m*k > 0, rising positions
// inside the dense array with their window table, and a 16-byte aligned
// `pat`; `src` and `pat` may be null.  Every cell of `val` (and `pat`) is
// written: neither needs a fill.  `window` is the plan's window size, which
// must be kWin.
extern "C" int spmm_expand_routed(const float* vals, const long long* pos,
                                  const long long* src, const long long* win,
                                  float* val, unsigned short* pat,
                                  long long cells, int window, void* stream) {
  if (window != kWin) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (cells + kWin - 1) / kWin;
  expand_routed<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(vals, pos, src, win,
                                                       val, pat, cells);
  return static_cast<int>(cudaGetLastError());
}

// `pos` holds int64 positions when `wide` is non-zero, else int32 ones.
extern "C" int spmm_compress_routed(const float* c, const void* pos,
                                    int wide, const float* prev, float* out,
                                    long long cap, float alpha, float beta,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    return launch_compress(c, static_cast<const long long*>(pos), prev, out,
                           cap, alpha, beta, s);
  }
  return launch_compress(c, static_cast<const int*>(pos), prev, out, cap,
                         alpha, beta, s);
}
