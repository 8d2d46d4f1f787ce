// C = A_bsr @ B: block-sparse (BSR) times dense, float32.
//
// Replaces the Pallas kernel `bsr_spmm_pallas` of
// spmm_tpu/ops/kernels/bsr_spmm.py (kernel body `_kernel`).  The TPU kernel
// runs a sequential grid (block row, N tile, step s) and carries the (R, TN)
// sum in its output block across the steps, with a DMA of the named B tile
// per step.  Here one CTA owns one (block row, N tile, row chunk) and walks
// the block row's blocks in stored order itself, keeping the sum in
// registers, so nothing carries between CTAs: no zero-fill pass, no
// atomics, one store per output element, bitwise on rerun.
//
// Per block, K is staged through shared memory in chunks of kKC: the
// (rows, kKC) slice of the A block and the (kKC, kTN) slab of B it meets.
// Each thread owns one column j of the tile and kRpt rows (i = g, g + 4,
// ...), and adds a[i][k] * b[k][j] with fmaf in the order (block, k), the
// TPU kernel's HIGHEST: float32 products and sums, no TF32, no bf16.  Its
// order differs from cuBLAS's, so it is held to the plain version within a
// tolerance, not bitwise.
//
// Ragged shapes are masked here (the TPU wrapper pads K to C and N to the
// tile, then cuts back): B rows past K and columns past N read as absent,
// output rows past m and columns past N are not written.  A block row with
// no blocks writes zeros.  Blocks taller than one chunk (R > 4 * kRpt rows)
// take several CTAs along z.
//
// Bound on this card: the larger of the bytes, 4 * (nblocks*R*C + K*N +
// m*N) plus the indices, over 3.35 TB/s, and 2 * nblocks*R*C*N float32
// operations over 67 TFLOP/s.  This first version runs on the FMA units;
// tensor cores (3xTF32 or wgmma) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 64;                     // columns of B per CTA
constexpr int kGroups = kThreads / kTN;     // 4 row groups
constexpr int kKC = 32;                     // K per shared-memory stage
constexpr int kMaxChunk = kGroups * 32;     // rows per CTA at kRpt = 32

template <int kRpt>
__global__ void bsr_spmm_rows(const int* __restrict__ indptr,
                              const int* __restrict__ indices,
                              const float* __restrict__ blocks,
                              const float* __restrict__ b,
                              float* __restrict__ out, int R, int C,
                              long long m, long long K, int N) {
  constexpr int kChunk = kGroups * kRpt;
  __shared__ float as[kMaxChunk][kKC];
  __shared__ float bs[kKC][kTN];
  const int r = blockIdx.x;
  const int n0 = blockIdx.y * kTN;
  const int i0 = blockIdx.z * kChunk;
  const int rows = min(kChunk, R - i0);
  const int t = threadIdx.x;
  const int j = t % kTN;
  const int g = t / kTN;
  float acc[kRpt];
#pragma unroll
  for (int q = 0; q < kRpt; ++q) acc[q] = 0.0f;

  const int end = indptr[r + 1];
  for (int p = indptr[r]; p < end; ++p) {
    const long long kb = static_cast<long long>(indices[p]) * C;
    const float* a = blocks + static_cast<long long>(p) * R * C +
                     static_cast<long long>(i0) * C;
    for (int kc = 0; kc < C; kc += kKC) {
      // this stage's depth: inside the block and inside B
      const int kmax = static_cast<int>(
          min(static_cast<long long>(min(kKC, C - kc)), K - kb - kc));
      if (kmax <= 0) break;
      for (int idx = t; idx < rows * kKC; idx += kThreads) {
        const int i = idx / kKC;
        const int kk = idx % kKC;
        as[i][kk] = kk < kmax ? a[static_cast<long long>(i) * C + kc + kk]
                              : 0.0f;
      }
      for (int idx = t; idx < kKC * kTN; idx += kThreads) {
        const int kk = idx / kTN;
        const int jj = idx % kTN;
        bs[kk][jj] = (kk < kmax && n0 + jj < N)
                         ? b[(kb + kc + kk) * N + n0 + jj]
                         : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < kmax; ++kk) {
        const float bv = bs[kk][j];
#pragma unroll
        for (int q = 0; q < kRpt; ++q) {
          const int i = g + q * kGroups;
          if (i < rows) acc[q] = fmaf(as[i][kk], bv, acc[q]);
        }
      }
      __syncthreads();  // the next stage overwrites as and bs
    }
  }
  if (n0 + j >= N) return;
#pragma unroll
  for (int q = 0; q < kRpt; ++q) {
    const int i = g + q * kGroups;
    const long long row = static_cast<long long>(r) * R + i0 + i;
    if (i < rows && row < m) out[row * N + n0 + j] = acc[q];
  }
}

template <int kRpt>
int launch(const int* indptr, const int* indices, const float* blocks,
           const float* b, float* out, int mb, int R, int C, long long m,
           long long K, int N, cudaStream_t stream) {
  constexpr int kChunk = kGroups * kRpt;
  const dim3 grid(mb, (N + kTN - 1) / kTN, (R + kChunk - 1) / kChunk);
  bsr_spmm_rows<kRpt><<<grid, kThreads, 0, stream>>>(
      indptr, indices, blocks, b, out, R, C, m, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (m, N) = A @ b with A given as BSR (indptr over mb block rows, block
// column ids, blocks (nblocks, R, C)) and b (K, N), all row-major on the
// device.  Launches on `stream`; returns cudaGetLastError() of the launch.
// The caller guarantees mb, N > 0 and m <= mb * R.
extern "C" int spmm_bsr_spmm(const int* indptr, const int* indices,
                             const float* blocks, const float* b, float* out,
                             int mb, int R, int C, long long m, long long K,
                             int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the fewest rows a thread owns that cover the block (4 row groups)
  if (R <= 8) return launch<2>(indptr, indices, blocks, b, out, mb, R, C, m,
                               K, N, s);
  if (R <= 16) return launch<4>(indptr, indices, blocks, b, out, mb, R, C, m,
                                K, N, s);
  if (R <= 32) return launch<8>(indptr, indices, blocks, b, out, mb, R, C, m,
                                K, N, s);
  return launch<32>(indptr, indices, blocks, b, out, mb, R, C, m, K, N, s);
}
