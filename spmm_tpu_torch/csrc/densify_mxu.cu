// Canonical CSR -> dense (m, k) float32, each output byte written once.
//
// Replaces the Pallas kernel `csr_densify_mxu` of
// spmm_tpu/ops/kernels/densify_mxu.py (kernel body `_kernel`).  The TPU
// kernel gives one program to each stripe of H = 128 rows, zeroes its output
// block in VMEM, places the stripe's entries with one-hot MXU matmuls (the
// TPU cannot scatter) and writes the block once.  On Hopper the placement is
// a scatter into shared memory, and what the TPU kernel keeps out of memory
// stays out: one CTA per (stripe of kRows rows, tile of kCols columns)
// zeroes a shared tile, each warp finds its rows' entries of the column
// range (a binary search in the sorted row, then a strided walk) and
// stores them into the tile, and the CTA writes the whole tile with
// coalesced 16-byte stores.  So the output needs no memset, and every
// output byte is written once.
//
// Canonical input (sorted, duplicate-free rows) is the contract, as in the
// TPU kernel; the wrapper checks it.  Positions are unique, so the stores
// never collide, and values are moved, never computed: the output is
// bitwise `toarray()`, stored zeros included.
//
// Bound on this card: 4*m*k + 4*(m + 1) + 8*nnz bytes over 3.35 TB/s, the
// dense write.  `densify_onehot` (csrc/densify.cu) writes the same output
// after a separate zero-fill; this kernel has no such pass.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;    // rows per CTA
constexpr int kCols = 256;   // columns per CTA: a 32 KB tile

__global__ void densify_tiles(const int* __restrict__ indptr,
                              const int* __restrict__ indices,
                              const float* __restrict__ data,
                              float* __restrict__ out, int m, int k) {
  __shared__ __align__(16) float tile[kRows][kCols];
  const int r0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kCols;
  const int c1 = min(c0 + kCols, k);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  float4* tile4 = reinterpret_cast<float4*>(&tile[0][0]);
  for (int i = t; i < kRows * kCols / 4; i += kThreads) {
    tile4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  for (int rr = warp; rr < kRows; rr += kWarps) {
    const int row = r0 + rr;
    if (row >= m) break;
    // first entry of the row at a column >= c0: a binary search (every
    // lane computes it; the row's indices are sorted)
    int lo = indptr[row];
    int hi = indptr[row + 1];
    const int end = hi;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (indices[mid] < c0) lo = mid + 1; else hi = mid;
    }
    for (int e = lo + lane; e < end; e += 32) {
      const int c = indices[e];
      if (c >= c1) break;  // sorted: the lane's later entries lie past c1
      tile[rr][c - c0] = data[e];
    }
  }
  __syncthreads();

  const int rows = min(kRows, m - r0);
  const int cols = c1 - c0;
  if ((k & 3) == 0) {
    // 16-byte stores: row starts and c0 are multiples of 4 floats
    const int quads = cols >> 2;
    for (int i = t; i < rows * quads; i += kThreads) {
      const int rr = i / quads;
      const int q = i % quads;
      float4* dst = reinterpret_cast<float4*>(
          out + static_cast<long long>(r0 + rr) * k + c0) + q;
      *dst = reinterpret_cast<const float4*>(&tile[rr][0])[q];
    }
  } else {
    for (int i = t; i < rows * cols; i += kThreads) {
      const int rr = i / cols;
      const int c = i % cols;
      out[static_cast<long long>(r0 + rr) * k + c0 + c] = tile[rr][c];
    }
  }
}

}  // namespace

// out (m, k) = the dense form of a canonical CSR, every element written
// (out need not be zeroed).  Launches on `stream`; returns
// cudaGetLastError() of the launch.  The caller guarantees m, k > 0.
extern "C" int spmm_densify_mxu(const int* indptr, const int* indices,
                                const float* data, float* out, int m, int k,
                                void* stream) {
  const dim3 grid((m + kRows - 1) / kRows, (k + kCols - 1) / kCols);
  densify_tiles<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, data, out, m, k);
  return static_cast<int>(cudaGetLastError());
}
