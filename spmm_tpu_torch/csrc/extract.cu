// Dense product under a structural mask -> CSR (indptr, col, vals), kept
// cells in row-major order.
//
// Replaces the Pallas kernel spmm_tpu/ops/kernels/extract_roll.py
// (`extract_roll`, kernel body `_kernel`) and with it every extraction route
// of spmm_tpu/ops/spgemm.py (`_extract_full`, `_extract_shift`,
// `_extract_sort`): all four produce this same output.  The TPU version
// resolves each output tile from a hole prefix with dynamic lane rolls,
// because a TPU cannot compact a vector.  Hopper compacts directly, in two
// kernels around a scan the wrapper runs:
//
//   1. spmm_extract_count:   one block per row, counts the row's kept cells.
//   2. (wrapper)             exclusive int32 scan of the counts -> indptr.
//   3. spmm_extract_compact: one block per row, walks the row in chunks of
//      blockDim cells; each warp ranks its kept lanes with __ballot_sync and
//      __popc, the block adds the warp totals, and a running offset carries
//      across chunks.  Each kept cell writes col and value at
//      indptr[row] + rank, so the order is row-major whatever the hole count.
//
// Output slots at or past `cap` are not written (the wrapper zero-fills
// them), which gives the padded serving layout for cap > nnz.
//
// Bound: bytes.  Pass 1 reads the mask (1 byte a cell), pass 3 reads it again
// plus 4 bytes for every kept value, and writes 8 bytes per kept cell.  A
// later version can fuse the two passes with a decoupled look-back scan.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void count_rows(const unsigned char* __restrict__ mask,
                           int* __restrict__ counts, int n) {
  const unsigned char* mrow =
      mask + static_cast<long long>(blockIdx.x) * n;
  int c = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) c += mrow[j] != 0;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < kWarps ? warp_sum[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (lane == 0) counts[blockIdx.x] = c;
  }
}

__global__ void compact_rows(const float* __restrict__ c,
                             const unsigned char* __restrict__ mask,
                             const int* __restrict__ indptr,
                             int* __restrict__ col, float* __restrict__ vals,
                             int n, int cap) {
  const long long base = static_cast<long long>(blockIdx.x) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  __shared__ int warp_total[kWarps];
  int out = indptr[blockIdx.x];
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const bool keep = j < n && mask[base + j] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_total[w];
      before += w < warp ? t : 0;
      total += t;
    }
    if (keep) {
      const int p = out + before + __popc(ballot & below);
      if (p < cap) {
        col[p] = j;
        vals[p] = c[base + j];
      }
    }
    out += total;
    __syncthreads();  // warp_total is rewritten by the next chunk
  }
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() of the launch.  The
// caller guarantees m > 0 and n > 0.
extern "C" int spmm_extract_count(const unsigned char* mask, int* counts,
                                  int m, int n, void* stream) {
  count_rows<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mask, counts, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spmm_extract_compact(const float* c, const unsigned char* mask,
                                    const int* indptr, int* col, float* vals,
                                    int m, int n, int cap, void* stream) {
  compact_rows<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, mask, indptr, col, vals, n, cap);
  return static_cast<int>(cudaGetLastError());
}
