// Canonical CSR -> dense f32 values (+ bf16 structural 0/1 pattern).
//
// Replaces the Pallas kernel spmm_tpu/ops/kernels/densify_onehot.py
// (`densify_onehot`, kernel bodies `_kernel` / `_kernel_val`).  The TPU has
// no vector scatter, so it places entries with windowed one-hot MXU
// contractions over a bf16 triple split of each value.  Hopper scatters: one
// warp per row, lanes striding the row's entries, each lane writing its
// entry's value and pattern cell.  Canonical CSR positions are unique, so the
// stores never collide and the result is deterministic without atomics.
// Values are moved, never computed: the output is bitwise `toarray()`.  A
// stored zero writes 0.0 to the values and 1 to the pattern, so it stays
// structural.
//
// Bound: the zero-fill.  The wrapper allocates both outputs with
// torch.zeros, which writes 6 bytes per dense cell (m*k*6 bytes, 400 MB at
// 8192^2); the scatter itself moves 8 bytes per entry in and 6 out.  A later
// version can skip the memset by writing whole rows (zeros included) from
// this kernel.
//
// Offsets are 64-bit: m*k reaches 67M at 8192^2 and row*k+col overflows
// int32 past 2^31 cells.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned short kBf16One = 0x3F80;  // bf16 bit pattern of 1.0

__global__ void densify_rows(const int* __restrict__ indptr,
                             const int* __restrict__ indices,
                             const float* __restrict__ data,
                             float* __restrict__ val,
                             unsigned short* __restrict__ pat,
                             int m, long long k) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const int start = indptr[row];
  const int end = indptr[row + 1];
  const long long base = static_cast<long long>(row) * k;
  for (int t = start + lane; t < end; t += 32) {
    const long long off = base + indices[t];
    val[off] = data[t];
    if (pat != nullptr) pat[off] = kBf16One;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.  `pat` may
// be null (value-only mode).  The caller guarantees m > 0 and zero-filled
// outputs.
extern "C" int spmm_densify(const int* indptr, const int* indices,
                            const float* data, float* val,
                            unsigned short* pat, int m, long long k,
                            void* stream) {
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  densify_rows<<<blocks, kWarpsPerBlock * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(indptr, indices, data,
                                                      val, pat, m, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
