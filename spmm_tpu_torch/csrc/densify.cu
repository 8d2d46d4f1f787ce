// Canonical CSR -> dense f32 values (+ bf16 structural 0/1 pattern), and
// the pattern alone.
//
// Replaces the Pallas kernels of spmm_tpu/ops/kernels/densify_onehot.py:
// `densify_onehot` (kernel bodies `_kernel` / `_kernel_val`) with
// `densify_rows`, and `densify_onehot_pattern` (`_kernel_pat`) with
// `densify_pattern_rows`.  The TPU has no vector scatter, so it places
// entries with windowed one-hot MXU contractions over a bf16 triple split of
// each value.  Hopper scatters.  Values are moved, never computed: the output
// is bitwise `toarray()`.  A stored zero writes 0.0 to the values and 1 to
// the pattern, so it stays structural.
//
// `densify_rows`: one warp per row, lanes striding the row's entries, each
// lane writing its entry's value and pattern cell.  Canonical CSR positions
// are unique, so the stores never collide and the result is deterministic
// without atomics.  Bound: the zero-fill.  Its wrapper allocates both outputs
// with torch.zeros, which writes 6 bytes per dense cell (m*k*6 bytes, 400 MB
// at 8192^2); the scatter itself moves 8 bytes per entry in and 6 out.
//
// `densify_pattern_rows` writes every cell of its output once, zeros
// included, in one launch: no fill before it.  Its bound is those 2 bytes a
// dense cell (134 MB, 0.040 ms at 3.35 TB/s, for the (8192, 8192) pattern
// of an alg3 sizing pass); the indices are a few bytes an entry beside them.
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

// Pattern only (the alg2/alg3 symbolic phase reads the structure and
// nothing else).  The output, row-major, is cut into windows of kPatWindow
// consecutive cells, one CTA each, whatever the rows: a window may hold a
// piece of a row, or a few short rows and parts of two more.  The CTA zeroes
// its window in shared memory, sets the cells of the entries that fall in
// it (each row that meets the window read by a group of threads; a row
// wider than a window is read by every window it meets), and after a barrier
// writes the window out with 16-byte stores, zeros included.  Windows start
// at multiples of kPatWindow cells, so every store is 16-byte aligned
// whatever k is; only the output's last m*k % 8 cells take 2-byte stores.
// Every entry sets the same value, so neither duplicates nor the order of a
// row's entries can change the result; a column id outside [0, k) is
// ignored.
constexpr int kPatWindow = 4096;  // bf16 cells a CTA: 8 KB of shared memory
constexpr int kPatThreads = 256;
constexpr int kPatGroups = kPatThreads / 32;  // at most one warp a row

__global__ void __launch_bounds__(kPatThreads)
    densify_pattern_rows(const int* __restrict__ indptr,
                         const int* __restrict__ indices,
                         unsigned short* __restrict__ pat, long long k,
                         long long cells) {
  __shared__ uint4 win4[kPatWindow / 8];
  unsigned short* win = reinterpret_cast<unsigned short*>(win4);
  const long long e0 = static_cast<long long>(blockIdx.x) * kPatWindow;
  const int n = static_cast<int>(min(static_cast<long long>(kPatWindow),
                                     cells - e0));
  const int t = threadIdx.x;
  for (int i = t; i < (n + 7) / 8; i += kPatThreads) {
    win4[i] = make_uint4(0, 0, 0, 0);
  }
  // the rows [ra, rb) that meet the window [e0, e0 + n), split among up to
  // kPatGroups groups of threads, a row a group at a time
  const int ra = static_cast<int>(e0 / k);
  const int rb = static_cast<int>((e0 + n - 1) / k) + 1;
  const int groups = min(rb - ra, kPatGroups);
  const int size = kPatThreads / groups;
  const int group = t / size;
  const int lane = t - group * size;
  __syncthreads();
  if (group < groups) {
    for (int r = ra + group; r < rb; r += groups) {
      const long long base = static_cast<long long>(r) * k - e0;
      const int end = indptr[r + 1];
      for (int p = indptr[r] + lane; p < end; p += size) {
        const long long col = indices[p];
        const long long w = base + col;
        if (col >= 0 && col < k && w >= 0 && w < n) win[w] = kBf16One;
      }
    }
  }
  __syncthreads();
  uint4* out4 = reinterpret_cast<uint4*>(pat + e0);
  for (int i = t; i < n / 8; i += kPatThreads) out4[i] = win4[i];
  for (int i = n / 8 * 8 + t; i < n; i += kPatThreads) pat[e0 + i] = win[i];
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

// Pattern-only launch on `stream`: writes every cell of the (m, k) output,
// which need not be zeroed.  The caller guarantees m, k > 0 and a 16-byte
// aligned `pat`.
extern "C" int spmm_densify_pattern(const int* indptr, const int* indices,
                                    unsigned short* pat, int m, long long k,
                                    void* stream) {
  const long long cells = static_cast<long long>(m) * k;
  const unsigned blocks =
      static_cast<unsigned>((cells + kPatWindow - 1) / kPatWindow);
  densify_pattern_rows<<<blocks, kPatThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(indptr, indices,
                                                              pat, k, cells);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
