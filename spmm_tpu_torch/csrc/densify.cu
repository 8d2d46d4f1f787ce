// Canonical CSR -> dense values (+ bf16 structural 0/1 pattern), and the
// pattern alone.
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
// Both kernels write every cell of their output once, zeros included, in
// one launch: no fill before them.  The flat output is cut into 4096-cell
// windows, one CTA each (window.cuh, shared with route.cu's
// expand_routed): the CTA zeroes its window in shared memory, sets the
// cells of the rows that meet the window (found from indptr, each such row
// read by a group of threads; a row wider than a window is read by every
// window it meets), and after a barrier writes the window out with 16-byte
// stores.  `densify_rows` holds 16 KB of values and 8 KB of pattern a
// window; `densify_onehot_pattern`'s `densify_pattern_rows` the 8 KB of
// pattern alone.
//
// `densify_rows` is a template over the element's width, 2, 4, 8 or 16
// bytes (bfloat16; float32; float64 and complex64; complex128): a value is
// moved as one item of that width, never looked at, so every dtype of a
// width shares its instance and the output is bitwise the input's values.
// The window is kept in bytes, not cells: 4096 cells of 2 or 4 bytes,
// 2048 of 8, 1024 of 16, so the CTA holds at most 16 KB of values and
// 8 KB of pattern whatever the width.  The float32 instance is the kernel
// as it was before the template.
//
// Bound: the bytes of the dense outputs, 6 a cell with the pattern at
// float32 (w + 2 at a width of w bytes; 403 MB,
// 0.120 ms at 3.35 TB/s at 8192^2), 4 without, 2 for the pattern alone (the
// (8192, 8192) pattern of an alg3 sizing pass: 134 MB, 0.040 ms); the CSR
// is a few bytes an entry beside them.  A zero-fill of the outputs before
// a scatter would write every cell twice.
//
// Canonical CSR positions are unique, so no two entries set one cell and
// the result needs no atomics.  For the pattern alone every entry sets the
// same value, so neither duplicates nor the order of a row's entries can
// change it; a column id outside [0, k) is ignored by both kernels.
//
// Offsets are 64-bit: m*k reaches 67M at 8192^2 and row*k+col overflows
// int32 past 2^31 cells.

#include <cuda_runtime.h>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 32;  // at most one warp a row

// Cells a window of `densify_rows` at T: 16 KB of values, 4096 cells at
// most (the pattern's 8 KB).
template <typename T>
constexpr int value_window() {
  return sizeof(T) <= 4 ? spmm::kWindow : spmm::kWindow * 4 / sizeof(T);
}

// Values (items of T) and, where `pat` is not null, the pattern of one
// window of kCells cells.
template <typename T, int kCells = value_window<T>()>
__global__ void __launch_bounds__(kThreads)
    densify_rows(const int* __restrict__ indptr,
                 const int* __restrict__ indices, const T* __restrict__ data,
                 T* __restrict__ val, unsigned short* __restrict__ pat,
                 long long k, long long cells) {
  constexpr int kPerWord = 16 / sizeof(T);                   // T a uint4
  __shared__ uint4 win_val4[kCells / kPerWord];  // 16 KB (8 KB at 2 B)
  __shared__ uint4 win_pat4[kCells / 8];         // 8 KB at most
  T* win_val = reinterpret_cast<T*>(win_val4);
  unsigned short* win_pat = reinterpret_cast<unsigned short*>(win_pat4);
  const long long e0 = static_cast<long long>(blockIdx.x) * kCells;
  const int n =
      static_cast<int>(min(static_cast<long long>(kCells), cells - e0));
  const int t = threadIdx.x;
  const spmm::WindowRows rows =
      spmm::window_rows<kThreads, kGroups>(indptr, k, e0, n);
  spmm::zero_window(win_val4, (n + kPerWord - 1) / kPerWord, t, kThreads);
  if (pat != nullptr) spmm::zero_window(win_pat4, (n + 7) / 8, t, kThreads);
  __syncthreads();
  if (pat != nullptr) {
    spmm::window_entries(rows, indptr, indices, k, e0, n, [&](int w, int p) {
      win_val[w] = data[p];
      win_pat[w] = spmm::kBf16One;
    });
  } else {
    spmm::window_entries(rows, indptr, indices, k, e0, n,
                         [&](int w, int p) { win_val[w] = data[p]; });
  }
  __syncthreads();
  spmm::store_window(val + e0, win_val, n, t, kThreads);
  if (pat != nullptr) spmm::store_window(pat + e0, win_pat, n, t, kThreads);
}

// Pattern only (the alg2/alg3 symbolic phase reads the structure and
// nothing else).
__global__ void __launch_bounds__(kThreads)
    densify_pattern_rows(const int* __restrict__ indptr,
                         const int* __restrict__ indices,
                         unsigned short* __restrict__ pat, long long k,
                         long long cells) {
  __shared__ uint4 win4[spmm::kWindow / 8];  // 8 KB
  unsigned short* win = reinterpret_cast<unsigned short*>(win4);
  const long long e0 = static_cast<long long>(blockIdx.x) * spmm::kWindow;
  const int n = static_cast<int>(min(static_cast<long long>(spmm::kWindow),
                                     cells - e0));
  const int t = threadIdx.x;
  const spmm::WindowRows rows =
      spmm::window_rows<kThreads, kGroups>(indptr, k, e0, n);
  spmm::zero_window(win4, (n + 7) / 8, t, kThreads);
  __syncthreads();
  spmm::window_entries(rows, indptr, indices, k, e0, n,
                       [&](int w, int) { win[w] = spmm::kBf16One; });
  __syncthreads();
  spmm::store_window(pat + e0, win, n, t, kThreads);
}

unsigned windows(long long cells, int window = spmm::kWindow) {
  return static_cast<unsigned>((cells + window - 1) / window);
}

// A (value type, window) instance of densify_rows on `stream`.
template <typename T>
void launch_rows(const int* indptr, const int* indices, const void* data,
                 void* val, unsigned short* pat, long long k,
                 long long cells, cudaStream_t stream) {
  densify_rows<T><<<windows(cells, value_window<T>()), kThreads, 0,
                    stream>>>(indptr, indices, static_cast<const T*>(data),
                              static_cast<T*>(val), pat, k, cells);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.  `data`
// and `val` hold elements of `width` bytes (2, 4, 8 or 16), aligned to
// their width; `pat` may be null (value-only mode).  Writes every cell of
// the (m, k) outputs, which need not be zeroed.  The caller guarantees
// m, k > 0.
extern "C" int spmm_densify(const int* indptr, const int* indices,
                            const void* data, void* val, unsigned short* pat,
                            int m, long long k, int width, void* stream) {
  const long long cells = static_cast<long long>(m) * k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 2:
      launch_rows<unsigned short>(indptr, indices, data, val, pat, k, cells,
                                  s);
      break;
    case 4:
      launch_rows<float>(indptr, indices, data, val, pat, k, cells, s);
      break;
    case 8:
      launch_rows<uint2>(indptr, indices, data, val, pat, k, cells, s);
      break;
    case 16:
      launch_rows<uint4>(indptr, indices, data, val, pat, k, cells, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Pattern-only launch on `stream`: writes every cell of the (m, k) output,
// which need not be zeroed.  The caller guarantees m, k > 0.
extern "C" int spmm_densify_pattern(const int* indptr, const int* indices,
                                    unsigned short* pat, int m, long long k,
                                    void* stream) {
  const long long cells = static_cast<long long>(m) * k;
  densify_pattern_rows<<<windows(cells), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(indptr, indices,
                                                              pat, k, cells);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
