// The window writer shared by the kernels that write a dense (m, k) output
// once, zeros included, with no fill before them: `densify_rows` and
// `densify_pattern_rows` (densify.cu) and `expand_routed` (route.cu).
//
// The flat row-major output is cut into windows of kWindow consecutive
// cells, one CTA each, whatever the rows.  The CTA zeroes its window in
// shared memory, sets the cells of the entries that fall in it, and after
// a barrier writes the window out with 16-byte stores.  Windows start at
// multiples of the window (kWindow cells, or 16 KB of values at elements of
// 8 or 16 bytes), so every store of an output that starts on a 16-byte
// boundary is aligned whatever k is; only an output that does not (a
// workspace given by the caller) and the last window's ragged tail take
// narrow stores.

#pragma once

#include <cuda_runtime.h>

namespace spmm {

constexpr int kWindow = 4096;                // cells a CTA
constexpr unsigned short kBf16One = 0x3F80;  // bf16 bit pattern of 1.0

// Zero the first `words` 16-byte words of a window in shared memory.
__device__ __forceinline__ void zero_window(uint4* win, int words, int t,
                                            int threads) {
  for (int i = t; i < words; i += threads) win[i] = make_uint4(0, 0, 0, 0);
}

// Write the window's n cells, held in shared memory at `win`, to `out`:
// 16-byte stores where `out` is 16-byte aligned, then cell stores for the
// rest.  The bits are copied, never computed.
template <typename T>
__device__ __forceinline__ void store_window(T* out, const T* win, int n,
                                             int t, int threads) {
  constexpr int kPer = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<unsigned long long>(out) & 15) == 0) {
    uint4* out4 = reinterpret_cast<uint4*>(out);
    const uint4* win4 = reinterpret_cast<const uint4*>(win);
    for (int i = t; i < n / kPer; i += threads) out4[i] = win4[i];
    done = n / kPer * kPer;
  }
  for (int i = done + t; i < n; i += threads) out[i] = win[i];
}

// The rows [ra, rb) of a CSR with k columns that meet the window
// [e0, e0 + n), split among up to kGroups groups of threads, a row a group
// at a time, the group's threads striding the row's entries; a row wider
// than a window is read by every window it meets.  Made before the CTA's
// first barrier, so that the loads of each group's first row bounds
// overlap the zeroing of the window.
struct WindowRows {
  int rb, groups, size, lane;
  int r, s, e;  // this group's first row and its entry range
};

template <int kThreads, int kGroups>
__device__ __forceinline__ WindowRows window_rows(const int* __restrict__ indptr,
                                                  long long k, long long e0,
                                                  int n) {
  WindowRows w;
  const int ra = static_cast<int>(e0 / k);
  w.rb = static_cast<int>((e0 + n - 1) / k) + 1;
  w.groups = min(w.rb - ra, kGroups);
  w.size = kThreads / w.groups;
  const int group = threadIdx.x / w.size;
  w.lane = threadIdx.x - group * w.size;
  w.r = group < w.groups ? ra + group : w.rb;
  w.s = w.r < w.rb ? indptr[w.r] : 0;
  w.e = w.r < w.rb ? indptr[w.r + 1] : 0;
  return w;
}

// Call set(w, p) for every entry p of the rows of `rows` whose cell lies in
// the window [e0, e0 + n), w its place in the window.  A column id outside
// [0, k) sets nothing.
template <typename Set>
__device__ __forceinline__ void window_entries(WindowRows rows,
                                               const int* __restrict__ indptr,
                                               const int* __restrict__ indices,
                                               long long k, long long e0,
                                               int n, Set set) {
  for (int r = rows.r; r < rows.rb; r += rows.groups) {
    if (r != rows.r) {
      rows.s = indptr[r];
      rows.e = indptr[r + 1];
    }
    const long long base = static_cast<long long>(r) * k - e0;
    for (int p = rows.s + rows.lane; p < rows.e; p += rows.size) {
      const long long col = indices[p];
      const long long w = base + col;
      if (col >= 0 && col < k && w >= 0 && w < n) set(static_cast<int>(w), p);
    }
  }
}

}  // namespace spmm
