// y = A @ x over fixed entry chunks: balanced under any row skew.
//
// Replaces the Pallas kernel spmm_tpu/ops/kernels/spmv_onehot.py
// (`spmv_onehot`, kernel body `_kernel`).  The TPU kernel cuts the entries
// into chunks of CH and reduces each chunk into a row window [r0, r0 + W)
// with one-hot MXU contractions (and bf16 triples to keep f32 exact),
// because it cannot gather or scatter.  The chunking is the idea kept: every
// block gets CH entries whatever the row lengths, so a 2^20-entry row and
// 10^5 empty rows cost the same as a uniform matrix.
//
//   onehot_chunks: block c (256 threads) owns entries [c*CH, c*CH + CH);
//     thread t owns CH/256 consecutive ones.  A thread finds its first
//     row by binary search in indptr over the chunk's row window
//     [row_s[c], row_e[c]] (from the plan), walks its entries adding
//     data * x[col] in entry order, and writes every row it holds whole.
//     A row split between threads is summed by the thread that holds its
//     start, which adds the following threads' pieces in thread order from
//     shared memory.  The chunk's edge rows go to the carry buffer:
//     carry_first[c] for the row begun in an earlier chunk, carry_last[c]
//     for the row that runs into the next one.
//   onehot_fixup: one thread per chunk whose last row starts in it and runs
//     past its end adds carry_last[c] and then carry_first of the following
//     chunks, in chunk order, and writes the row.
//
// Every row is written once and every sum has a fixed order: no atomics,
// bitwise on rerun.  Empty rows are never written (the wrapper zero-fills
// y).
//
// Bound: bytes, 8 per entry plus the x gather; the row searches read indptr
// from cache.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kActive = 1, kSingle = 2, kLastOpen = 4;

// Largest r in [lo, hi] with indptr[r] <= e (the row holding entry e);
// requires indptr[lo] <= e.
__device__ __forceinline__ int row_of(const int* __restrict__ indptr,
                                      long long e, int lo, int hi) {
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (indptr[mid] <= e) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The thread holding a split row's start adds the following pieces in
// thread order: whole threads of that row (single and still open), then the
// closing piece of the first thread where it ends.  Returns true if the row
// ran past the chunk's end.
__device__ __forceinline__ bool walk(const float* s_head,
                                     const unsigned* s_flags, int t,
                                     float sum, float* out) {
  for (int u = t + 1; u < kThreads && (s_flags[u] & kActive); ++u) {
    sum += s_head[u];
    if ((s_flags[u] & (kSingle | kLastOpen)) != (kSingle | kLastOpen)) {
      *out = sum;
      return false;
    }
  }
  *out = sum;
  return true;
}

__global__ void onehot_chunks(const int* __restrict__ indptr,
                              const int* __restrict__ indices,
                              const float* __restrict__ data,
                              const float* __restrict__ x,
                              const int* __restrict__ row_s,
                              const int* __restrict__ row_e, int ch,
                              long long nnz, float* __restrict__ carry_first,
                              float* __restrict__ carry_last,
                              float* __restrict__ y) {
  __shared__ float s_head[kThreads];
  __shared__ unsigned s_flags[kThreads];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const long long start = static_cast<long long>(c) * ch;
  const long long end = min(start + ch, nnz);
  const int per = ch / kThreads;
  const long long e0 = start + static_cast<long long>(t) * per;
  const long long e1 = min(e0 + per, end);
  const int re = row_e[c];

  unsigned flags = 0;
  bool first_open = false;
  float acc = 0.0f;
  float head = 0.0f;
  int r = 0;
  if (e0 < e1) {
    flags = kActive;
    r = row_of(indptr, e0, row_s[c], re);
    long long next = indptr[r + 1];
    first_open = indptr[r] < e0;  // the row began in an earlier thread
    bool in_first = true;
    for (long long e = e0; e < e1; ++e) {
      if (e >= next) {  // row r ends before e
        if (in_first && first_open) {
          head = acc;  // the end piece of a row begun earlier
        } else {
          y[r] = acc;  // a whole row inside this thread
        }
        in_first = false;
        r = row_of(indptr, e, r + 1, re);
        next = indptr[r + 1];
        acc = 0.0f;
      }
      acc = fmaf(data[e], __ldg(x + indices[e]), acc);
    }
    const bool last_open = next > e1;  // row r runs past this thread
    if (in_first) {
      flags |= kSingle;
      head = acc;
    }
    if (last_open) {
      flags |= kLastOpen;
    } else if (!(in_first && first_open)) {
      y[r] = acc;  // begun and ended inside this thread
    }
  }
  s_head[t] = head;
  s_flags[t] = flags;
  __syncthreads();

  if (t == 0 && first_open) {
    // the chunk's first row began in an earlier chunk: all of its pieces
    // here go to carry_first, whether or not it ends in this chunk
    float sum = head;
    if ((flags & kSingle) && (flags & kLastOpen)) {
      walk(s_head, s_flags, t, head, &sum);
    }
    carry_first[c] = sum;
  }
  if ((flags & kLastOpen) && !((flags & kSingle) && first_open)) {
    float sum = 0.0f;
    if (walk(s_head, s_flags, t, acc, &sum)) {
      carry_last[c] = sum;  // continues in the next chunk
    } else {
      y[r] = sum;
    }
  }
}

__global__ void onehot_fixup(const int* __restrict__ indptr,
                             const int* __restrict__ row_e, int nchunks,
                             int ch, long long nnz,
                             const float* __restrict__ carry_first,
                             const float* __restrict__ carry_last,
                             float* __restrict__ y) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nchunks) return;
  const long long start = static_cast<long long>(c) * ch;
  const long long end = min(start + ch, nnz);
  const int r = row_e[c];
  const long long row_end = indptr[r + 1];
  // only the chunk where row r starts, and only if r runs past it
  if (indptr[r] < start || row_end <= end) return;
  float acc = carry_last[c];
  for (int c2 = c + 1; c2 < nchunks; ++c2) {
    acc += carry_first[c2];
    if (row_end <= static_cast<long long>(c2 + 1) * ch) break;
  }
  y[r] = acc;
}

}  // namespace

// Launches both kernels on `stream`; returns the first cudaGetLastError()
// that is not success.  The caller guarantees nchunks > 0, ch a positive
// multiple of 256, y and both carries zero-filled.
extern "C" int spmm_spmv_onehot(const int* indptr, const int* indices,
                                const float* data, const float* x,
                                const int* row_s, const int* row_e,
                                int nchunks, int ch, int nnz,
                                float* carry_first, float* carry_last,
                                float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  onehot_chunks<<<nchunks, kThreads, 0, s>>>(indptr, indices, data, x, row_s,
                                             row_e, ch, nnz, carry_first,
                                             carry_last, y);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  onehot_fixup<<<(nchunks + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      indptr, row_e, nchunks, ch, nnz, carry_first, carry_last, y);
  return static_cast<int>(cudaGetLastError());
}
