// y = A @ x over fixed entry chunks: balanced under any row skew, one
// launch, no memset.
//
// Replaces the Pallas kernel spmm_tpu/ops/kernels/spmv_onehot.py
// (`spmv_onehot`, kernel body `_kernel`).  The TPU kernel cuts the entries
// into chunks of CH and reduces each chunk into a row window with one-hot
// MXU contractions (and bf16 triples to keep f32 exact), because it cannot
// gather or scatter.  The chunking is the idea kept: every block gets CH
// entries whatever the row lengths, so a 2^20-entry row and 10^5 empty rows
// cost the same as a uniform matrix.
//
// Bound on this card: bytes, at both cells of chip_smoke.py (SpMV
// 16384^2/5e-3 and the power-law 2^20 matrix): 8 bytes an entry of
// (index, value), the x gather (4 bytes a column, mostly cached) and 8
// bytes a row (indptr, y).  The design keeps every byte moving in wide,
// coalesced transactions and spends nothing else:
//
//   * One block of 256 threads per chunk of CH = 256*K entries; thread t
//     loads its K consecutive (index, value) pairs with 16-byte vector loads
//     (a warp reads 512 contiguous bytes per instruction) and issues all K x
//     gathers before any reduction, so the loads of a block overlap.
//   * Row heads are found cooperatively: the block's threads stride over
//     the rows the chunk owns (from the plan) and mark each row's first
//     entry in shared memory; no per-thread binary search.
//   * Rows are summed by a block-wide segmented scan in a fixed order: each
//     thread's K entries in order, a shuffle scan over the warp, then one
//     step over the warps.  A row's sum is the scan at its last entry.
//   * A chunk owns the rows whose first entry lies in it (the last chunk
//     also the trailing empty rows) and writes each of them once, empty ones
//     as 0, so y needs no memset.  A row that runs past its chunk is closed
//     in the same launch: its owner stores its tail piece, each later chunk
//     its head piece, and the last of them to finish, chosen by an integer
//     counter in the plan (`spmm::join_piece`; zeroed when the plan is
//     built, reset by the closing block), adds the pieces in chunk order.
//
// So one launch per call, no float atomics, bitwise on rerun.  A plan's
// counters and carries serve one launch at a time: a plan is not shared by
// launches on two streams at once.

#include <cuda_runtime.h>

#include <cstdint>

#include "row_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// K consecutive (index, value) pairs from entry e0; entries at or past
// `end` read as (0, 0).  `vec`: both arrays are aligned for K-wide vector
// loads (the caller checks the base pointers; e0 is a multiple of K).
template <int K>
__device__ __forceinline__ void load_entries(const int* __restrict__ indices,
                                             const float* __restrict__ data,
                                             long long e0, long long end,
                                             bool vec, int (&idx)[K],
                                             float (&val)[K]) {
  if constexpr (K % 4 == 0) {
    if (vec && e0 + K <= end) {
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const int4 i4 = __ldcs(reinterpret_cast<const int4*>(indices + e0) + q);
        const float4 v4 =
            __ldcs(reinterpret_cast<const float4*>(data + e0) + q);
        idx[4 * q] = i4.x;
        idx[4 * q + 1] = i4.y;
        idx[4 * q + 2] = i4.z;
        idx[4 * q + 3] = i4.w;
        val[4 * q] = v4.x;
        val[4 * q + 1] = v4.y;
        val[4 * q + 2] = v4.z;
        val[4 * q + 3] = v4.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = e0 + j < end;
    idx[j] = in ? __ldcs(indices + e0 + j) : 0;
    val[j] = in ? __ldcs(data + e0 + j) : 0.0f;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    onehot_spmv(const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const float* __restrict__ data, const float* __restrict__ x,
                const int* __restrict__ row_s, const int* __restrict__ own,
                long long nnz, int* __restrict__ counters,
                float* __restrict__ carry, float* __restrict__ y) {
  constexpr int kCh = K * kThreads;
  __shared__ unsigned char s_head[kCh];
  __shared__ __align__(16) float s_val[kCh];
  __shared__ float s_wsum[kWarps];
  __shared__ int s_wflag[kWarps];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long start = static_cast<long long>(c) * kCh;
  const long long end = min(start + kCh, nnz);
  const long long e0 = start + static_cast<long long>(t) * K;

  // 1. the thread's entries and their x gathers, all in flight at once
  const bool vec = ((reinterpret_cast<uintptr_t>(indices) |
                     reinterpret_cast<uintptr_t>(data)) & 15) == 0;
  int idx[K];
  float val[K];
  load_entries<K>(indices, data, e0, end, vec, idx, val);
  float prod[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    prod[j] = e0 + j < end ? val[j] * __ldg(x + idx[j]) : 0.0f;
  }

  // 2. row heads: the first entry of every row this chunk owns
  const int r0 = own[c];
  const int r1 = own[c + 1];
#pragma unroll
  for (int j = 0; j < K; ++j) s_head[t * K + j] = 0;
  __syncthreads();
  for (int r = r0 + t; r < r1; r += kThreads) {
    const long long s = indptr[r];
    if (s < end) s_head[s - start] = 1;
  }
  __syncthreads();

  // 3. the thread's entries: in-order sums within each row piece
  float v[K];
  int first_head = s_head[t * K] ? 0 : K;
  v[0] = prod[0];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    const bool head = s_head[t * K + j];
    v[j] = head ? prod[j] : v[j - 1] + prod[j];
    if (head && first_head == K) first_head = j;
  }

  // 4. the sum carried into the thread: a segmented scan of (has a head,
  //    sum of the open piece) over the warp, then over the warps in order
  float s = v[K - 1];
  int f = first_head < K;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float su = __shfl_up_sync(kFull, s, o);
    const int fu = __shfl_up_sync(kFull, f, o);
    if (lane >= o) {
      if (!f) s = su + s;
      f |= fu;
    }
  }
  const float ex = __shfl_up_sync(kFull, s, 1);
  const int exf = __shfl_up_sync(kFull, f, 1);
  if (lane == 31) {
    s_wsum[warp] = s;
    s_wflag[warp] = f;
  }
  __syncthreads();
  float win = 0.0f;  // the open piece at the end of the warps before
  if (warp > 0) {
    win = s_wsum[0];
    for (int u = 1; u < warp; ++u) {
      win = s_wflag[u] ? s_wsum[u] : win + s_wsum[u];
    }
  }
  bool has_carry;
  float carry_in;
  if (lane == 0) {
    has_carry = warp > 0;
    carry_in = win;
  } else {
    has_carry = true;
    carry_in = (exf || warp == 0) ? ex : win + ex;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    s_val[t * K + j] = (has_carry && j < first_head) ? carry_in + v[j] : v[j];
  }
  __syncthreads();

  // 5. every owned row once: whole rows here; a row running past the chunk
  //    is closed below
  for (int r = r0 + t; r < r1; r += kThreads) {
    const long long rs = indptr[r];
    const long long re = indptr[r + 1];
    if (re <= end) y[r] = re > rs ? s_val[re - 1 - start] : 0.0f;
  }

  // 6. the pieces of rows that cross chunk edges; carry[2c] holds chunk c's
  //    head piece, carry[2c + 1] its tail piece
  if (warp == 0) {
    // entries before the first owned row belong to a row begun earlier
    const long long fs = r0 < r1 ? static_cast<long long>(indptr[r0]) : end;
    if (fs > start) {
      const int r = row_s[c];
      const long long rs = indptr[r];
      const long long re = indptr[r + 1];
      const int o = static_cast<int>(rs / kCh);
      const int parts = static_cast<int>((re - 1) / kCh) - o + 1;
      spmm::join_piece(
          s_val[fs - 1 - start], carry + 2 * c, counters + o, parts,
          [&](int i) {
            return __ldcg(carry + (i == 0 ? 2 * o + 1 : 2 * (o + i)));
          },
          y + r);
    }
  } else if (warp == 1 && r0 < r1) {
    const long long re = indptr[r1];  // the end of the last owned row
    if (re > end) {
      const int parts = static_cast<int>((re - 1) / kCh) - c + 1;
      spmm::join_piece(
          s_val[end - 1 - start], carry + 2 * c + 1, counters + c, parts,
          [&](int i) {
            return __ldcg(carry + (i == 0 ? 2 * c + 1 : 2 * (c + i)));
          },
          y + r1 - 1);
    }
  }
}

template <int K>
int launch(const int* indptr, const int* indices, const float* data,
           const float* x, const int* row_s, const int* own, int nchunks,
           long long nnz, int* counters, float* carry, float* y,
           cudaStream_t s) {
  onehot_spmv<K><<<nchunks, kThreads, 0, s>>>(indptr, indices, data, x,
                                              row_s, own, nnz, counters,
                                              carry, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream`; returns its cudaGetLastError(), or
// cudaErrorInvalidValue for a chunk size the kernel is not built for.  The
// caller guarantees nchunks = max(1, ceil(nnz / ch)) > 0, m > 0,
// ch = 256 * K for K in {1, 2, 4, 8, 16}, `own` (nchunks + 1 rows), `row_s`
// and `counters` (zeros, or as the last launch left them) from the plan,
// `carry` of 2 * nchunks floats.
extern "C" int spmm_spmv_onehot(const int* indptr, const int* indices,
                                const float* data, const float* x,
                                const int* row_s, const int* own,
                                int nchunks, int ch, long long nnz,
                                int* counters, float* carry, float* y,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch / kThreads) {
    case 1: return launch<1>(indptr, indices, data, x, row_s, own, nchunks,
                             nnz, counters, carry, y, s);
    case 2: return launch<2>(indptr, indices, data, x, row_s, own, nchunks,
                             nnz, counters, carry, y, s);
    case 4: return launch<4>(indptr, indices, data, x, row_s, own, nchunks,
                             nnz, counters, carry, y, s);
    case 8: return launch<8>(indptr, indices, data, x, row_s, own, nchunks,
                             nnz, counters, carry, y, s);
    case 16: return launch<16>(indptr, indices, data, x, row_s, own, nchunks,
                               nnz, counters, carry, y, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
