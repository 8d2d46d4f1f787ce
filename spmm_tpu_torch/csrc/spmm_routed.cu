// Y = A @ X over the routed plan (X (n, k), Y (m, k), both row-major f32):
// one launch, no memset.
//
// Replaces the Pallas kernels of spmm_tpu/ops/kernels/spmv_routed.py's
// multi-vector path (`_spmm_routed_call`, `_spmm_routed_call_matsum`,
// `_spmm_routed_call_fused`: `_gather_route_kernel_m`, `_sum_kernel_m`,
// `_fused_kernel_seg_m`, `_fused_kernel_dense_m`).  The TPU streams its
// routing tables once per 8 columns of X.  On Hopper a row of X is
// contiguous, so a group of G lanes takes one row of A (or one chunk of a
// long row) and G * VEC columns of X: for each entry every lane reads its
// VEC columns of X's row indices[e] and adds value * X[indices[e], c].
//
// The arithmetic (fixed by the plan, bitwise on rerun, no float atomics):
//   * every output cell of a row of length <= cut is fmaf-chained in the
//     row's entry order from 0.0f;
//   * a longer row is cut into the plan's chunks of at most `ch` entries;
//     each chunk's partial row is fmaf-chained in entry order from 0.0f,
//     and Y's row is 0.0f plus the partials added in chunk order.
//
// Bound: bytes.  The least traffic is the CSR, X and Y once each (0.0039 ms
// at 10000^2/0.01, k = 64); what the card must move is more: each entry
// gathers a row of X (256 bytes at k = 64), mostly from L2 where X fits in
// it, from HBM where it does not (the power-law 2^20 matrix's X is 268 MB).
// What the design does about it:
//   * a group's lanes hold VEC = 4 columns (16-byte loads) where k % 4 == 0
//     and X, Y are 16-byte aligned, else one; G (8, 16 or 32) is the fewest
//     lanes that reach k, and wider k is split into column blocks, each its
//     own work item.  k = 64 is half a warp a row.
//   * the row's indices and values are read 32 entries at a time with one
//     coalesced load a lane and handed out by __shfl_sync, not loaded by
//     every lane for every entry; each lane keeps kU gathers of X in flight
//     before their FMAs.
//   * one grid: the chunk items first, in the plan's `chunk_order` (by
//     their first column), so the groups in flight at any moment gather
//     the same band of X for every long row and L2 serves the repeats;
//     then the rows up to `cut`.  Each chunk stores its partial row; the
//     group that completes a long row's count (an integer counter a long
//     row in the plan, zeroed when the plan is built and reset here by that
//     group) adds the row's partials in chunk order and writes Y's row.
//     The counter decides only who adds, never the order of the sum.
//
// Every cell of Y is written once (rows up to cut by their item, empty ones
// included; long rows by their closing group).  A plan's counters serve one
// launch at a time (the plan is not shared by launches on two streams at
// once).  Offsets into X, Y and the partials are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 32;  // entries a group reads at once
constexpr int kU = 8;       // gathers (or partials) a lane keeps in flight

template <int VEC>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Partials were stored by other groups in this launch: read them from L2.
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p,
                                             float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldcg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// acc[q] = sum over e in [s, e1) of data[e] * X[indices[e], col + q],
// fmaf-chained in entry order from 0.0f.  Every lane of the group calls it
// (`mask` names the group's lanes, `gl` is the lane's place in it); lanes
// with `live` false (columns past k) gather nothing.
template <int G, int VEC>
__device__ __forceinline__ void group_dot(const int* __restrict__ indices,
                                          const float* __restrict__ data,
                                          const float* __restrict__ x,
                                          long long k, long long s,
                                          long long e1, unsigned mask, int gl,
                                          int col, bool live,
                                          float (&acc)[VEC]) {
  constexpr int R = kBatch / G;  // entries a lane loads per batch
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
  for (long long b = s; b < e1; b += kBatch) {
    int ci[R];
    float cv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long t = b + r * G + gl;
      ci[r] = t < e1 ? __ldg(indices + t) : 0;
      cv[r] = t < e1 ? __ldg(data + t) : 0.0f;
    }
    const int nb = static_cast<int>(min(static_cast<long long>(kBatch),
                                        e1 - b));
#pragma unroll
    for (int w = 0; w < kBatch; w += kU) {
      if (w < nb) {  // uniform over the group
        int c[kU];
        float v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          c[u] = __shfl_sync(mask, ci[(w + u) / G], (w + u) % G, G);
          v[u] = __shfl_sync(mask, cv[(w + u) / G], (w + u) % G, G);
        }
        float g[kU][VEC];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (live && w + u < nb) {
            load_cols<VEC>(x + static_cast<long long>(c[u]) * k + col, g[u]);
          } else {
#pragma unroll
            for (int q = 0; q < VEC; ++q) g[u][q] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (w + u < nb) {
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[q] = fmaf(v[u], g[u][q], acc[q]);
          }
        }
      }
    }
  }
}

template <int G, int VEC>
__global__ void __launch_bounds__(kThreads)
    spmm_routed(const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const float* __restrict__ data,
                const int* __restrict__ order, int nrows, int cut,
                const int* __restrict__ chunk_start,
                const int* __restrict__ chunk_end,
                const int* __restrict__ chunk_row,
                const int* __restrict__ chunk_order, int nchunks,
                const int* __restrict__ long_rows,
                const int* __restrict__ long_chunk_ptr,
                int* __restrict__ counters, const float* __restrict__ x,
                int k, float* __restrict__ partial, float* __restrict__ y) {
  constexpr int kCols = G * VEC;  // columns a group reaches
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane - gl);
  const int ncb = (k + kCols - 1) / kCols;
  const long long item =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const long long chunk_items = static_cast<long long>(nchunks) * ncb;
  const long long kk = k;
  float acc[VEC];
  if (item < chunk_items) {
    const int c = chunk_order[item / ncb];
    const int col = static_cast<int>(item % ncb) * kCols + gl * VEC;
    const bool live = col < k;
    group_dot<G, VEC>(indices, data, x, kk, chunk_start[c], chunk_end[c],
                      mask, gl, col, live, acc);
    if (live) store_cols<VEC>(partial + c * kk + col, acc);
    // join: the group whose count completes the row adds its partials
    __threadfence();
    __syncwarp(mask);
    const int i = chunk_row[c];
    const int c0 = long_chunk_ptr[i];
    const int c1 = long_chunk_ptr[i + 1];
    int last = 0;
    if (gl == 0) last = atomicAdd(counters + i, 1) == (c1 - c0) * ncb - 1;
    if (!__shfl_sync(mask, last, 0, G)) return;
    __threadfence();
    float* yr = y + static_cast<long long>(long_rows[i]) * kk;
    for (int b = gl * VEC; b < k; b += kCols) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
      for (int p = c0; p < c1; p += kU) {
        float g[kU][VEC];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (p + u < c1) {
            load_partial<VEC>(partial + (p + u) * kk + b, g[u]);
          } else {
#pragma unroll
            for (int q = 0; q < VEC; ++q) g[u][q] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (p + u < c1) {
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[q] += g[u][q];
          }
        }
      }
      store_cols<VEC>(yr + b, acc);
    }
    if (gl == 0) counters[i] = 0;
    return;
  }
  const long long j = item - chunk_items;
  if (j >= static_cast<long long>(nrows) * ncb) return;
  const int i = static_cast<int>(j / ncb);
  const int row = order != nullptr ? order[i] : i;
  const int s = indptr[row];
  const int e1 = indptr[row + 1];
  if (e1 - s > cut) return;  // a long row: its chunks write it
  const int col = static_cast<int>(j % ncb) * kCols + gl * VEC;
  const bool live = col < k;
  group_dot<G, VEC>(indices, data, x, kk, s, e1, mask, gl, col, live, acc);
  if (live) store_cols<VEC>(y + static_cast<long long>(row) * kk + col, acc);
}

template <int G, int VEC>
int launch(const int* indptr, const int* indices, const float* data,
           const int* order, int nrows, int cut, const int* chunk_start,
           const int* chunk_end, const int* chunk_row, const int* chunk_order,
           int nchunks, const int* long_rows, const int* long_chunk_ptr,
           int* counters, const float* x, int k, float* partial, float* y,
           cudaStream_t s) {
  constexpr int kCols = G * VEC;
  const long long ncb = (k + kCols - 1) / kCols;
  const long long items = (static_cast<long long>(nchunks) + nrows) * ncb;
  const long long blocks = (items + kThreads / G - 1) / (kThreads / G);
  if (blocks <= 0 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  spmm_routed<G, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      indptr, indices, data, order, nrows, cut, chunk_start, chunk_end,
      chunk_row, chunk_order, nchunks, long_rows, long_chunk_ptr, counters, x,
      k, partial, y);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// One launch on `stream`; returns its cudaGetLastError().  `order` may be
// null (rows 0..nrows-1; rows longer than cut are skipped there).  The caller
// guarantees k > 0 and nrows + nchunks > 0; `counters` (one a long row) are
// zero or as the last launch left them; `partial` holds nchunks rows of k.
// The choice of VEC and G is mirrored by spmv_routed.py's `spmm_groups`.
extern "C" int spmm_spmm_routed(const int* indptr, const int* indices,
                                const float* data, const int* order,
                                int nrows, int cut, const int* chunk_start,
                                const int* chunk_end, const int* chunk_row,
                                const int* chunk_order, int nchunks,
                                const int* long_rows,
                                const int* long_chunk_ptr, int* counters,
                                const float* x, int k, float* partial,
                                float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = k % 4 == 0 && aligned16(x) && aligned16(y) &&
                    aligned16(partial);
  const int lanes = vec4 ? k / 4 : k;  // lanes that reach k
#define SPMM_LAUNCH(G, VEC)                                                 \
  return launch<G, VEC>(indptr, indices, data, order, nrows, cut,           \
                        chunk_start, chunk_end, chunk_row, chunk_order,     \
                        nchunks, long_rows, long_chunk_ptr, counters, x, k, \
                        partial, y, s)
  if (vec4) {
    if (lanes <= 8) SPMM_LAUNCH(8, 4);
    if (lanes <= 16) SPMM_LAUNCH(16, 4);
    SPMM_LAUNCH(32, 4);
  }
  if (lanes <= 8) SPMM_LAUNCH(8, 1);
  if (lanes <= 16) SPMM_LAUNCH(16, 1);
  SPMM_LAUNCH(32, 1);
#undef SPMM_LAUNCH
}
