// y = A @ x for a canonical f32 CSR over a plan of row-length classes: one
// persistent launch, no memset.
//
// Replaces the Pallas kernels of spmm_tpu/ops/kernels/spmv_binned.py
// (`_spmv_binned_call`: `_gather_kernel` and `_reduce_kernel`).  The TPU
// cannot gather across sublanes, so its plan bins entries by column class
// for a lane gather and reduces rows with a masked select.  Hopper gathers
// x directly; what a GPU SpMV must balance instead is row length.
//
// Bound on this card: bytes, at both cells of chip_smoke.py (SpMV
// 16384^2/5e-3, where every row is medium, and the power-law 2^20 matrix,
// where 96 rows hold 98 % of the 11.2 M entries and the longest 2^20): 8
// bytes an entry of (index, value), the x gather, 16 bytes a row (indptr
// twice, the row's place in the plan, y).  The design spreads those bytes
// evenly over the SMs in one launch:
//
//   * The plan (built on the device with no host sync, by the two plan
//     kernels below) partitions the rows stably into four length classes
//     and cuts every row of class 3 into pieces of kPiece entries:
//
//       class 0  len <= 4      one thread per row, 256 rows a unit
//       class 1  len <= 64     8 lanes per row, 32 rows a unit
//       class 2  len <= 2048   one warp per row, 8 rows a unit
//       class 3  len >  2048   one block per piece of kPiece entries
//
//   * The units form one fixed map: the pieces first, then the class 2,
//     1 and 0 units.  The host launches a grid of at most (SMs x resident
//     blocks per SM) blocks, fixed from m and nnz, and block b takes units
//     b, b + grid, ...; the class sizes are read on the device.  A
//     2^20-entry row becomes 256 pieces on as many blocks instead of one
//     block streaming 8 MB.
//   * Lanes stride a row or a piece and combine by a fixed shuffle tree
//     (row_sum.cuh); a row cut into several pieces is closed by the last of
//     its blocks to finish, chosen by an integer counter in the plan
//     (`spmm::join_piece`: zeroed when the plan is built, reset by the
//     closing block), which adds the piece sums in piece order.
//
// Every row, empty ones included, is written by exactly one unit, so y
// needs no memset; no float atomics; the order of every sum depends on the
// row's length only, so reruns are bitwise equal.  A plan's counters serve
// one launch at a time.

#include <cuda_runtime.h>

#include "grid.cuh"
#include "row_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kClasses = 4;   // row-length classes (NCLASSES)
constexpr int kPiece = 4096;  // entries of a hub row per block (PIECE)

// Rows rows[i] for i in [g*R, g*R + R) of a class of `count` rows, W lanes
// each (R = kThreads / W); a row of length 0 is written as 0.
template <int W>
__device__ __forceinline__ void group_unit(const int* __restrict__ indptr,
                                           const int* __restrict__ indices,
                                           const float* __restrict__ data,
                                           const float* __restrict__ x,
                                           const int* __restrict__ rows,
                                           int count, int g,
                                           float* __restrict__ y) {
  constexpr int kGroups = kThreads / W;
  const int i = g * kGroups + static_cast<int>(threadIdx.x) / W;
  const int lane = threadIdx.x % W;
  const bool valid = i < count;
  const int row = valid ? rows[i] : 0;
  const int s = valid ? indptr[row] : 0;
  const int e = valid ? indptr[row + 1] : 0;
  float acc = spmm::strided_dot(indices, data, x, s, e, lane, W);
  acc = spmm::group_tree_sum<W>(acc);
  if (valid && lane == 0) y[row] = acc;
}

__global__ void __launch_bounds__(kThreads)
    binned_spmv(const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const float* __restrict__ data, const float* __restrict__ x,
                const int* __restrict__ rows,
                const int* __restrict__ class_off,
                const int* __restrict__ piece_end,
                const int* __restrict__ piece_row, int m,
                int* __restrict__ counters, float* __restrict__ partial,
                float* __restrict__ y) {
  __shared__ float smem[kThreads / 32];
  const int n0 = class_off[1] - class_off[0];
  const int n1 = class_off[2] - class_off[1];
  const int n2 = class_off[3] - class_off[2];
  // units of each class, in map order: pieces, class 2, class 1, class 0
  const int u3 = piece_end[m - 1];
  const int u2 = u3 + (n2 + kThreads / 32 - 1) / (kThreads / 32);
  const int u1 = u2 + (n1 + kThreads / 8 - 1) / (kThreads / 8);
  const int u0 = u1 + (n0 + kThreads - 1) / kThreads;
  for (int u = blockIdx.x; u < u0; u += gridDim.x) {
    if (u < u3) {
      // piece k of hub row r; its pieces are p = f, ..., f + parts - 1
      const int r = piece_row[u];
      const int rs = indptr[r];
      const int re = indptr[r + 1];
      const int parts = (re - rs + kPiece - 1) / kPiece;
      const int f = piece_end[r] - parts;
      const int ps = rs + (u - f) * kPiece;
      const int pe = min(ps + kPiece, re);
      float acc = spmm::strided_dot(indices, data, x, ps, pe, threadIdx.x,
                                    kThreads);
      acc = spmm::block_tree_sum<kThreads>(acc, smem);
      if (threadIdx.x < 32) {
        if (parts == 1) {
          if (threadIdx.x == 0) y[r] = acc;
        } else {
          spmm::join_piece(
              acc, partial + u, counters + f, parts,
              [&](int i) { return __ldcg(partial + f + i); }, y + r);
        }
      }
    } else if (u < u2) {
      group_unit<32>(indptr, indices, data, x, rows + class_off[2], n2,
                     u - u3, y);
    } else if (u < u1) {
      group_unit<8>(indptr, indices, data, x, rows + class_off[1], n1,
                    u - u2, y);
    } else {
      group_unit<1>(indptr, indices, data, x, rows + class_off[0], n0,
                    u - u1, y);
    }
  }
}

// -- the plan, on the device: two launches, no sort, no host sync ----------
//
// The port's own kernels, beside the plain version (spmv_binned.py's
// torch operations, which the CPU runs): a stable partition of the rows by
// class is one exclusive scan of the per-class counts in row order, done
// as a count pass over tiles of kTile rows and a place pass that adds the
// tiles before its own.  Integer sums only, so the plan is the plain
// version's bit for bit.

constexpr int kPlanRows = 8;                    // rows per thread
constexpr int kTile = kThreads * kPlanRows;     // rows per block
constexpr int kStats = 5;                       // classes 0-3, pieces
constexpr int kWarps = kThreads / 32;

// the class of a row of `len` entries (CLASS_BOUNDS: 4, 64, 2048)
__device__ __forceinline__ int class_of(int len) {
  return (len > 4) + (len > 64) + (len > 2048);
}

__device__ __forceinline__ int pieces_of(int len) {
  return class_of(len) == kClasses - 1 ? (len + kPiece - 1) / kPiece : 0;
}

// Exclusive scan of v over the block's threads, in place, and the block's
// totals.  Every thread must call it; `smem` holds kWarps * kStats ints.
__device__ __forceinline__ void block_scan(int (&v)[kStats],
                                           int (&total)[kStats], int* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl[kStats];
#pragma unroll
  for (int j = 0; j < kStats; ++j) {
    incl[j] = v[j];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl[j], o);
      if (lane >= o) incl[j] += up;
    }
    if (lane == 31) smem[warp * kStats + j] = incl[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kStats; ++j) {
    int before = 0;
    int all = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int s = smem[w * kStats + j];
      before += w < warp ? s : 0;
      all += s;
    }
    v[j] = before + incl[j] - v[j];
    total[j] = all;
  }
  __syncthreads();  // smem is rewritten by the next call
}

// This thread's rows: their lengths and the per-class counts and pieces.
__device__ __forceinline__ void tile_rows(const int* __restrict__ indptr,
                                          int m, int r0, int (&len)[kPlanRows],
                                          int (&v)[kStats]) {
#pragma unroll
  for (int j = 0; j < kStats; ++j) v[j] = 0;
#pragma unroll
  for (int k = 0; k < kPlanRows; ++k) {
    const int r = r0 + k;
    len[k] = r < m ? indptr[r + 1] - indptr[r] : -1;
    if (len[k] >= 0) {
      v[class_of(len[k])] += 1;
      v[4] += pieces_of(len[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    plan_count(const int* __restrict__ indptr, int m,
               int* __restrict__ tile_stats) {
  __shared__ int smem[kWarps * kStats];
  int len[kPlanRows];
  int v[kStats];
  int total[kStats];
  tile_rows(indptr, m, blockIdx.x * kTile + threadIdx.x * kPlanRows, len, v);
  block_scan(v, total, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kStats; ++j) {
      tile_stats[blockIdx.x * kStats + j] = total[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    plan_place(const int* __restrict__ indptr, int m,
               const int* __restrict__ tile_stats, int ntiles,
               int* __restrict__ rows, int* __restrict__ class_off,
               int* __restrict__ piece_end, int* __restrict__ piece_row,
               int* __restrict__ counters) {
  __shared__ int smem[kWarps * kStats];
  // the counts of the tiles before this one, and of all tiles
  int before[kStats] = {0, 0, 0, 0, 0};
  int all[kStats] = {0, 0, 0, 0, 0};
  for (int t = threadIdx.x; t < ntiles; t += kThreads) {
#pragma unroll
    for (int j = 0; j < kStats; ++j) {
      const int s = tile_stats[t * kStats + j];
      all[j] += s;
      before[j] += t < static_cast<int>(blockIdx.x) ? s : 0;
    }
  }
  int before_tot[kStats];
  int all_tot[kStats];
  block_scan(before, before_tot, smem);
  block_scan(all, all_tot, smem);
  // where each class's rows of this tile begin in `rows`
  int next[kClasses];
  int start = 0;
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
    next[c] = start + before_tot[c];
    start += all_tot[c];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int off = 0;
#pragma unroll
    for (int c = 0; c < kClasses; ++c) {
      class_off[c] = off;
      off += all_tot[c];
    }
    class_off[kClasses] = off;
  }
  const int r0 = blockIdx.x * kTile + threadIdx.x * kPlanRows;
  int len[kPlanRows];
  int v[kStats];
  int total[kStats];
  tile_rows(indptr, m, r0, len, v);
  block_scan(v, total, smem);
#pragma unroll
  for (int c = 0; c < kClasses; ++c) next[c] += v[c];
  int pe = before_tot[4] + v[4];
#pragma unroll
  for (int k = 0; k < kPlanRows; ++k) {
    if (len[k] < 0) break;
    const int r = r0 + k;
    rows[next[class_of(len[k])]++] = r;
    const int p = pieces_of(len[k]);
    pe += p;
    piece_end[r] = pe;
    if (p > 0) {  // a class-3 row: its pieces, and its counter zeroed
      counters[pe - p] = 0;
      for (int q = pe - p; q < pe; ++q) piece_row[q] = r;
    }
  }
}

}  // namespace

// The plan's two launches on `stream`; returns the first cudaGetLastError()
// that is not success.  The caller guarantees m > 0, ntiles =
// ceil(m / kTile) and tile_stats of kStats * ntiles ints.
extern "C" int spmm_spmv_binned_plan(const int* indptr, int m, int ntiles,
                                     int* tile_stats, int* rows,
                                     int* class_off, int* piece_end,
                                     int* piece_row, int* counters,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  plan_count<<<ntiles, kThreads, 0, s>>>(indptr, m, tile_stats);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_place<<<ntiles, kThreads, 0, s>>>(indptr, m, tile_stats, ntiles, rows,
                                         class_off, piece_end, piece_row,
                                         counters);
  return static_cast<int>(cudaGetLastError());
}

// One launch on `stream`; returns its cudaGetLastError().  `max_units`
// bounds the plan's work units (from m and nnz, on the host); the grid is
// the smaller of that and the blocks the card holds at once.  The caller
// guarantees m > 0 and the plan's arrays (rows, class_off, piece_end,
// piece_row, counters and partial) as spmv_binned.py builds them.
extern "C" int spmm_spmv_binned(const int* indptr, const int* indices,
                                const float* data, const float* x,
                                const int* rows, const int* class_off,
                                const int* piece_end, const int* piece_row,
                                int* counters, float* partial, float* y,
                                int m, int max_units, void* stream) {
  static int resident[spmm::kMaxDevices];
  cudaError_t err = cudaSuccess;
  const int most =
      spmm::resident_blocks(binned_spmv, kThreads, resident, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = max_units < most ? max_units : most;
  binned_spmv<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, data, x, rows, class_off, piece_end, piece_row, m,
      counters, partial, y);
  return static_cast<int>(cudaGetLastError());
}
