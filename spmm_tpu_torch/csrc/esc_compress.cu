// ESC's compress: lex-sorted (row, col, val) triplets -> the canonical CSR
// (indptr, col, alpha * run sums), each run of equal (row, col) summed in
// the association of the fixed doubling tree, in two kernels.
//
// It replaces no Pallas kernel: the JAX package compresses with `jnp` ops
// (spmm_tpu/ops/spgemm.py::_compress, a Hillis-Steele scan of log2(P)
// passes in spmm_tpu/ops/_primitives.py::segsum_tree, then a compaction of
// the run heads and gathers), and the port ran the same passes as torch
// ops: about 300 host calls at 0.55 M products, each a pass over P.  The
// bits are that scan's, which native/spgemm_cross_check.cpp replays.
//
// The association.  The scan's total of a run v_0 .. v_{L-1} depends only
// on the run: at its last position the scan adds the 2^h values before it
// (h the top bit of L - 1, a perfect tree by then) to what the earlier
// steps left at position L - 1 - 2^h, which is the total of the rest of
// the run.  Unrolled: v_1 .. v_{L-1} cut left to right into blocks of the
// set bits of L - 1, smallest first; each block a perfect binary tree,
// right half + left half; total = B_1 + (B_2 + (... + (B_k + v_0))) with
// B_1 the rightmost (largest) block.  So a run takes its L - 1 additions in
// one pass, with one partial sum a tree level, and a run of one entry adds
// nothing (a -0.0 product stays -0.0: there is no +0.0 seed).
//
// 1. `count_runs`: each thread counts the run heads ((row, col) differs
//    from the previous position's; position 0 is one) among the positions
//    it strides over; a block's total goes to the 0-d count by one integer
//    atomicAdd, exact in any order.  The host reads the count to size the
//    outputs exactly.
// 2. `compress_runs`: tiles of kTile positions.  A tile stages its rows and
//    columns (and the position before it) in shared memory, flags its heads
//    by warp ballots in position order, ranks them by a scan of the
//    ballots' counts and its prefix over the tiles before it by a decoupled
//    look-back (lookback.cuh), and lists its heads' offsets in order.  Run
//    j of the tile is output slot base + j.  Its threads sum one run each,
//    where the next head lies within kShort positions; a longer run, and the
//    tile's last run (whose end may lie in a later tile: a warp finds it by
//    ballots), goes to a warp, whose lanes sum the large blocks' subtrees
//    side by side and join them in the tree's pairs by shuffles.  Each run
//    writes col and alpha * sum into its slot and indptr for the rows from
//    the previous run's row (exclusive) to its own; the last run writes the
//    rows after it.  Every output entry is written by one run, so no fill
//    runs before the kernel.  Additions and the product by alpha are the
//    round-to-nearest intrinsics, in the forms torch's card ops take (see
//    `add` and `scale`).
//
// Bound: bytes.  Rows and columns are read twice (8 bytes a product in
// each kernel), the values once; col, vals and indptr written once.  The
// torch passes moved a P-long array several times in each of log2(P)
// steps.  Workspace: the count, and one status word a tile of 2048
// positions; no array of P.  The ticket and the count are the only
// atomics; there are no float atomics, so the output is bitwise the same
// on every rerun.
//
// Types: every dtype ESC takes, each added and scaled as torch's card ops
// add and scale it, so the bits are the torch passes' (the value type's
// `add` and `scale` below): float32, float64; bfloat16, each sum and
// product in float rounded to bfloat16; complex64 and complex128, torch's
// a + 1 * b and alpha * v in c10::complex's formulas.  Positions fit
// int32: the wrapper checks P < 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grid.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                 // positions a thread in a tile
constexpr int kTile = kThreads * kRounds;  // 2048 positions
constexpr int kBallots = kRounds * kWarps;
constexpr int kShort = 32;                 // the longest run one thread sums
constexpr int kLongSlots = kTile / (kShort + 1) + 2;
constexpr int kLevels = 6;                 // levels of tree_small: 32 values
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBallots == 64, "the ballot scan holds two counts a lane");

// add(x, y): torch's card add x + y, for x the later partial sum (the
// tree's right side) and y the earlier.  scale(alpha, v): torch's product
// of the values by a host scalar, alpha * v.  Round-to-nearest intrinsics,
// never contracted into an fma except where torch's own build contracts.
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float scale(float alpha, float v) {
  return mul(alpha, v);
}
__device__ __forceinline__ double scale(double alpha, double v) {
  return mul(alpha, v);
}
// bfloat16: the sum or product in float, rounded to bfloat16 once
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ __nv_bfloat16 scale(__nv_bfloat16 alpha,
                                               __nv_bfloat16 v) {
  return __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(alpha), __bfloat162float(v)));
}
// complex: torch adds x + alpha * y with alpha = 1 + 0i, so y's parts pass
// through 1 * re - 0 * im and 1 * im + 0 * re (a -0.0 part can turn +0.0
// there); its product (ar + ai i)(vr + vi i) is ar vr - ai vi and
// ar vi + ai vr, each first product fused with the second's result
// (nvcc's contraction of c10::complex's formulas)
template <typename C>
__device__ __forceinline__ C cadd(C a, C b) {
  using R = decltype(a.x);
  const R br = add(mul(R(1), b.x), -mul(R(0), b.y));
  const R bi = add(mul(R(1), b.y), mul(R(0), b.x));
  return C{add(a.x, br), add(a.y, bi)};
}
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return cadd(a, b);
}
__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return cadd(a, b);
}
__device__ __forceinline__ float2 scale(float2 alpha, float2 v) {
  return make_float2(__fmaf_rn(alpha.x, v.x, -__fmul_rn(alpha.y, v.y)),
                     __fmaf_rn(alpha.x, v.y, __fmul_rn(alpha.y, v.x)));
}
__device__ __forceinline__ double2 scale(double2 alpha, double2 v) {
  return make_double2(__fma_rn(alpha.x, v.x, -__dmul_rn(alpha.y, v.y)),
                      __fma_rn(alpha.x, v.y, __dmul_rn(alpha.y, v.x)));
}

// a lane's value from lane ^ o, any value type
__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(kFull, v, o);
}
__device__ __forceinline__ double shfl_xor(double v, int o) {
  return __shfl_xor_sync(kFull, v, o);
}
__device__ __forceinline__ __nv_bfloat16 shfl_xor(__nv_bfloat16 v, int o) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(
      __shfl_xor_sync(kFull, static_cast<unsigned>(__bfloat16_as_ushort(v)),
                      o)));
}
__device__ __forceinline__ float2 shfl_xor(float2 v, int o) {
  return make_float2(shfl_xor(v.x, o), shfl_xor(v.y, o));
}
__device__ __forceinline__ double2 shfl_xor(double2 v, int o) {
  return make_double2(shfl_xor(v.x, o), shfl_xor(v.y, o));
}

// The perfect binary tree over v[0 .. w), w a power of two up to 32: value
// i joins the pending sums of the levels of i's trailing ones, each as
// (newer + older).  The levels' indices are constants after unrolling, so
// the pending sums stay in registers.
template <typename T>
__device__ __forceinline__ T tree_small(const T* __restrict__ v, int w) {
  T lvl[kLevels] = {};
  T x = T();
  for (int i = 0; i < w; ++i) {
    x = v[i];
#pragma unroll
    for (int k = 0; k < kLevels; ++k) {
      if (!((i >> k) & 1)) {
        lvl[k] = x;
        break;
      }
      x = add(x, lvl[k]);
    }
  }
  return x;
}

// The same tree over any power of two w, its pending sums in a stack in
// local memory: a warp's lane takes 1/32 of a large block.
template <typename T>
__device__ __noinline__ T tree_deep(const T* __restrict__ v, long long w) {
  T stack[32];
  int sp = 0;
  for (long long i = 0; i < w; ++i) {
    T x = v[i];
    for (long long c = i; c & 1; c >>= 1) x = add(x, stack[--sp]);
    stack[sp++] = x;
  }
  return stack[0];
}

// A run's total in one thread, len <= kShort + 1 (blocks of at most 16).
template <typename T>
__device__ __forceinline__ T run_total(const T* __restrict__ v, int len) {
  T acc = v[0];
  int pos = 1;
  for (int rest = len - 1; rest; rest &= rest - 1) {
    const int w = rest & -rest;
    acc = add(tree_small(v + pos, w), acc);
    pos += w;
  }
  return acc;
}

// A run's total by a whole warp, in every lane: blocks of 32 and more are
// cut into 32 subtrees, one a lane, joined pairwise by shuffles (both lanes
// of a pair form right + left); smaller blocks every lane sums alike.
template <typename T>
__device__ T warp_run_total(const T* __restrict__ v, long long len,
                            int lane) {
  T acc = v[0];
  long long pos = 1;
  for (long long rest = len - 1; rest; rest &= rest - 1) {
    const long long w = rest & -rest;
    T block;
    if (w < 32) {
      block = tree_small(v + pos, static_cast<int>(w));
    } else {
      const long long sub = w >> 5;
      const T* p = v + pos + lane * sub;
      block = sub <= 32 ? tree_small(p, static_cast<int>(sub))
                        : tree_deep(p, sub);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const T other = shfl_xor(block, o);
        block = (lane & o) ? add(block, other) : add(other, block);
      }
    }
    acc = add(block, acc);
    pos += w;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    count_runs(const int* __restrict__ row, const int* __restrict__ col,
               int P, unsigned long long* __restrict__ count) {
  __shared__ unsigned warp_sum[kWarps];
  unsigned c = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < P; i += stride) {
    c += i == 0 || row[i] != row[i - 1] || col[i] != col[i - 1];
  }
  c = __reduce_add_sync(kFull, c);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
    if (total) atomicAdd(count, total);
  }
}

// status[0] is the ticket, status[1 + t] tile t's status word, both zero at
// launch.  indptr holds rows row_lo .. row_lo + nrows (the triplets' rows
// lie in [row_lo, row_lo + nrows)), each base_out plus the runs before the
// row; col_out and val_out hold nnz slots.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    compress_runs(const int* __restrict__ row, const int* __restrict__ col,
                  const T* __restrict__ val, int P, T alpha,
                  int* __restrict__ indptr, int row_lo, int nrows,
                  int base_out, int* __restrict__ col_out,
                  T* __restrict__ val_out, int nnz,
                  unsigned long long* status) {
  __shared__ int srow[kTile + 1];  // [1 + j]: position t0 + j; [0]: t0 - 1
  __shared__ int scol[kTile + 1];
  __shared__ unsigned ballots[kBallots];
  __shared__ int before[kBallots];   // heads before each ballot's positions
  __shared__ unsigned short heads[kTile];  // the heads' offsets, in order
  __shared__ int long_runs[kLongSlots];    // runs the warps sum
  __shared__ int item, base_s, nheads_s, nlong;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) {
    item = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(status), 1u));
    nlong = 0;
  }
  __syncthreads();
  const int tile = item;
  const int t0 = tile * kTile;
  const int n_in = min(kTile, P - t0);

  for (int j = t; j < n_in; j += kThreads) {
    srow[1 + j] = row[t0 + j];
    scol[1 + j] = col[t0 + j];
  }
  if (t == 0) {
    // before position 0, a row below every row: position 0 heads a run
    srow[0] = t0 ? row[t0 - 1] : row_lo - 1;
    scol[0] = t0 ? col[t0 - 1] : 0;
  }
  __syncthreads();
  // ballot q * kWarps + w flags positions q * kThreads + 32 w + lane: the
  // ballots' order is the positions' order
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int j = q * kThreads + t;
    const bool head =
        j < n_in && (srow[1 + j] != srow[j] || scol[1 + j] != scol[j]);
    const unsigned b = __ballot_sync(kFull, head);
    if (lane == 0) ballots[q * kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int c0 = __popc(ballots[2 * lane]);
    const int c1 = __popc(ballots[2 * lane + 1]);
    int incl = c0 + c1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    before[2 * lane] = incl - c0 - c1;
    before[2 * lane + 1] = incl - c1;
    if (lane == 31) nheads_s = incl;
  }
  __syncthreads();
  const int nh = nheads_s;
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const unsigned b = ballots[q * kWarps + warp];
    if ((b >> lane) & 1) {
      heads[before[q * kWarps + warp] + __popc(b & ((1u << lane) - 1u))] =
          static_cast<unsigned short>(q * kThreads + t);
    }
  }
  if (warp == 0) {
    const int prefix = spmm::look_back(status + 1, tile, nh, lane);
    if (lane == 0) base_s = prefix;
  }
  __syncthreads();
  const int base = base_s;

  // runs whose next head is in the tile and near: one thread each
  for (int h = t; h < nh - 1; h += kThreads) {
    const int s = heads[h];
    const int len = heads[h + 1] - s;
    if (len > kShort) {
      long_runs[atomicAdd(&nlong, 1)] = h;
      continue;
    }
    const T sum = run_total(val + t0 + s, len);
    const int r = base + h;
    if (r < nnz) {
      col_out[r] = scol[1 + s];
      val_out[r] = scale(alpha, sum);
    }
    for (int q = srow[s] + 1; q <= srow[1 + s]; ++q) {
      indptr[q - row_lo] = base_out + r;
    }
  }
  if (t == 0 && nh) long_runs[atomicAdd(&nlong, 1)] = nh - 1;
  __syncthreads();

  // the long runs and the tile's last run: one warp each
  for (int k = warp; k < nlong; k += kWarps) {
    const int h = long_runs[k];
    const int s = heads[h];
    const int R = srow[1 + s];
    const int C = scol[1 + s];
    long long end;
    if (h + 1 < nh) {
      end = t0 + heads[h + 1];
    } else {
      // the first position past the tile that leaves the run (or P)
      end = -1;
      for (long long p0 = t0 + n_in; end < 0; p0 += 32) {
        const long long p = p0 + lane;
        const bool leaves = p >= P || row[p] != R || col[p] != C;
        const unsigned b = __ballot_sync(kFull, leaves);
        if (b) end = p0 + __ffs(b) - 1;
      }
    }
    const T sum = warp_run_total(val + t0 + s, end - t0 - s, lane);
    const int r = base + h;
    if (lane == 0 && r < nnz) {
      col_out[r] = C;
      val_out[r] = scale(alpha, sum);
    }
    for (int q = srow[s] + 1 + lane; q <= R; q += 32) {
      indptr[q - row_lo] = base_out + r;
    }
    if (end == P) {
      for (int q = R + 1 + lane; q <= row_lo + nrows; q += 32) {
        indptr[q - row_lo] = base_out + r + 1;
      }
    }
  }
}

}  // namespace

// Launches on `stream`: a cudaMemsetAsync of the 0-d count, then the
// kernel, which adds the number of runs of the P lex-sorted (row, col)
// pairs to it; returns the first CUDA error.  The caller guarantees
// 0 < P < 2^31.
extern "C" int spmm_esc_count(const int* row, const int* col, int P,
                              unsigned long long* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int resident[spmm::kMaxDevices];
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(*count), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = spmm::resident_blocks(count_runs, kThreads, resident,
                                           &err);
  if (!blocks) return static_cast<int>(err);
  const long long need = (static_cast<long long>(P) + kThreads - 1) /
                         kThreads;
  const unsigned grid = static_cast<unsigned>(need < blocks ? need : blocks);
  count_runs<<<grid, kThreads, 0, s>>>(row, col, P, count);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream`: a cudaMemsetAsync of the workspace `ws` ((P + 2047)
// / 2048 + 1 words of 8 bytes), then the kernel; returns the first CUDA
// error.  dtype: 0 float32, 1 float64, 2 bfloat16, 3 complex64, 4
// complex128 (val and val_out's type; alpha = alpha_re + alpha_im i,
// already rounded to it); cudaErrorInvalidValue for another.  The caller
// guarantees 0 < P < 2^31, nnz the number of runs, rows in [row_lo,
// row_lo + nrows), indptr of nrows + 1 entries, col_out and val_out of
// nnz.
extern "C" int spmm_esc_compress(const int* row, const int* col,
                                 const void* val, int P, double alpha_re,
                                 double alpha_im, int* indptr, int row_lo,
                                 int nrows, int base_out, int* col_out,
                                 void* val_out, int nnz,
                                 unsigned long long* ws, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntiles = static_cast<int>(
      (static_cast<long long>(P) + kTile - 1) / kTile);
  cudaError_t err = cudaMemsetAsync(
      ws, 0, static_cast<size_t>(ntiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float re = static_cast<float>(alpha_re);
  const float im = static_cast<float>(alpha_im);
  const auto go = [&](auto alpha) {
    using T = decltype(alpha);
    compress_runs<T><<<ntiles, kThreads, 0, s>>>(
        row, col, static_cast<const T*>(val), P, alpha, indptr, row_lo,
        nrows, base_out, col_out, static_cast<T*>(val_out), nnz, ws);
  };
  switch (dtype) {
    case 0: go(re); break;
    case 1: go(alpha_re); break;
    case 2: go(__float2bfloat16_rn(re)); break;
    case 3: go(make_float2(re, im)); break;
    default: go(make_double2(alpha_re, alpha_im)); break;
  }
  return static_cast<int>(cudaGetLastError());
}
