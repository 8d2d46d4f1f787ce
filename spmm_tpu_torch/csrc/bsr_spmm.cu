// C = A_bsr @ B: block-sparse (BSR) times dense, float32, on the tensor
// cores in 3xTF32 (bfloat16, float64 and int32 on the FMA units: see
// bsr_spmm_fma below).
//
// Replaces the Pallas kernel `bsr_spmm_pallas` of
// spmm_tpu/ops/kernels/bsr_spmm.py (kernel body `_kernel`).  The TPU kernel
// runs a sequential grid (block row, N tile, step s), carries the (R, TN)
// sum in its output block across the steps, and computes each block's
// product with `jnp.dot(..., precision=HIGHEST)`: float32 accuracy built
// from several bf16 passes through the MXU.  Here one CTA owns one (block
// row, tile of B's columns, chunk of the block's rows) and walks the block
// row's blocks in stored order itself, keeping the sum in registers, so
// nothing carries between CTAs: no zero-fill pass, no split-K, no atomics,
// one store per output element, bitwise on rerun.
//
// Arithmetic (3xTF32, the Hopper form of HIGHEST): each operand x is split
// into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: round to nearest, ties
// away, to 10 mantissa bits), and each product is a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi, small terms first, on the tensor cores (mma.sync m16n8k8
// tf32).  The tensor core rounds its fp32 accumulate toward zero, a bias
// that grows with the number of accumulates into one register.  So each
// step of 8 along K runs its three products into a fresh accumulator, and
// the running sum takes that partial with one IEEE fp32 add: the biased
// roundings stay the size of an 8-term partial, the long sum rounds to
// nearest.  The order is fixed: blocks in stored order, K in order.
//
// Layout: the product is computed transposed, C^T = B^T A^T, so that the
// mma's M is 16 columns of B, its N 8 rows of the block and its K the
// block's columns.  A block row of R = 8 (the (8, 128) re-tiling of a CSR)
// then fills the N = 8 of one mma with no padded rows.  A warp holds a
// 16*MT x 8*NT tile of C^T; 8 warps hold the CTA's kTN x kTR tile.  Per
// stage a (kTR, kKC) slice of the A block and the (kKC, kTN) slab of B it
// meets come into shared memory by cp.async in a ring of kStages stages, so
// the next slices land while the current one computes; each fragment is
// loaded from shared memory and split into hi/lo in registers (row strides
// padded to 4 and 8 words mod 32: every fragment load is free of bank
// conflicts).  The epilogue writes the tile through shared memory and out
// with 16-byte stores.
//
// Ragged shapes are staged with zero padding (the TPU wrapper pads K to C
// and N to the tile, then cuts back): rows of the block past R, block
// columns past C, B rows past K and columns past N land as zeros, whose
// products add nothing; output rows past m and columns past N are not
// written.  A block row with no blocks writes zeros.  Blocks taller than
// kTR take several CTAs along z.  One route takes every shape: where C and
// N are multiples of 4 (and the pointers 16-byte aligned) the staging and
// the stores move 16 bytes a thread, else 4.
//
// Bound on this card: the larger of the bytes, 4 * (nblocks*R*C + K*N +
// m*N) plus the indices, over 3.35 TB/s, and the 3 * 2 * nblocks*R*C*N TF32
// operations over 494.7 TFLOP/s.  B's slab is read again for every block
// that meets it (from L2 where it fits), which bounds the (8, 128) cell:
// 16 KB of A and 128 KB of B a block for 0.5 MFLOP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kKC = 32;        // K per stage
constexpr int kStages = 3;

// The CTA's tile: WM x WN warps, each 16*MT columns of B by 8*NT rows.
template <int WM, int WN, int MT, int NT>
struct Tile {
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  static constexpr int kTN = WM * MT * 16;  // columns of B
  static constexpr int kTR = WN * NT * 8;   // rows of the block
  static constexpr int kSA = kKC + 4;       // A slice row stride, words
  static constexpr int kSX = kTN + 8;       // B slab row stride, words
  static constexpr int kSO = kTN + 4;       // output tile row stride, words
  static constexpr int kStage = kTR * kSA + kKC * kSX;
  static constexpr int kWords =
      kStages * kStage > kTR * kSO ? kStages * kStage : kTR * kSO;
  static constexpr int kSmemBytes = kWords * 4;
};

// 16 or 4 bytes global -> shared, zeros where `full` is false.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo + O(2^-22 |x|), hi and lo tf32 values.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  hi &= 0xFFFFE000u;  // the tf32 value as an fp32, for the exact residual
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d = a @ b (16x8x8, tf32 in, fp32 out) from a zero accumulator
__device__ __forceinline__ void mma_first(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// d += a @ b
__device__ __forceinline__ void mma_add(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
    bsr_spmm_tc(const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const float* __restrict__ blocks, const float* __restrict__ b,
                float* __restrict__ out, int R, int C, long long m,
                long long K, int N, bool vec) {
  using T = Tile<WM, WN, MT, NT>;
  extern __shared__ __align__(16) float smem[];
  const int r = blockIdx.x;              // block row
  const int n0 = blockIdx.y * T::kTN;    // first column of B
  const int i0 = blockIdx.z * T::kTR;    // first row of the block
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int g = (t & 31) >> 2;  // the mma fragments' group and thread ids
  const int q = t & 3;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int p0 = indptr[r];
  const int nkc = (C + kKC - 1) / kKC;
  const int stages = (indptr[r + 1] - p0) * nkc;

  // stage s: block p0 + s / nkc, its columns [kc, kc + kKC)
  auto load = [&](int s) {
    float* as = smem + (s % kStages) * T::kStage;
    float* xs = as + T::kTR * T::kSA;
    const int p = p0 + s / nkc;
    const int kc = (s % nkc) * kKC;
    const long long kb = static_cast<long long>(indices[p]) * C + kc;
    const float* a = blocks + (static_cast<long long>(p) * R + i0) * C + kc;
    if (vec) {
      for (int v = t; v < T::kTR * (kKC / 4); v += kThreads) {
        const int i = v / (kKC / 4);
        const int c = v % (kKC / 4) * 4;
        const bool ok = i0 + i < R && kc + c < C;
        cp_async16(as + i * T::kSA + c,
                   ok ? a + static_cast<long long>(i) * C + c : blocks, ok);
      }
      for (int v = t; v < kKC * (T::kTN / 4); v += kThreads) {
        const int kk = v / (T::kTN / 4);
        const int c = v % (T::kTN / 4) * 4;
        const bool ok = kc + kk < C && kb + kk < K && n0 + c < N;
        cp_async16(xs + kk * T::kSX + c, ok ? b + (kb + kk) * N + n0 + c : b,
                   ok);
      }
    } else {
      for (int v = t; v < T::kTR * kKC; v += kThreads) {
        const int i = v / kKC;
        const int c = v % kKC;
        const bool ok = i0 + i < R && kc + c < C;
        cp_async4(as + i * T::kSA + c,
                  ok ? a + static_cast<long long>(i) * C + c : blocks, ok);
      }
      for (int v = t; v < kKC * T::kTN; v += kThreads) {
        const int kk = v / T::kTN;
        const int c = v % T::kTN;
        const bool ok = kc + kk < C && kb + kk < K && n0 + c < N;
        cp_async4(xs + kk * T::kSX + c, ok ? b + (kb + kk) * N + n0 + c : b,
                  ok);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed
    __syncthreads();               // ... for every thread; s - 1 is done
    if (s + kStages - 1 < stages) load(s + kStages - 1);
    cp_async_commit();
    const float* as = smem + (s % kStages) * T::kStage;
    const float* xs = as + T::kTR * T::kSA;
    // one step of 8 along K
    auto step = [&](int k8) {
      // A^T fragments (k, n = row of the block): b0 (q, g), b1 (q + 4, g)
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* ap = as + (wn * NT * 8 + j * 8 + g) * T::kSA + k8 + q;
        split(ap[0], bh[j][0], bl[j][0]);
        split(ap[4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // B^T fragments (m = column of B, k): (g, q), (g + 8, q),
        // (g, q + 4), (g + 8, q + 4)
        const float* xp = xs + (k8 + q) * T::kSX + wm * MT * 16 + i * 16 + g;
        uint32_t ah[4], al[4];
        split(xp[0], ah[0], al[0]);
        split(xp[8], ah[1], al[1]);
        split(xp[4 * T::kSX], ah[2], al[2]);
        split(xp[4 * T::kSX + 8], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float d[4];
          mma_first(d, al, bh[j][0], bh[j][1]);
          mma_add(d, ah, bl[j][0], bl[j][1]);
          mma_add(d, ah, bh[j][0], bh[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
        }
      }
    };
    // Unrolled, the taller tiles hoist every step's fragments (255
    // registers and spills at 128 rows): they take one step at a time and
    // stay within 128 registers, two CTAs an SM.  The 8-row tile fits
    // unrolled.
    if constexpr (NT == 1) {
#pragma unroll
      for (int k8 = 0; k8 < kKC; k8 += 8) step(k8);
    } else {
#pragma unroll 1
      for (int k8 = 0; k8 < kKC; k8 += 8) step(k8);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the output tile

  // accumulator (m, n): e = 0 (g, 2q), 1 (g, 2q + 1), 2 (g + 8, 2q),
  // 3 (g + 8, 2q + 1); the tile holds row n of the block, column m of B
  float* os = smem;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = wm * MT * 16 + i * 16 + g;
      const int row = wn * NT * 8 + j * 8 + 2 * q;
      os[row * T::kSO + col] = acc[i][j][0];
      os[(row + 1) * T::kSO + col] = acc[i][j][1];
      os[row * T::kSO + col + 8] = acc[i][j][2];
      os[(row + 1) * T::kSO + col + 8] = acc[i][j][3];
    }
  }
  __syncthreads();
  const int width = vec ? 4 : 1;
  const int per_row = T::kTN / width;
  for (int v = t; v < T::kTR * per_row; v += kThreads) {
    const int i = v / per_row;
    const int c = v % per_row * width;
    const long long row = static_cast<long long>(r) * R + i0 + i;
    if (i0 + i >= R || row >= m || n0 + c >= N) continue;
    float* dst = out + row * N + n0 + c;
    const float* src = os + i * T::kSO + c;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      *dst = *src;
    }
  }
}

template <int WM, int WN, int MT, int NT>
int launch(const int* indptr, const int* indices, const float* blocks,
           const float* b, float* out, int mb, int R, int C, long long m,
           long long K, int N, bool vec, cudaStream_t stream) {
  using T = Tile<WM, WN, MT, NT>;
  auto kernel = bsr_spmm_tc<WM, WN, MT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(mb, (N + T::kTN - 1) / T::kTN, (R + T::kTR - 1) / T::kTR);
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(
      indptr, indices, blocks, b, out, R, C, m, K, N, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The other dtypes of the TPU kernel (bfloat16; float64 and int32, which
// the JAX kernel computes off the TPU) on the FMA units: one thread a (row
// of the block, column of B), the row's blocks in stored order.  Each
// block's product is summed in the accumulate type (float for bfloat16, the
// type itself otherwise), rounded to the stored type, and added to the
// running sum in that type, as the TPU kernel's `out_ref += jnp.dot(...,
// preferred_element_type=out_ref.dtype)` rounds it: a bfloat16 sum rounds
// after every block; int32 wraps.  Neighbouring threads take neighbouring
// columns, so B's rows load coalesced and the block's row is one broadcast
// a step.  Columns of the block past K add nothing (the plain version's
// zero padding).

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ int widen(int v) { return v; }

// acc + a * b
__device__ __forceinline__ float mad(float acc, float a, float b) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ double mad(double acc, double a, double b) {
  return fma(a, b, acc);
}
__device__ __forceinline__ int mad(int acc, int a, int b) {
  return static_cast<int>(static_cast<unsigned>(acc) +
                          static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

template <typename T, typename A>
__device__ __forceinline__ T narrow(A v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}

// s + p in the stored type
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 s,
                                             __nv_bfloat16 p) {
  return __float2bfloat16_rn(__bfloat162float(s) + __bfloat162float(p));
}
__device__ __forceinline__ double add(double s, double p) { return s + p; }
__device__ __forceinline__ int add(int s, int p) {
  return static_cast<int>(static_cast<unsigned>(s) + static_cast<unsigned>(p));
}

template <typename T>
__device__ __forceinline__ T zero() {
  return T{};
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

constexpr int kWideThreads = 128;

template <typename T, typename A>
__global__ void __launch_bounds__(kWideThreads)
    bsr_spmm_fma(const int* __restrict__ indptr,
                 const int* __restrict__ indices,
                 const T* __restrict__ blocks, const T* __restrict__ b,
                 T* __restrict__ out, int R, int C, long long m, long long K,
                 int N) {
  const int r = blockIdx.x;  // block row
  const int n = blockIdx.y * kWideThreads + threadIdx.x;
  if (n >= N) return;
  // rows of the block, gridDim.z apart
  for (int i = blockIdx.z; i < R; i += gridDim.z) {
    const long long row = static_cast<long long>(r) * R + i;
    if (row >= m) return;
    T sum = zero<T>();
    for (int p = indptr[r]; p < indptr[r + 1]; ++p) {
      const T* a = blocks + (static_cast<long long>(p) * R + i) * C;
      const long long k0 = static_cast<long long>(indices[p]) * C;
      const int cols = static_cast<int>(K - k0 < C ? K - k0 : C);
      const T* x = b + k0 * N + n;
      A part = widen(zero<T>());
      for (int c = 0; c < cols; ++c) {
        part = mad(part, widen(a[c]),
                   widen(x[static_cast<long long>(c) * N]));
      }
      sum = add(sum, narrow<T>(part));
    }
    out[row * N + n] = sum;
  }
}

template <typename T, typename A>
int launch_fma(const int* indptr, const int* indices, const void* blocks,
               const void* b, void* out, int mb, int R, int C, long long m,
               long long K, int N, cudaStream_t stream) {
  const dim3 grid(mb, (N + kWideThreads - 1) / kWideThreads,
                  R < 65535 ? R : 65535);
  bsr_spmm_fma<T, A><<<grid, kWideThreads, 0, stream>>>(
      indptr, indices, static_cast<const T*>(blocks),
      static_cast<const T*>(b), static_cast<T*>(out), R, C, m, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (m, N) = A @ b with A given as BSR (indptr over mb block rows, block
// column ids, blocks (nblocks, R, C)) and b (K, N), all row-major on the
// device.  Launches on `stream`; returns cudaGetLastError() of the launch.
// The caller guarantees mb, N > 0 and m <= mb * R.  The tile follows R
// alone: the fewest block rows of 8 that cover it, up to 128 (taller blocks
// take several CTAs along z).  Blocks of up to 32 rows take 256 columns of
// B a CTA, up to 64 rows 128, taller ones 64: the 32 block rows of a
// 4096-row matrix of 128-row blocks then still make 128 CTAs.
extern "C" int spmm_bsr_spmm(const int* indptr, const int* indices,
                             const float* blocks, const float* b, float* out,
                             int mb, int R, int C, long long m, long long K,
                             int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && N % 4 == 0 && aligned16(blocks) &&
                   aligned16(b) && aligned16(out);
  if (R <= 8) {
    return launch<8, 1, 2, 1>(indptr, indices, blocks, b, out, mb, R, C, m,
                              K, N, vec, s);
  }
  if (R <= 32) {
    return launch<8, 1, 2, 4>(indptr, indices, blocks, b, out, mb, R, C, m,
                              K, N, vec, s);
  }
  if (R <= 64) {
    return launch<4, 2, 2, 4>(indptr, indices, blocks, b, out, mb, R, C, m,
                              K, N, vec, s);
  }
  return launch<2, 4, 2, 4>(indptr, indices, blocks, b, out, mb, R, C, m, K,
                            N, vec, s);
}

// The same product for the other dtypes, on the FMA units (bsr_spmm_fma
// above).  dtype: 0 bfloat16, 1 float64, 2 int32.  Same arguments and
// guarantees as spmm_bsr_spmm; cudaErrorInvalidValue for an unknown dtype.
extern "C" int spmm_bsr_spmm_wide(const int* indptr, const int* indices,
                                  const void* blocks, const void* b,
                                  void* out, int mb, int R, int C,
                                  long long m, long long K, int N, int dtype,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fma<__nv_bfloat16, float>(indptr, indices, blocks, b,
                                              out, mb, R, C, m, K, N, s);
    case 1:
      return launch_fma<double, double>(indptr, indices, blocks, b, out, mb,
                                        R, C, m, K, N, s);
    case 2:
      return launch_fma<int, int>(indptr, indices, blocks, b, out, mb, R, C,
                                  m, K, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
