// Dense product under a structural mask -> CSR (indptr, col, vals), kept
// cells in row-major order.
//
// Replaces the Pallas kernel spmm_tpu/ops/kernels/extract_roll.py
// (`extract_roll`, kernel body `_kernel`) and with it every extraction route
// of spmm_tpu/ops/spgemm.py (`_extract_full`, `_extract_shift`,
// `_extract_sort`): all four produce this same output.  The TPU version
// resolves each output tile from a hole prefix with dynamic lane rolls,
// because a TPU cannot compact a vector.  Hopper compacts directly, in one
// pass over the flat mask:
//
//   The flat (m, n) mask is cut into tiles of kThreads * kCells cells
//   (4096, or 16384 for a mask of 2^24 cells or more), one work item each.
//   A CTA takes its work item from an integer ticket (atomicAdd), so items
//   start in order and a tile never waits on a tile that is not resident.
//   It loads its tile's mask with 16-byte loads, kCells consecutive cells
//   a thread, counts the kept cells (mask != 0), scans the counts in the
//   block with warp shuffles, and lists the offsets of its kept cells in
//   shared memory, in order.  Its exclusive prefix over the tiles before
//   it comes from a decoupled look-back: the tile publishes its count
//   (flag "aggregate"), warp 0 reads the status words of the 32 tiles
//   before it at a time and adds them up to the nearest one that holds an
//   inclusive prefix (flag "prefix"), then publishes its own inclusive
//   prefix.  Flag and count share one 64-bit word, written and read whole,
//   so no fence orders them; the counts are integers, so the result is
//   bitwise the same whatever the timing.  The tile then writes col =
//   flat % n and vals = c[flat] for each kept cell from its list
//   (consecutive threads write consecutive slots: writing each thread's
//   own cells instead took 3x as long on a dense mask), and indptr[r] for
//   each row r whose first cell r*n lies in the tile: the tile's prefix
//   plus the kept cells of the tile before r*n.  The last tile writes
//   indptr[m].  Each tile's CTA runs its phases in turn, so a large mask
//   (many tiles a CTA slot) takes 16384-cell tiles: fewer CTAs, each with
//   four 16-byte loads a thread in flight.
//
//   Slots at or past `cap` are not written by the tiles; slots in
//   [min(nnz, cap), cap) are zeroed by the work items after the last tile,
//   each over kTailSlots slots, once the last tile's inclusive prefix (nnz)
//   is published.  Their tickets come after every tile's, so the tiles
//   they wait on are resident.  Every output slot is written once, and no
//   fill runs before the kernel.
//
// The status words and the ticket are reset by a cudaMemsetAsync of a
// workspace the wrapper allocates per call, in the same C entry: one host
// call, two device operations, and no state shared across calls or
// streams.  The ticket is the only atomic; there are no float atomics.
//
// Bound: bytes.  The mask is read once (1 byte a cell), the kept values
// once (4 bytes each), and col, vals and indptr written once (8 bytes a
// kept cell, 4 a row).  The parent design read the mask twice, in a count
// pass and a per-row compaction pass around a scan of its own.
//
// The kernel is a template over the element's width, 2, 4, 8 or 16 bytes
// (bfloat16; float32; float64 and complex64; complex128): a kept value is
// moved as one item of that width and never looked at, so the output is
// bitwise c's values at every width, and consecutive threads still write
// consecutive slots (a warp's value stores are 64 to 512 contiguous
// bytes).  The float32 instance is the kernel as it was before the
// template.  Bytes a kept cell: w to read, 4 + w to write at a width of w.
//
// Offsets into c fit int32: the wrapper checks m*n < 2^31.

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using spmm::kPrefix;
using spmm::load_status;
using spmm::look_back;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTailSlots = kThreads * 64;  // output slots a tail item zeroes

// Bit b set where byte b of w is non-zero (four bytes -> four bits).
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Bit j set where mask[cell + j] is kept, for j < kCells; cells at or past
// `total` are not.
template <int kCells>
__device__ __forceinline__ unsigned long long load_bits(
    const unsigned char* __restrict__ mask, unsigned cell, unsigned total,
    bool aligned) {
  unsigned long long bits = 0;
  if (aligned && cell + kCells <= total) {
    const uint4* p = reinterpret_cast<const uint4*>(mask + cell);
#pragma unroll
    for (int q = 0; q < kCells / 16; ++q) {
      const uint4 v = __ldcs(p + q);
      const unsigned b16 = nibble(v.x) | nibble(v.y) << 4 |
                           nibble(v.z) << 8 | nibble(v.w) << 12;
      bits |= static_cast<unsigned long long>(b16) << (16 * q);
    }
    return bits;
  }
  for (unsigned j = 0; j < kCells && cell + j < total; ++j) {
    if (mask[cell + j] != 0) bits |= 1ull << j;
  }
  return bits;
}

// status[0] is the ticket; status[1 + t] tile t's status word; both zero
// at launch.  A tile is kThreads * kCells cells, kCells consecutive cells
// a thread; V is the item a value moves as.
template <int kCells, typename V>
__global__ void __launch_bounds__(kThreads)
    extract_tiles(const V* __restrict__ c,
                  const unsigned char* __restrict__ mask,
                  unsigned long long* status, int* __restrict__ indptr,
                  int* __restrict__ col, V* __restrict__ vals, int m, int n,
                  int cap, int ntiles) {
  constexpr int kTile = kThreads * kCells;
  __shared__ unsigned short kept[kTile];  // offsets of the kept cells
  __shared__ unsigned long long bits_of[kThreads];
  __shared__ int before[kThreads];        // kept cells before each thread's
  __shared__ int warp_total[kWarps];
  __shared__ int item;
  __shared__ int base_s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) item = static_cast<int>(
      atomicAdd(reinterpret_cast<unsigned*>(status), 1u));
  __syncthreads();
  const int tile = item;
  unsigned long long* tiles = status + 1;

  if (tile >= ntiles) {
    // zero the slots [max(nnz, j * kTailSlots), min(cap, (j + 1) *
    // kTailSlots)) once the last tile has published nnz
    if (t == 0) {
      unsigned long long s = load_status(tiles + ntiles - 1);
      while ((s >> 32) != 2) {
        __nanosleep(64);
        s = load_status(tiles + ntiles - 1);
      }
      base_s = static_cast<int>(static_cast<unsigned>(s));
    }
    __syncthreads();
    const long long j = tile - ntiles;
    const long long lo = max(static_cast<long long>(base_s), j * kTailSlots);
    const long long hi = min(static_cast<long long>(cap),
                             (j + 1) * kTailSlots);
    for (long long i = lo + t; i < hi; i += kThreads) {
      col[i] = 0;
      vals[i] = V();  // all bits zero
    }
    return;
  }

  // every cell offset fits int32 (m*n < 2^31), and a tile's end unsigned
  const unsigned total = static_cast<unsigned>(m) * n;
  const unsigned t0 = static_cast<unsigned>(tile) * kTile;
  const bool aligned = (reinterpret_cast<unsigned long long>(mask) & 15) == 0;
  const unsigned long long bits =
      load_bits<kCells>(mask, t0 + t * kCells, total, aligned);
  const int count = __popcll(bits);
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int excl = incl - count;
  int tile_total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = warp_total[w];
    excl += w < warp ? x : 0;
    tile_total += x;
  }
  before[t] = excl;
  bits_of[t] = bits;
  for (unsigned long long b = bits, r = excl; b != 0; b &= b - 1, ++r) {
    kept[r] = static_cast<unsigned short>(t * kCells + __ffsll(b) - 1);
  }
  if (warp == 0) {
    const int prefix = look_back(tiles, tile, tile_total, lane);
    if (lane == 0) base_s = prefix;
  }
  __syncthreads();
  const int base = base_s;

  // the kept cells in order: consecutive threads, consecutive slots
  const int last = min(tile_total, cap - base);
#pragma unroll 8
  for (int i = t; i < last; i += kThreads) {
    const int flat = static_cast<int>(t0 + kept[i]);
    col[base + i] = flat % n;
    vals[base + i] = c[flat];
  }
  // the rows r with t0 <= r*n < t1 start in this tile
  const unsigned un = n;
  const unsigned r1 = (min(t0 + kTile, total) - 1) / un + 1;
  for (unsigned r = (t0 + un - 1) / un + t; r < r1; r += kThreads) {
    const int o = static_cast<int>(r * un - t0);
    const int th = o / kCells;
    const int j = o - th * kCells;
    indptr[r] = base + before[th] + __popcll(bits_of[th] & ((1ull << j) - 1));
  }
  if (tile == ntiles - 1 && t == 0) indptr[m] = base + tile_total;
}

// The kernel at one tile size and value item, on `stream`.
template <typename V>
void launch_tiles(const void* c, const unsigned char* mask,
                  unsigned long long* ws, int* indptr, int* col, void* vals,
                  int m, int n, int cap, int tile_cells, unsigned grid,
                  int ntiles, cudaStream_t s) {
  const V* cv = static_cast<const V*>(c);
  V* vv = static_cast<V*>(vals);
  if (tile_cells == 4096) {
    extract_tiles<16, V><<<grid, kThreads, 0, s>>>(cv, mask, ws, indptr, col,
                                                   vv, m, n, cap, ntiles);
  } else {
    extract_tiles<64, V><<<grid, kThreads, 0, s>>>(cv, mask, ws, indptr, col,
                                                   vv, m, n, cap, ntiles);
  }
}

}  // namespace

// Launches on `stream`: a cudaMemsetAsync of the workspace `ws`
// ((m*n + tile_cells - 1) / tile_cells + 1 words of 8 bytes), then the
// kernel; returns the first CUDA error.  `c` and `vals` hold elements of
// `width` bytes (2, 4, 8 or 16), aligned to their width.  The caller
// guarantees m, n > 0, m*n < 2^31, 0 <= cap < 2^31, tile_cells 4096 or
// 16384 (16 or 64 cells a thread), and outputs of m + 1 and cap entries;
// none needs a fill.
extern "C" int spmm_extract_roll(const void* c, const unsigned char* mask,
                                 unsigned long long* ws, int* indptr,
                                 int* col, void* vals, int m, int n, int cap,
                                 int tile_cells, int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((tile_cells != 4096 && tile_cells != 16384) ||
      (width != 2 && width != 4 && width != 8 && width != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(m) * n;
  const long long ntiles = (total + tile_cells - 1) / tile_cells;
  const long long ntail = (static_cast<long long>(cap) + kTailSlots - 1) /
                          kTailSlots;
  cudaError_t err = cudaMemsetAsync(
      ws, 0, static_cast<size_t>(ntiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(ntiles + ntail);
  const int nt = static_cast<int>(ntiles);
  switch (width) {
    case 2:
      launch_tiles<unsigned short>(c, mask, ws, indptr, col, vals, m, n, cap,
                                   tile_cells, grid, nt, s);
      break;
    case 4:
      launch_tiles<float>(c, mask, ws, indptr, col, vals, m, n, cap,
                          tile_cells, grid, nt, s);
      break;
    case 8:
      launch_tiles<uint2>(c, mask, ws, indptr, col, vals, m, n, cap,
                          tile_cells, grid, nt, s);
      break;
    default:
      launch_tiles<uint4>(c, mask, ws, indptr, col, vals, m, n, cap,
                          tile_cells, grid, nt, s);
  }
  return static_cast<int>(cudaGetLastError());
}
