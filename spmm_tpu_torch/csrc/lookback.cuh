// The decoupled look-back of a single-pass scan over tiles (Merrill and
// Garland), shared by `extract.cu` and `esc_compress.cu`.
//
// Tiles take integer tickets in launch order, so a tile only ever waits on
// tiles that started before it.  Each publishes its count (flag
// "aggregate"); warp 0 reads the status words of the 32 tiles before it at
// a time and adds them up to the nearest one that holds an inclusive
// prefix (flag "prefix"), then publishes its own inclusive prefix.  Flag
// and count share one 64-bit word, written and read whole, so no fence
// orders them; the counts are integers, so the result is bitwise the same
// whatever the timing.  The status words start at zero (the caller's
// memset).

#pragma once

#include <cuda_runtime.h>

namespace spmm {

constexpr unsigned long long kAggregate = 1ull << 32;  // flag: count only
constexpr unsigned long long kPrefix = 2ull << 32;     // flag: inclusive

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The exclusive prefix of `tile` over the tiles before it, by warp 0 (all
// 32 lanes return it), after publishing the tile's count `mine`.
__device__ inline int look_back(unsigned long long* tiles, int tile, int mine,
                                int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  if (tile == 0) {
    if (lane == 0) store_status(tiles, kPrefix | mine);
    return 0;
  }
  if (lane == 0) store_status(tiles + tile, kAggregate | mine);
  // lane l reads tile look - l; a window in which a tile it needs has not
  // published yet is read again.  (Eight windows a round trip, all loads
  // in flight, and blocks of 512 or 1024 threads were slower on the
  // H100.)
  long long look = tile - 1;
  int prefix = 0;
  while (true) {
    const long long idx = look - lane;
    const unsigned long long s = idx >= 0 ? load_status(tiles + idx)
                                          : kPrefix;
    const unsigned flag = static_cast<unsigned>(s >> 32);
    const unsigned waiting = __ballot_sync(kFull, flag == 0);
    const unsigned prefixed = __ballot_sync(kFull, flag == 2);
    // the lanes up to and including the nearest prefix: all 32 if none
    const unsigned need =
        prefixed ? ((prefixed & (0u - prefixed)) << 1) - 1u : kFull;
    if (waiting & need) {
      __nanosleep(32);
      continue;
    }
    int v = (need >> lane) & 1 ? static_cast<int>(static_cast<unsigned>(s))
                               : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    prefix += v;
    if (prefixed) break;
    look -= 32;
  }
  if (lane == 0) {
    store_status(tiles + tile, kPrefix | static_cast<unsigned>(prefix + mine));
  }
  return prefix;
}

}  // namespace spmm
