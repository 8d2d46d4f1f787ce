// The grid of a persistent kernel: as many blocks as the card holds at
// once, each looping over its share of the work, so no block is launched
// for a handful of items and none waits for a free SM.

#pragma once

#include <cuda_runtime.h>

namespace spmm {

constexpr int kMaxDevices = 64;

// The blocks of `kernel`, launched with `threads` threads a block and no
// dynamic shared memory, that the current device holds at once.  Read once
// per device into `cache` (zeros at first: a static array of the caller's);
// 0 on an error, which is left in *err.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int (&cache)[kMaxDevices],
                    cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cache[dev] == 0) {
    int sms = 0;
    int per_sm = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         threads, 0);
    if (*err != cudaSuccess) return 0;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[dev];
}

}  // namespace spmm
