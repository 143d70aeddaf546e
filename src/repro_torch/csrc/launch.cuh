// Host-side launch helpers shared by bmm.cu and fused_layer.cu: each
// launcher works out its kernel's tiles and dynamic shared memory itself
// and sizes its grid to the blocks that can be resident at once.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace launch {

// Let `kernel` take `smem` dynamic shared bytes: past 48 KB of static and
// dynamic shared memory together a launch (and the occupancy query) needs
// the opt-in.
template <typename K>
cudaError_t allow_smem(K* kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// The most blocks of `kernel` (`threads` a block, `smem` dynamic shared
// bytes, opted in) resident at once on the current device: blocks per SM
// times the SMs. Cached per (device, kernel, smem), so a launch pays the
// occupancy query once.
template <typename K>
cudaError_t resident_blocks(K* kernel, int threads, int smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, (const void*)kernel, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  *blocks = cache[key] = per_sm * sms;
  return cudaSuccess;
}

// Registers a thread, static shared bytes, resident blocks per SM and the
// dynamic shared bytes `smem` of `kernel` at `threads` a block: out[0..3].
template <typename K>
cudaError_t attributes(K* kernel, int threads, int smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[3] = smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads,
                                                       smem);
}

}  // namespace launch
