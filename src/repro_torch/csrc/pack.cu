// BIN: binarize-and-pack, (M, F) float -> (M, ceil(F/32)) uint32 sign bits.
//
// Replaces the Pallas TPU kernel repro/kernels/pack_kernel.py:binarize_pack
// (_pack_kernel). Bit j of word w is 1 iff x[row, w*32+j] >= 0, LSB-first;
// columns past F pack as 0 (the TPU wrapper fills them with -1).
//
// Bound on H100: bytes. The kernel reads M*F input values once and writes
// M*ceil(F/32) words; there is one compare per value. Design: one warp per
// row. Lane l reads column w*32+l, so a warp reads 32 consecutive values
// (128 bytes for f32, coalesced); the loads of 4 words are started before
// their 4 __ballot_sync calls, each of which packs one word that lane 0
// stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void binarize_pack_kernel(const T* __restrict__ x,
                                     uint32_t* __restrict__ out, long long m,
                                     int f, int wf) {
  constexpr int kBatch = 4;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // the row is uniform across the warp
  const T* xr = x + row * f;
  uint32_t* orow = out + row * wf;
  for (int w0 = 0; w0 < wf; w0 += kBatch) {
    bool bit[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int col = (w0 + b) * 32 + lane;
      bit[b] = col < f && to_float(xr[col]) >= 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const uint32_t word = __ballot_sync(kFull, bit[b]);
      if (lane == 0 && w0 + b < wf) orow[w0 + b] = word;
    }
  }
}

template <typename T>
int launch(const void* x, void* out, long long m, int f, int wf,
           void* stream) {
  if (m > 0 && wf > 0) {
    const long long blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
    binarize_pack_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                              (cudaStream_t)stream>>>(
        (const T*)x, (uint32_t*)out, m, f, wf);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int binarize_pack_f32(const void* x, void* out, long long m, int f,
                                 int wf, void* stream) {
  return launch<float>(x, out, m, f, wf, stream);
}

extern "C" int binarize_pack_bf16(const void* x, void* out, long long m, int f,
                                  int wf, void* stream) {
  return launch<__nv_bfloat16>(x, out, m, f, wf, stream);
}
