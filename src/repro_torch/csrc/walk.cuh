// FRDC group walks shared by the BSpMM kernels: the 1D kernels (bspmm.cu),
// the 2D block grid (bspmm_grid.cu) and the fused per-layer kernel
// (fused_layer.cu).
//
// A walk adds the groups [g0, g1) of one tile-row into the four row
// accumulators a warp holds, in group order: one load brings the tiles and
// tile-column ids of 4 groups (lane k holds slot k); neighbour rows at or
// past n_x_rows read as 0.
// kCoherent loads the gathered rows past L1 (ld.global.cg): the fused kernel
// reads rows that other blocks wrote earlier in the same launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 4;
constexpr int kGroup = 8;
constexpr int kGroupsPerLoad = 32 / kGroup;

template <bool kCoherent, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kCoherent) return __ldcg(p);
  return *p;
}

__device__ __forceinline__ uint32_t adjacency_word(uint32_t tile, int lane,
                                                   int slot_group, int i) {
  // lanes of `slot_group` hold its 8 tiles; row i's 4 bits of tile t go to
  // bits t*4 .. t*4+3 of the word (Step 3)
  const uint32_t part = (lane / kGroup == slot_group)
                            ? ((tile >> (i * kTile)) & 0xFu)
                                  << ((lane % kGroup) * kTile)
                            : 0u;
  return __reduce_or_sync(kFull, part);
}

// Trinary popc counts of word w of packed +-1 rows x (row stride wf): lane f
// adds feature w*32+f of the four rows (Steps 2-5; s3 = 2 popc(a&b) -
// popc(a), s2 = popc(a&b) - popc(a&~b)).
template <bool kCoherent = false>
__device__ __forceinline__ void bits(const int32_t* __restrict__ tiles,
                                     const int32_t* __restrict__ col_idx,
                                     const uint32_t* __restrict__ x, int g0,
                                     int g1, int w, int wf, long long n_x_rows,
                                     int s2, int lane, int acc[kTile]) {
  for (int gb = g0; gb < g1; gb += kGroupsPerLoad) {
    const int n_g = min(kGroupsPerLoad, g1 - gb);
    const bool in = lane / kGroup < n_g;
    const size_t idx = (size_t)gb * kGroup + lane;
    const uint32_t my_tile = in ? (uint32_t)tiles[idx] : 0u;
    const int my_col = in ? col_idx[idx] : 0;
    uint32_t xk[kGroupsPerLoad];
#pragma unroll
    for (int q = 0; q < kGroupsPerLoad; ++q) {
      const int col = __shfl_sync(kFull, my_col, q * kGroup + (lane >> 2));
      const long long row = (long long)col * kTile + (lane & 3);
      xk[q] = (q < n_g && row < n_x_rows) ? load<kCoherent>(x + row * wf + w)
                                          : 0u;
    }
#pragma unroll
    for (int q = 0; q < kGroupsPerLoad; ++q) {
      if (q >= n_g) break;  // uniform across the warp
      uint32_t a[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) a[i] = adjacency_word(my_tile, lane, q, i);
      uint32_t bt = 0u;
#pragma unroll
      for (int f = 0; f < 32; ++f) {
        const uint32_t b = __ballot_sync(kFull, (xk[q] >> f) & 1u);
        if (lane == f) bt = b;
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        if (s2)
          acc[i] += __popc(a[i] & bt) - __popc(a[i] & ~bt);
        else
          acc[i] += 2 * __popc(a[i] & bt) - __popc(a[i]);
      }
    }
  }
}

// Raw fp sums of column `col` (valid iff ok) of rows x (row stride f): per
// group, the warp starts the gathers of every set adjacency column before
// adding them to the rows of the tile that have the bit.
template <bool kCoherent = false>
__device__ __forceinline__ void fp(const int32_t* __restrict__ tiles,
                                   const int32_t* __restrict__ col_idx,
                                   const float* __restrict__ x, int g0, int g1,
                                   int col, bool ok, int f, long long n_x_rows,
                                   int lane, float acc[kTile]) {
  for (int gb = g0; gb < g1; gb += kGroupsPerLoad) {
    const int n_g = min(kGroupsPerLoad, g1 - gb);
    const bool in = lane / kGroup < n_g;
    const size_t idx = (size_t)gb * kGroup + lane;
    const int my_tile = in ? tiles[idx] : 0;
    const int my_col = in ? col_idx[idx] : 0;
    for (int q = 0; q < n_g; ++q) {
      uint32_t tile[kGroup];
      float v[kGroup * kTile];
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        tile[t] = (uint32_t)__shfl_sync(kFull, my_tile, q * kGroup + t);
        const int tcol = __shfl_sync(kFull, my_col, q * kGroup + t);
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          const long long row = (long long)tcol * kTile + j;
          const bool hit = ((tile[t] >> j) & 0x1111u) != 0u;
          v[t * kTile + j] =
              (hit && ok && row < n_x_rows) ? load<kCoherent>(x + row * f + col)
                                            : 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < kGroup; ++t)
#pragma unroll
        for (int j = 0; j < kTile; ++j)
#pragma unroll
          for (int i = 0; i < kTile; ++i)
            if ((tile[t] >> (i * kTile + j)) & 1u) acc[i] += v[t * kTile + j];
    }
  }
}

// Sign word of four row accumulators, bits past `keep` cleared.
__device__ __forceinline__ uint32_t sign_word(int v, uint32_t keep) {
  return __ballot_sync(kFull, v >= 0) & keep;
}

}  // namespace walk
