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

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The fp walk: raw sums of fp rows x over FRDC groups, edge by edge.
//
// Per load batch (4 groups; lane k holds slot k), lane L = t*4 + j takes, one
// group at a time, the nibble of neighbour column j of tile t: the bits of
// rows 0-3, (tile_t >> j) & 0x1111. A ballot of the nonzero nibbles gives the
// hit neighbours (about 8 of a group's 32 on Flickr). The warp compacts the
// batch's hits, in ascending group and bit order, into a list in shared
// memory (neighbour row, 4-bit row mask) and walks only that list; rows at or
// past n_x_rows are dropped there (they read as 0). The next batch's tiles
// and col_idx load while the current batch's gathers run.
//
// Lane layouts <kSub, kCols, kVec>, picked by the wrappers from the width of
// a pass (bspmm_kernel.fp_layout). A width <= 16 rounds up to kSub, a power
// of two, and the warp splits into 32 / kSub sub-warps: hit e goes to
// sub-warp e % (32 / kSub), which adds its hits in list order; fold() adds
// the sub-warps once per work item, in a fixed tree order. Wider passes keep
// the whole warp on one hit with kCols columns a lane (2 up to 64 columns, 4
// above): one float2 / float4 load where the wrapper found x's base and row
// stride aligned (kVec), else kCols coalesced scalar loads.
//
// No tensor cores: a group's (4 x 32) 0/1 mask is ~94% zeros on these
// graphs, and TF32 mma would break the fp32 tolerance (1e-5 of the sum of
// |terms|).
constexpr int kHitsPerLoad = kGroupsPerLoad * 32;

template <int kSub, int kCols, bool kVec>
struct FpLanes {
  static_assert(kSub == 32 || kCols == 1, "sub-warps take one column a lane");
  static constexpr int kSubs = 32 / kSub;
  static constexpr int kPass = kSub * kCols;           // columns of one pass
  static constexpr int kUnroll = kCols == 4 ? 4 : 8;   // hits in flight a sub-warp
  // offset in the pass of this lane's c-th column
  __device__ static __forceinline__ int col(int lane, int c) {
    if constexpr (kSub < 32) return lane % kSub;
    else if constexpr (kVec) return lane * kCols + c;
    else return c * 32 + lane;
  }
};

// The layouts the fp kernels are built for, as (kSub, kCols, kVec).
#define WALK_FP_LAYOUTS(X)                                                  \
  X(1, 1, false) X(2, 1, false) X(4, 1, false) X(8, 1, false)              \
  X(16, 1, false) X(32, 1, false) X(32, 2, false) X(32, 2, true)           \
  X(32, 4, false) X(32, 4, true)

// Calls fn(S, C, V), each an std::integral_constant, for the built layout
// (sub, cols, vec), and returns its error; cudaErrorInvalidValue for any
// other layout. The fp launchers pick their kernel instance with it.
template <class Fn>
cudaError_t with_fp_layout(int sub, int cols, int vec, Fn&& fn) {
#define WALK_CALL(S, C, V)                                                \
  if (sub == S && cols == C && vec == (V))                                \
    return fn(std::integral_constant<int, S>(),                           \
              std::integral_constant<int, C>(), std::bool_constant<V>());
  WALK_FP_LAYOUTS(WALK_CALL)
#undef WALK_CALL
  return cudaErrorInvalidValue;
}

template <bool kCoherent, int kCols, bool kVec>
__device__ __forceinline__ void gather(const float* p, const int off[kCols],
                                       const bool ok[kCols], float v[kCols]) {
  if constexpr (kVec && kCols == 2) {
    const float2 t = ok[0] ? load<kCoherent>(reinterpret_cast<const float2*>(p + off[0]))
                           : make_float2(0.f, 0.f);
    v[0] = t.x;
    v[1] = t.y;
  } else if constexpr (kVec && kCols == 4) {
    const float4 t = ok[0] ? load<kCoherent>(reinterpret_cast<const float4*>(p + off[0]))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = ok[c] ? load<kCoherent>(p + off[c]) : 0.f;
  }
}

// Adds the groups [g0, g1) of one tile-row into acc, columns [c0, c1) of
// rows x (row stride ld) in this pass; `hits` is the warp's kHitsPerLoad
// slots of shared memory.
template <int kSub, int kCols, bool kVec, bool kCoherent = false>
__device__ __forceinline__ void fp(const int32_t* __restrict__ tiles,
                                   const int32_t* __restrict__ col_idx,
                                   const float* __restrict__ x, int g0, int g1,
                                   int c0, int c1, int ld, long long n_x_rows,
                                   int lane, int2* hits,
                                   float acc[kTile][kCols]) {
  using L = FpLanes<kSub, kCols, kVec>;
  const int sub = lane / kSub;
  const unsigned below = (1u << lane) - 1u;
  int off[kCols];
  bool ok[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    off[c] = c0 + L::col(lane, c);
    ok[c] = off[c] < c1;  // a vector's columns are all in or all out
  }
  int next_tile = 0, next_col = 0;
  if (lane / kGroup < g1 - g0) {
    next_tile = tiles[(size_t)g0 * kGroup + lane];
    next_col = col_idx[(size_t)g0 * kGroup + lane];
  }
  for (int gb = g0; gb < g1; gb += kGroupsPerLoad) {
    const int n_g = min(kGroupsPerLoad, g1 - gb);
    const int my_tile = next_tile, my_col = next_col;
    const int gn = gb + kGroupsPerLoad;
    next_tile = next_col = 0;
    if (lane / kGroup < g1 - gn) {
      next_tile = tiles[(size_t)gn * kGroup + lane];
      next_col = col_idx[(size_t)gn * kGroup + lane];
    }
    int n_hits = 0;
#pragma unroll
    for (int q = 0; q < kGroupsPerLoad; ++q) {
      if (q >= n_g) break;  // uniform across the warp
      const int src = q * kGroup + (lane >> 2);
      const uint32_t tile = (uint32_t)__shfl_sync(kFull, my_tile, src);
      const int tcol = __shfl_sync(kFull, my_col, src);
      const uint32_t nib = (tile >> (lane & 3)) & 0x1111u;
      const int rows = (int)((nib | (nib >> 3) | (nib >> 6) | (nib >> 9)) & 0xFu);
      const long long row = (long long)tcol * kTile + (lane & 3);
      const bool hit = rows != 0 && row < n_x_rows;
      const unsigned b = __ballot_sync(kFull, hit);
      if (hit) hits[n_hits + __popc(b & below)] = make_int2((int)row, rows);
      n_hits += __popc(b);
    }
    __syncwarp();
    for (int e0 = 0; e0 < n_hits; e0 += L::kSubs * L::kUnroll) {
      float v[L::kUnroll][kCols];
      int rows[L::kUnroll];
#pragma unroll
      for (int u = 0; u < L::kUnroll; ++u) {
        const int e = e0 + u * L::kSubs + sub;
        rows[u] = 0;
        if (e < n_hits) {
          const int2 h = hits[e];
          rows[u] = h.y;
          gather<kCoherent, kCols, kVec>(x + (long long)h.x * ld, off, ok, v[u]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) v[u][c] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < L::kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          if ((rows[u] >> i) & 1)
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[i][c] += v[u][c];
    }
    __syncwarp();
  }
}

// Adds the sub-warps' sums into sub-warp 0 (lanes 0 .. kSub-1), in a fixed
// tree order; a no-op for a whole-warp layout.
template <int kSub, int kCols>
__device__ __forceinline__ void fold(float acc[kTile][kCols]) {
#pragma unroll
  for (int o = 16; o >= kSub; o >>= 1)
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[i][c] += __shfl_down_sync(kFull, acc[i][c], o);
}

// Stores a folded pass: row i's column col at dst[i * ld + col], col in
// [c0, c1), from the lanes that hold it.
template <int kSub, int kCols, bool kVec>
__device__ __forceinline__ void store(float* dst, size_t ld, int c0, int c1,
                                      int lane, const float acc[kTile][kCols]) {
  using L = FpLanes<kSub, kCols, kVec>;
  if (lane >= kSub) return;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = c0 + L::col(lane, c);
    if (col < c1) {
#pragma unroll
      for (int i = 0; i < kTile; ++i) dst[i * ld + col] = acc[i][c];
    }
  }
}

// After this warp stored its partial sums: true for the warp that takes the
// last of `count` tickets of `counter` (it then reads every partial).
__device__ __forceinline__ bool last_arrival(int32_t* counter, int count,
                                             int lane) {
  __threadfence();
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(counter, 1);
  ticket = __shfl_sync(kFull, ticket, 0);
  const bool last = ticket == count - 1;
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------------------
// The fp row-block kernels' CTA (bspmm.cu's 1D grid, bspmm_grid.cu's 2D grid)
//
// Heavy tile-rows (more than `heavy` groups; heavy >= kChunk) are cut into
// work items in group space: chunk k is the groups [k*kChunk, (k+1)*kChunk)
// below grp_ptr[R]. It meets at most two heavy tile-rows, the one holding
// its first group (slot 0) and one starting inside it (slot 1), so a warp
// finds its items from group_row and grp_ptr alone, with nothing built
// beforehand. Items write partial sums to scratch[chunk][slot][4][f]; the
// warp that takes a tile-row's last ticket (row_done[row * n_fb + fb]) adds
// its items in chunk order and stores the row. The chunk CTAs come first in
// the launch, so the hub rows' items start first. Row CTAs own tb_rows
// tile-rows each; their warps walk the light tile-rows whole, round-robin,
// and store them (an empty tile-row stores 0.0). Every output is a fixed sum
// in a fixed order, so two runs give the same bits.
constexpr int kChunk = 16;
constexpr int kBlockWarps = 8;

struct FpGrid {
  const int32_t* grp_ptr;
  const int32_t* group_row;
  const int32_t* tiles;
  const int32_t* col_idx;
  const float* x;
  float* out;      // (n_tile_rows * 4, f)
  float* scratch;  // (ceil(n_groups / kChunk), 2, 4, f)
  int32_t* row_done;  // (n_tile_rows, n_fb) zeros
  long long n_x_rows;
  int n_tile_rows;
  int n_chunk_blocks;  // ceil(ceil(n_groups / kChunk) / kBlockWarps)
  int tb_rows;         // tile-rows of a row CTA
  int fw;              // feature block (blockIdx.y)
  int f;
  int heavy;
};

// Registers a thread, static shared bytes and resident blocks per SM (at
// kBlockWarps warps a block) of an fp kernel: out[0..2].
template <class Kernel>
cudaError_t fp_attributes(Kernel* kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                       kBlockWarps * 32, 0);
}

template <int kSub, int kCols, bool kVec>
__device__ __forceinline__ void fp_rows(const FpGrid& a, const float* x, int g0,
                                        int g1, int f0, int f1, float* dst,
                                        int lane, int2* hits) {
  using L = FpLanes<kSub, kCols, kVec>;
  for (int c0 = f0; c0 < f1; c0 += L::kPass) {
    float acc[kTile][kCols] = {};
    fp<kSub, kCols, kVec>(a.tiles, a.col_idx, x, g0, g1, c0, f1, a.f,
                          a.n_x_rows, lane, hits, acc);
    fold<kSub, kCols>(acc);
    store<kSub, kCols, kVec>(dst, a.f, c0, f1, lane, acc);
  }
}

template <int kSub, int kCols, bool kVec>
__device__ __forceinline__ void fp_block(const FpGrid& a) {
  __shared__ int2 hits[kBlockWarps][kHitsPerLoad];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * a.fw, f1 = min(f0 + a.fw, a.f);
  const float* __restrict__ x = a.x;
  if ((int)blockIdx.x >= a.n_chunk_blocks) {
    const int tr0 = ((int)blockIdx.x - a.n_chunk_blocks) * a.tb_rows;
    const int tr1 = min(tr0 + a.tb_rows, a.n_tile_rows);
    for (int tr = tr0 + warp; tr < tr1; tr += kBlockWarps) {
      const int g0 = a.grp_ptr[tr], g1 = a.grp_ptr[tr + 1];
      if (g1 - g0 > a.heavy) continue;
      fp_rows<kSub, kCols, kVec>(a, x, g0, g1, f0, f1,
                                 a.out + (size_t)tr * kTile * a.f, lane,
                                 hits[warp]);
    }
    return;
  }
  const int k = (int)blockIdx.x * kBlockWarps + warp;
  const long long lo = (long long)k * kChunk;
  const int g_end = a.grp_ptr[a.n_tile_rows];
  if (lo >= g_end) return;
  const int hi = (int)min(lo + kChunk, (long long)g_end);
  const int first = a.group_row[lo], last = a.group_row[hi - 1];
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int r = slot ? last : first;
    if (slot && r == first) break;
    const int gr0 = a.grp_ptr[r], gr1 = a.grp_ptr[r + 1];
    if (gr1 - gr0 <= a.heavy) continue;
    fp_rows<kSub, kCols, kVec>(
        a, x, max((int)lo, gr0), min(hi, gr1), f0, f1,
        a.scratch + ((size_t)k * 2 + slot) * kTile * a.f, lane, hits[warp]);
    const int k0 = gr0 / kChunk, k1 = (gr1 - 1) / kChunk;
    if (!last_arrival(a.row_done + (size_t)r * gridDim.y + blockIdx.y,
                      k1 - k0 + 1, lane))
      continue;
    for (int col = f0 + lane; col < f1; col += 32) {
      float acc[kTile] = {0.f, 0.f, 0.f, 0.f};
      for (int kc = k0; kc <= k1; ++kc) {
        const int s = (kc == k0 && gr0 != kc * kChunk) ? 1 : 0;
        const float* p = a.scratch + ((size_t)kc * 2 + s) * kTile * a.f + col;
#pragma unroll
        for (int i = 0; i < kTile; ++i) acc[i] += __ldcg(p + (size_t)i * a.f);
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        a.out[((size_t)r * kTile + i) * a.f + col] = acc[i];
    }
  }
}

// Sign word of four row accumulators, bits past `keep` cleared.
__device__ __forceinline__ uint32_t sign_word(int v, uint32_t keep) {
  return __ballot_sync(kFull, v >= 0) & keep;
}

}  // namespace walk
