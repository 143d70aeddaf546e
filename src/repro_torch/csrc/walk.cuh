// FRDC group walks shared by the BSpMM kernels: the 1D kernels (bspmm.cu),
// the 2D block grid (bspmm_grid.cu), the fused per-layer kernel
// (fused_layer.cu) and the sharded pair step (fused_pair.cu), and the work
// split of the 1D and grid kernels.
//
// A walk adds the groups [g0, g1) of one tile-row into the four row
// accumulators a warp holds, in group order: one load brings the tiles and
// tile-column ids of 4 groups (lane k holds slot k), and the next batch's
// load is issued before this one's gathers; neighbour rows at or past
// n_x_rows read as 0.
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

// ---------------------------------------------------------------------------
// The bits walk: trinary popc counts of packed +-1 rows x (Steps 2-5).
//
// A pass covers nw <= kW words (kW in {1, 2, 4}) of every gathered row, so a
// group's tiles and col_idx are loaded, and its four adjacency words built
// (Step 3: a __reduce_or_sync each), once for up to 4 words. Per load batch
// lane k gathers, for each group, words [w, w + nw) of neighbour row
// col_idx[g, k / 4] * 4 + k % 4 (Step 2): one 8- or 16-byte load where the
// caller found x's base and row stride aligned (`vec`), else nw 4-byte loads.
// Each word's 32 x 32 bit block (row k = neighbour k) is then transposed in
// registers by transpose32, so lane f holds bit k = neighbour k's bit of
// feature w*32 + f (Step 4, LSB-first as bitops.bit_transpose_32 gives it),
// and lane f adds the trinary popc of the four rows (Step 5): s3 = 2 popc(a
// & b) - popc(a), s2 = popc(a & b) - popc(a & ~b). A group and word cost
// about 20 instructions of transpose and 12-20 of popc whatever the group's
// density: at the 7-9 edges a group of Flickr and Reddit that beats adding
// each hit neighbour's +-1 (tools/bits_variants.py, "edges").

// The 32 x 32 bit block whose row k is lane k's x, transposed: lane f gets
// bit k = bit f of lane k's x (Hacker's Delight 7-3, across lanes). Round j
// swaps the off-diagonal j x j blocks: a lane with bit j clear keeps its
// columns with bit j clear and takes those of its partner (lane ^ j), moved
// up by j; the partner keeps its columns with bit j set and takes this
// lane's, moved down by j. Each move is a rotation that wraps no bit.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const uint32_t low_cols = 0xffffffffu / ((1u << j) + 1u);  // bit j clear
    const bool low = (lane & j) == 0;
    const uint32_t keep = low ? low_cols : ~low_cols;
    const uint32_t give = x & ~keep;
    const uint32_t sent = __funnelshift_l(give, give, low ? 32 - j : j);
    x = (x & keep) | __shfl_xor_sync(kFull, sent, j);
  }
  return x;
}

// One group's counts: slot group q of the batch (its tiles in my_tile),
// gathered words xk. tools/bits_variants.py swaps this function for the
// edge-driven candidate.
template <int kW, bool kS2>
__device__ __forceinline__ void bits_group(uint32_t my_tile, int q,
                                           const uint32_t xk[kW], int nw,
                                           int lane, int acc[kTile][kW]) {
  uint32_t a[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) a[i] = adjacency_word(my_tile, lane, q, i);
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (j >= nw) break;  // uniform across the warp
    const uint32_t bt = transpose32(xk[j], lane);
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if constexpr (kS2)
        acc[i][j] += __popc(a[i] & bt) - __popc(a[i] & ~bt);
      else
        acc[i][j] += 2 * __popc(a[i] & bt) - __popc(a[i]);
    }
  }
}
// end bits_group

template <bool kCoherent, int kW>
__device__ __forceinline__ void gather_words(const uint32_t* p, int nw,
                                             bool vec, uint32_t v[kW]) {
  if constexpr (kW == 2) {
    if (vec) {
      const uint2 t = load<kCoherent>(reinterpret_cast<const uint2*>(p));
      v[0] = t.x;
      v[1] = t.y;
      return;
    }
  } else if constexpr (kW == 4) {
    if (vec) {
      const uint4 t = load<kCoherent>(reinterpret_cast<const uint4*>(p));
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kW; ++j) v[j] = j < nw ? load<kCoherent>(p + j) : 0u;
}

// Adds the groups [g0, g1) of one tile-row into acc: words [w, w + nw) of
// rows x (row stride wf words), nw <= kW; lane f's acc[i][j] is row i's
// count of feature (w + j) * 32 + f. `vec`: one kW-word load a row (nw ==
// kW, and x + w and wf aligned to it).
template <int kW, bool kS2, bool kCoherent = false>
__device__ __forceinline__ void bits(const int32_t* __restrict__ tiles,
                                     const int32_t* __restrict__ col_idx,
                                     const uint32_t* __restrict__ x, int g0,
                                     int g1, int w, int nw, int wf, bool vec,
                                     long long n_x_rows, int lane,
                                     int acc[kTile][kW]) {
  int next_tile = 0, next_col = 0;
  if (lane / kGroup < g1 - g0) {
    next_tile = tiles[(size_t)g0 * kGroup + lane];
    next_col = col_idx[(size_t)g0 * kGroup + lane];
  }
  for (int gb = g0; gb < g1; gb += kGroupsPerLoad) {
    const int n_g = min(kGroupsPerLoad, g1 - gb);
    const uint32_t my_tile = (uint32_t)next_tile;
    const int my_col = next_col;
    const int gn = gb + kGroupsPerLoad;
    next_tile = next_col = 0;
    if (lane / kGroup < g1 - gn) {
      next_tile = tiles[(size_t)gn * kGroup + lane];
      next_col = col_idx[(size_t)gn * kGroup + lane];
    }
    uint32_t xk[kGroupsPerLoad][kW];
#pragma unroll
    for (int q = 0; q < kGroupsPerLoad; ++q) {
      const int col = __shfl_sync(kFull, my_col, q * kGroup + (lane >> 2));
      const long long row = (long long)col * kTile + (lane & 3);
      if (q < n_g && row < n_x_rows) {
        gather_words<kCoherent, kW>(x + row * wf + w, nw, vec, xk[q]);
      } else {
#pragma unroll
        for (int j = 0; j < kW; ++j) xk[q][j] = 0u;
      }
    }
#pragma unroll
    for (int q = 0; q < kGroupsPerLoad; ++q) {
      if (q >= n_g) break;  // uniform across the warp
      bits_group<kW, kS2>(my_tile, q, xk[q], nw, lane, acc);
    }
  }
}

// Blocks a SM that the bits kernels of kW-word passes ask the compiler to
// fit (__launch_bounds__): 64 registers a thread at up to 2 words, where 4
// blocks beat 3 by 14% on Flickr at F = 64 (tools/bits_variants.py); 4-word
// passes keep their ~100 registers.
__host__ __device__ constexpr int bits_min_blocks(int kw) {
  return kw <= 2 ? 4 : 2;
}

// Words a bits pass takes for feature blocks of `words` words.
__host__ __device__ constexpr int bits_pass(int words) {
  return words <= 1 ? 1 : words <= 2 ? 2 : 4;
}

// Calls fn(W, S2), std::integral_constants, for the built pass width
// bits_pass(words) and trinary formula; the bits launchers pick their
// kernel instance with it.
template <class Fn>
cudaError_t with_bits_pass(int words, int s2, Fn&& fn) {
  using S3 = std::false_type;
  using S2 = std::true_type;
  switch (bits_pass(words)) {
    case 1:
      return s2 ? fn(std::integral_constant<int, 1>(), S2())
                : fn(std::integral_constant<int, 1>(), S3());
    case 2:
      return s2 ? fn(std::integral_constant<int, 2>(), S2())
                : fn(std::integral_constant<int, 2>(), S3());
    default:
      return s2 ? fn(std::integral_constant<int, 4>(), S2())
                : fn(std::integral_constant<int, 4>(), S3());
  }
}

// Sign word of four row accumulators, bits past `keep` cleared.
__device__ __forceinline__ uint32_t sign_word(int v, uint32_t keep) {
  return __ballot_sync(kFull, v >= 0) & keep;
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
// slots of shared memory. kScaled multiplies each gathered row by its
// column scale (col_scale[row], 1 where col_scale is null) before the add,
// one rounded product (__fmul_rn, never contracted into the add); the
// scale is loaded beside the row, so it costs no round trip of its own.
template <int kSub, int kCols, bool kVec, bool kCoherent = false,
          bool kScaled = false>
__device__ __forceinline__ void fp(const int32_t* __restrict__ tiles,
                                   const int32_t* __restrict__ col_idx,
                                   const float* __restrict__ x, int g0, int g1,
                                   int c0, int c1, int ld, long long n_x_rows,
                                   int lane, int2* hits,
                                   float acc[kTile][kCols],
                                   const float* __restrict__ col_scale = nullptr) {
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
      float scale[L::kUnroll];
      int rows[L::kUnroll];
#pragma unroll
      for (int u = 0; u < L::kUnroll; ++u) {
        const int e = e0 + u * L::kSubs + sub;
        rows[u] = 0;
        scale[u] = 1.f;
        if (e < n_hits) {
          const int2 h = hits[e];
          rows[u] = h.y;
          gather<kCoherent, kCols, kVec>(x + (long long)h.x * ld, off, ok, v[u]);
          if constexpr (kScaled)
            if (col_scale) scale[u] = load<kCoherent>(col_scale + h.x);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) v[u][c] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < L::kUnroll; ++u) {
        if constexpr (kScaled)
#pragma unroll
          for (int c = 0; c < kCols; ++c) v[u][c] = __fmul_rn(v[u][c], scale[u]);
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          if ((rows[u] >> i) & 1)
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[i][c] += v[u][c];
      }
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
// The row-block kernels' CTA: the work split of bspmm.cu's 1D grids and
// bspmm_grid.cu's 2D grids, bits and fp alike.
//
// Heavy tile-rows (more than `heavy` groups; heavy >= kChunk) are cut into
// work items in group space: chunk k is the groups [k*kChunk, (k+1)*kChunk)
// below grp_ptr[R]. It meets at most two heavy tile-rows, the one holding
// its first group (slot 0) and one starting inside it (slot 1), so a warp
// finds its items from group_row and grp_ptr alone, with nothing built
// beforehand. Items write partial sums to scratch item chunk * 2 + slot; the
// warp that takes a tile-row's last ticket (row_done[row * n_fb + fb]) adds
// its items in chunk order and stores the row. The chunk CTAs come first in
// the launch, so the hub rows' items start first. Row CTAs own tb_rows
// tile-rows each; their warps walk the light tile-rows whole, round-robin,
// and store them (an empty tile-row stores 0). Every output is a fixed sum
// in a fixed order, so two runs give the same bits.
constexpr int kChunk = 16;
constexpr int kBlockWarps = 8;

struct Split {
  const int32_t* grp_ptr;
  const int32_t* group_row;
  int32_t* row_done;   // (n_tile_rows, n_fb) zeros
  int n_tile_rows;
  int n_chunk_blocks;  // chunk_blocks(n_groups)
  int tb_rows;         // tile-rows of a row CTA
  int heavy;
};

// CTAs of chunk items for n_groups groups (a warp a chunk).
inline int chunk_blocks(long long n_groups) {
  const long long chunks = (n_groups + kChunk - 1) / kChunk;
  return (int)((chunks + kBlockWarps - 1) / kBlockWarps);
}

// This CTA's share of the split, for an op with
//   row(tr, g0, g1):      walk light tile-row tr whole and store it;
//   part(item, g0, g1):   walk groups of a heavy row, store scratch item;
//   combine(r, k0, k1, s0): add heavy row r's items k0 * 2 + s0, (k0 + 1) *
//                         2, ..., k1 * 2 in that order and store the row.
template <class Op>
__device__ __forceinline__ void split_block(const Split& s, Op& op, int lane,
                                            int warp) {
  if ((int)blockIdx.x >= s.n_chunk_blocks) {
    const int tr0 = ((int)blockIdx.x - s.n_chunk_blocks) * s.tb_rows;
    const int tr1 = min(tr0 + s.tb_rows, s.n_tile_rows);
    for (int tr = tr0 + warp; tr < tr1; tr += kBlockWarps) {
      const int g0 = s.grp_ptr[tr], g1 = s.grp_ptr[tr + 1];
      if (g1 - g0 <= s.heavy) op.row(tr, g0, g1);
    }
    return;
  }
  const int k = (int)blockIdx.x * kBlockWarps + warp;
  const long long lo = (long long)k * kChunk;
  const int g_end = s.grp_ptr[s.n_tile_rows];
  if (lo >= g_end) return;
  const int hi = (int)min(lo + kChunk, (long long)g_end);
  const int first = s.group_row[lo], last = s.group_row[hi - 1];
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int r = slot ? last : first;
    if (slot && r == first) break;
    const int gr0 = s.grp_ptr[r], gr1 = s.grp_ptr[r + 1];
    if (gr1 - gr0 <= s.heavy) continue;
    op.part(k * 2 + slot, max((int)lo, gr0), min(hi, gr1));
    const int k0 = gr0 / kChunk, k1 = (gr1 - 1) / kChunk;
    if (last_arrival(s.row_done + (size_t)r * gridDim.y + blockIdx.y,
                     k1 - k0 + 1, lane))
      op.combine(r, k0, k1, gr0 != k0 * kChunk);
  }
}

// ---- fp ------------------------------------------------------------------
struct FpGrid {
  Split s;
  const int32_t* tiles;
  const int32_t* col_idx;
  const float* x;
  float* out;      // (n_tile_rows * 4, f)
  float* scratch;  // (ceil(n_groups / kChunk), 2, 4, f)
  long long n_x_rows;
  int fw;          // feature block (blockIdx.y)
  int f;
};

template <int kSub, int kCols, bool kVec>
__device__ __forceinline__ void fp_rows(const FpGrid& a, int g0, int g1,
                                        int f0, int f1, float* dst, int lane,
                                        int2* hits) {
  using L = FpLanes<kSub, kCols, kVec>;
  for (int c0 = f0; c0 < f1; c0 += L::kPass) {
    float acc[kTile][kCols] = {};
    fp<kSub, kCols, kVec>(a.tiles, a.col_idx, a.x, g0, g1, c0, f1, a.f,
                          a.n_x_rows, lane, hits, acc);
    fold<kSub, kCols>(acc);
    store<kSub, kCols, kVec>(dst, a.f, c0, f1, lane, acc);
  }
}

template <int kSub, int kCols, bool kVec>
struct FpOp {
  const FpGrid& a;
  int lane, f0, f1;
  int2* hits;
  __device__ void row(int tr, int g0, int g1) {
    fp_rows<kSub, kCols, kVec>(a, g0, g1, f0, f1,
                               a.out + (size_t)tr * kTile * a.f, lane, hits);
  }
  __device__ void part(int item, int g0, int g1) {
    fp_rows<kSub, kCols, kVec>(a, g0, g1, f0, f1,
                               a.scratch + (size_t)item * kTile * a.f, lane,
                               hits);
  }
  __device__ void combine(int r, int k0, int k1, int s0) {
    for (int col = f0 + lane; col < f1; col += 32) {
      float acc[kTile] = {0.f, 0.f, 0.f, 0.f};
      for (int kc = k0; kc <= k1; ++kc) {
        const int s = kc == k0 ? s0 : 0;
        const float* p = a.scratch + ((size_t)kc * 2 + s) * kTile * a.f + col;
#pragma unroll
        for (int i = 0; i < kTile; ++i) acc[i] += __ldcg(p + (size_t)i * a.f);
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        a.out[((size_t)r * kTile + i) * a.f + col] = acc[i];
    }
  }
};

template <int kSub, int kCols, bool kVec>
__device__ __forceinline__ void fp_block(const FpGrid& a) {
  __shared__ int2 hits[kBlockWarps][kHitsPerLoad];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * a.fw;
  FpOp<kSub, kCols, kVec> op{a, lane, f0, min(f0 + a.fw, a.f), hits[warp]};
  split_block(a.s, op, lane, warp);
}

// ---- bits ----------------------------------------------------------------
struct BitsGrid {
  Split s;
  const int32_t* tiles;
  const int32_t* col_idx;
  const uint32_t* x;
  int32_t* out;      // (n_tile_rows * 4, wf) sign words or (.., wf * 32) counts
  int32_t* scratch;  // (ceil(n_groups / kChunk), 2, 4, wf * 32)
  long long n_x_rows;
  int wf;            // words of a row of x
  int fbw;           // words of a feature block (blockIdx.y)
  int n_feat;
  int binarize;
  int vec;           // kW-word loads: x's base and wf, fbw aligned to them
};

__device__ __forceinline__ uint32_t tail_keep(int w, int n_feat) {
  return (n_feat % 32 && w == n_feat / 32) ? (1u << (n_feat % 32)) - 1u
                                           : kFull;
}

// Stores words [w, w + nw) of four rows from row0: int32 counts, or sign
// words (sign(0) = +1) with the bits past n_feat cleared.
template <int kW>
__device__ __forceinline__ void store_bits(const BitsGrid& a, size_t row0,
                                           int w, int nw, int lane,
                                           const int acc[kTile][kW]) {
  const size_t width = (size_t)a.wf * 32;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (j >= nw) break;
    if (a.binarize) {
      const uint32_t keep = tail_keep(w + j, a.n_feat);
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const uint32_t word = sign_word(acc[i][j], keep);
        if (lane == i) a.out[(row0 + i) * a.wf + w + j] = (int32_t)word;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        a.out[(row0 + i) * width + (size_t)(w + j) * 32 + lane] = acc[i][j];
    }
  }
}

template <int kW, bool kS2>
struct BitsOp {
  const BitsGrid& a;
  int lane, w0, w1;
  __device__ void row(int tr, int g0, int g1) {
    for (int w = w0; w < w1; w += kW) {
      const int nw = min(kW, w1 - w);
      int acc[kTile][kW] = {};
      bits<kW, kS2>(a.tiles, a.col_idx, a.x, g0, g1, w, nw, a.wf,
                    a.vec && nw == kW, a.n_x_rows, lane, acc);
      store_bits<kW>(a, (size_t)tr * kTile, w, nw, lane, acc);
    }
  }
  __device__ void part(int item, int g0, int g1) {
    const size_t width = (size_t)a.wf * 32;
    int32_t* dst = a.scratch + (size_t)item * kTile * width;
    for (int w = w0; w < w1; w += kW) {
      const int nw = min(kW, w1 - w);
      int acc[kTile][kW] = {};
      bits<kW, kS2>(a.tiles, a.col_idx, a.x, g0, g1, w, nw, a.wf,
                    a.vec && nw == kW, a.n_x_rows, lane, acc);
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        if (j >= nw) break;
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          dst[i * width + (size_t)(w + j) * 32 + lane] = acc[i][j];
      }
    }
  }
  __device__ void combine(int r, int k0, int k1, int s0) {
    const size_t width = (size_t)a.wf * 32;
    for (int w = w0; w < w1; ++w) {
      int acc[kTile][1] = {};
      for (int kc = k0; kc <= k1; ++kc) {
        const int s = kc == k0 ? s0 : 0;
        const int32_t* p = a.scratch + ((size_t)kc * 2 + s) * kTile * width +
                           (size_t)w * 32 + lane;
#pragma unroll
        for (int i = 0; i < kTile; ++i) acc[i][0] += __ldcg(p + i * width);
      }
      store_bits<1>(a, (size_t)r * kTile, w, 1, lane, acc);
    }
  }
};

template <int kW, bool kS2>
__device__ __forceinline__ void bits_block(const BitsGrid& a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.y * a.fbw;
  BitsOp<kW, kS2> op{a, lane, w0, min(w0 + a.fbw, a.wf)};
  split_block(a.s, op, lane, warp);
}

// Before a bits launch: the grid (chunk CTAs, then a CTA per tb_rows
// tile-rows; a y block per fbw words), `vec`, and the tickets zeroed.
inline cudaError_t bits_setup(BitsGrid* a, long long n_groups, dim3* grid,
                              cudaStream_t stream) {
  const int kw = bits_pass(a->fbw);
  const int n_fb = (a->wf + a->fbw - 1) / a->fbw;
  a->s.n_chunk_blocks = chunk_blocks(n_groups);
  a->vec = kw > 1 && a->wf % kw == 0 && a->fbw % kw == 0 &&
           (uintptr_t)a->x % (4 * kw) == 0;
  *grid = dim3((unsigned)(a->s.n_chunk_blocks +
                          (a->s.n_tile_rows + a->s.tb_rows - 1) / a->s.tb_rows),
               (unsigned)n_fb);
  return cudaMemsetAsync(a->s.row_done, 0,
                         sizeof(int32_t) * a->s.n_tile_rows * n_fb, stream);
}

}  // namespace walk
