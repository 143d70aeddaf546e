// The sharded executors' pair step: one shard's aggregation over its intra
// adjacency and its halo adjacency, and the layer's epilogue, on the
// transform that the same step launched just before (fused_layer.cu with
// aggregate = 0).
//
// With that transform it replaces the Pallas TPU kernel
// repro/kernels/fused_layer.py:fused_call as the reference's sharded
// executors run it: BN -> transform -> agg(intra, y) + agg(halo, rem) ->
// post inside one pallas_call. The transform's rows y are what the shards
// exchange, so the step computes them once: the halo rows rem of this shard
// are the other shards' y, on the card before this launch.
//
// Inputs: y (n_y rows, this shard's transform: fp32 rows or packed sign
// words), rem (n_rem rows, the exchanged rows of its halo nodes), ys (the
// self branch, fp) and the two FRDC matrices over the same tile-rows. Out:
//   fp:    (sum_intra(y * col_scale) + sum_halo(rem * h_col_scale))
//          * row_scale [+ ys] [-> ReLU]
//   words: sign words of the trinary popc counts of both, the tail cleared.
// Association (fused_layer.cu's phases 2-3 extended to a second matrix,
// so a row without halo edges is bit-equal to the one-launch kind): a
// tile-row is cut into items of `chunk` groups counted from its first
// group, at least one each, in the intra matrix and in the halo matrix;
// each item's partial sums start from 0 (walk::fp and fold, or
// walk::bits); the row's sum starts at +0.0f and adds its intra items in
// order, then the sum of its halo items (from +0.0f, in order); then the
// row scale once, the self add ys + v and the ReLU, each one rounded
// operation. Each column scale is applied at the gather, one rounded
// product of the gathered value, the product the one-launch kind's
// transform rounds. Counts are integers: any order is exact.
//
// Work split: a warp per task, from a task list built once per plan
// (kernels/fused_layer.py pair_items). A tile-row of one intra item and at
// most one halo item (nearly every row of a sharded plan) is one task: its
// warp walks both in turn and applies the epilogue in registers, with no
// scratch traffic. Every item of any other row is a task of its own; these
// come first in the list, so the long rows start first, and each writes its
// partial sums to scratch; the warp that takes the row's last ticket
// (walk::last_arrival) adds them in item order and stores the row. The
// launch is an ordinary one, a block per 8 tasks: no grid-wide barrier, no
// dynamic shared memory, and the walks' own launch bounds.
//
// Bound on H100: bytes (the two matrices' groups, the gathered rows of y and
// rem, the scales, ys and the output). A light row is a chain of dependent
// round trips (task, group range, tiles, gathers, for each matrix, then the
// epilogue's loads), so the design keeps the SM's warps on the gathers (80
// registers, 3 blocks a SM at 64 columns), moves no partial sums for the
// light rows and loads each column scale beside its row, not in a round
// trip of its own. tools/pair_variants.py times the alternatives that read
// slower on the H100: fewer registers (spills), each warp looping over
// tasks, a hub row's combine loading 8 items at once, the halo's first
// index loads sent to L2 early.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "walk.cuh"

namespace {

constexpr int kWarps = walk::kBlockWarps;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = walk::kTile;

struct Params {
  // intra adjacency: the shard's tile-rows x its own rows (y)
  const int32_t* grp_ptr;
  const int32_t* tiles;
  const int32_t* col_idx;
  const float* col_scale;
  // halo adjacency: the same tile-rows x its halo nodes (rem)
  const int32_t* h_grp_ptr;
  const int32_t* h_tiles;
  const int32_t* h_col_idx;
  const float* h_col_scale;
  const float* row_scale;  // shared by both, applied once after the add
  // (n_tasks, 2): (tile-row, -1) for a light row, (tile-row, k) for item k
  // of a heavy row (its intra items, then its halo items)
  const int32_t* tasks;
  int32_t* row_done;  // (n_tile_rows) tickets, zeroed by the launcher
  void* part;         // (heavy tasks, 4, width) partial sums
  const void* y;      // (n_y, ho) float, or (n_y, ceil(ho/32)) words
  const void* rem;    // (n_rem, ...) likewise
  const float* ys;    // (n_rows, ho) self branch, or null
  void* out;          // (n_rows, ho) float, or (n_rows, ceil(ho/32)) words
  long long n_y;
  long long n_rem;
  long long n_rows;
  int n_tile_rows;
  int n_tasks;
  int ho;
  int chunk;
  int fbb;  // packed sign words in and out (the counts form)
  int s2;
  int relu;
  // the fp walk's lane layout (walk::FpLanes), from the wrapper
  int fp_sub;
  int fp_cols;
  int fp_vec;
};

// Items of a tile-row with groups [g0, g1): at least one.
__device__ __forceinline__ int n_items(int g0, int g1, int chunk) {
  return max(1, (g1 - g0 + chunk - 1) / chunk);
}

// One adjacency as a walk reads it.
struct Side {
  const int32_t* grp_ptr;
  const int32_t* tiles;
  const int32_t* col_idx;
  const float* col_scale;
  const void* x;
  long long n_x;
};

__device__ __forceinline__ Side intra_side(const Params& p) {
  return {p.grp_ptr, p.tiles, p.col_idx, p.col_scale, p.y, p.n_y};
}

__device__ __forceinline__ Side halo_side(const Params& p) {
  return {p.h_grp_ptr, p.h_tiles, p.h_col_idx, p.h_col_scale, p.rem, p.n_rem};
}

// The fp epilogue of one output: the row scale, the self branch, the ReLU.
__device__ __forceinline__ void put_fp(const Params& p, long long row, int col,
                                       float v) {
  if (p.row_scale) v = __fmul_rn(v, p.row_scale[row]);
  if (p.ys) v = __fadd_rn(p.ys[row * p.ho + col], v);
  if (p.relu) v = fmaxf(v, 0.f);
  ((float*)p.out)[row * p.ho + col] = v;
}

// ---- fp --------------------------------------------------------------------

// The raw sums of groups [g0, g1) of `s`, columns [c0, c0 + kPass), folded
// into lanes 0 .. kSub-1.
template <int kSub, int kCols, bool kVec>
__device__ __forceinline__ void fp_walk(const Side& s, int ho, int g0, int g1,
                                        int c0, int lane, int2* hits,
                                        float acc[kTile][kCols]) {
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  walk::fp<kSub, kCols, kVec, false, true>(s.tiles, s.col_idx,
                                           (const float*)s.x, g0, g1, c0, ho,
                                           ho, s.n_x, lane, hits, acc,
                                           s.col_scale);
  walk::fold<kSub, kCols>(acc);
}

// A light tile-row: its one intra item and its one halo item in turn, the
// sums and the epilogue in registers.
template <int kSub, int kCols, bool kVec>
__device__ void fp_light(const Params& p, int tr, int lane, int2* hits) {
  using L = walk::FpLanes<kSub, kCols, kVec>;
  const Side a = intra_side(p), h = halo_side(p);
  const int g0 = p.grp_ptr[tr], g1 = p.grp_ptr[tr + 1];
  const int h0 = p.h_grp_ptr[tr], h1 = p.h_grp_ptr[tr + 1];
  for (int c0 = 0; c0 < p.ho; c0 += L::kPass) {
    float acc[kTile][kCols], hacc[kTile][kCols];
    fp_walk<kSub, kCols, kVec>(a, p.ho, g0, g1, c0, lane, hits, acc);
    fp_walk<kSub, kCols, kVec>(h, p.ho, h0, h1, c0, lane, hits, hacc);
    if (lane < kSub) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = c0 + L::col(lane, c);
        if (col >= p.ho) continue;
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const long long row = (long long)tr * kTile + i;
          if (row >= p.n_rows) break;
          const float v = __fadd_rn(0.f, acc[i][c]);
          put_fp(p, row, col, __fadd_rn(v, __fadd_rn(0.f, hacc[i][c])));
        }
      }
    }
  }
}

// Item k of heavy tile-row tr (task t): its partial sums to scratch slot t;
// the last of the row's items to arrive adds the row's slots t - k ... in
// item order and stores the row.
template <int kSub, int kCols, bool kVec>
__device__ void fp_heavy(const Params& p, long long t, int tr, int k, int lane,
                         int2* hits) {
  using L = walk::FpLanes<kSub, kCols, kVec>;
  const int gi0 = p.grp_ptr[tr], gi1 = p.grp_ptr[tr + 1];
  const int gh0 = p.h_grp_ptr[tr], gh1 = p.h_grp_ptr[tr + 1];
  const int n_i = n_items(gi0, gi1, p.chunk), n_h = n_items(gh0, gh1, p.chunk);
  const bool in_halo = k >= n_i;
  const Side s = in_halo ? halo_side(p) : intra_side(p);
  const int g0 = (in_halo ? gh0 : gi0) + (in_halo ? k - n_i : k) * p.chunk;
  const int g1 = min(g0 + p.chunk, in_halo ? gh1 : gi1);
  const size_t slot = (size_t)kTile * p.ho;
  float* part = (float*)p.part;
  for (int c0 = 0; c0 < p.ho; c0 += L::kPass) {
    float acc[kTile][kCols];
    fp_walk<kSub, kCols, kVec>(s, p.ho, g0, g1, c0, lane, hits, acc);
    walk::store<kSub, kCols, kVec>(part + (size_t)t * slot, p.ho, c0, p.ho,
                                   lane, acc);
  }
  if (!walk::last_arrival(p.row_done + tr, n_i + n_h, lane)) return;
  const float* first = part + (size_t)(t - k) * slot;
  for (int col = lane; col < p.ho; col += 32) {
    float acc[kTile] = {0.f, 0.f, 0.f, 0.f}, hacc[kTile] = {0.f, 0.f, 0.f, 0.f};
    for (int it = 0; it < n_i; ++it) {
      const float* q = first + (size_t)it * slot + col;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        acc[i] = __fadd_rn(acc[i], __ldcg(q + (size_t)i * p.ho));
    }
    for (int it = n_i; it < n_i + n_h; ++it) {
      const float* q = first + (size_t)it * slot + col;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        hacc[i] = __fadd_rn(hacc[i], __ldcg(q + (size_t)i * p.ho));
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const long long row = (long long)tr * kTile + i;
      if (row >= p.n_rows) break;
      put_fp(p, row, col, __fadd_rn(acc[i], hacc[i]));
    }
  }
}

template <int kSub, int kCols, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_pair_fp_kernel(const __grid_constant__ Params p) {
  __shared__ int2 s_hits[kWarps][walk::kHitsPerLoad];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = (long long)blockIdx.x * kWarps + warp;
  if (t >= p.n_tasks) return;
  const int tr = p.tasks[2 * t], k = p.tasks[2 * t + 1];
  if (k < 0)
    fp_light<kSub, kCols, kVec>(p, tr, lane, s_hits[warp]);
  else
    fp_heavy<kSub, kCols, kVec>(p, t, tr, k, lane, s_hits[warp]);
}

// ---- counts ----------------------------------------------------------------

// Sign words [w, w + nw) of the four rows of tile-row tr from the counts.
template <int kW>
__device__ __forceinline__ void put_words(const Params& p, int tr, int w,
                                          int nw, int lane,
                                          const int acc[kTile][kW]) {
  const int wh = (p.ho + 31) / 32;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (j >= nw) break;
    const uint32_t keep = walk::tail_keep(w + j, p.ho);
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const uint32_t word = walk::sign_word(acc[i][j], keep);
      const long long row = (long long)tr * kTile + i;
      if (lane == 0 && row < p.n_rows)
        ((uint32_t*)p.out)[row * wh + w + j] = word;
    }
  }
}

template <int kW, bool kS2>
__device__ __forceinline__ void bits_walk(const Side& s, int g0, int g1, int w,
                                          int nw, int wh, int lane,
                                          int acc[kTile][kW]) {
  const uint32_t* x = (const uint32_t*)s.x;
  const bool vec = nw == kW && wh % kW == 0 && (uintptr_t)x % (4 * kW) == 0;
  walk::bits<kW, kS2>(s.tiles, s.col_idx, x, g0, g1, w, nw, wh, vec, s.n_x,
                      lane, acc);
}

template <int kW, bool kS2>
__device__ void bits_light(const Params& p, int tr, int lane) {
  const int wh = (p.ho + 31) / 32;
  const Side a = intra_side(p), h = halo_side(p);
  const int g0 = p.grp_ptr[tr], g1 = p.grp_ptr[tr + 1];
  const int h0 = p.h_grp_ptr[tr], h1 = p.h_grp_ptr[tr + 1];
  for (int w = 0; w < wh; w += kW) {
    const int nw = min(kW, wh - w);
    int acc[kTile][kW] = {};
    bits_walk<kW, kS2>(a, g0, g1, w, nw, wh, lane, acc);
    bits_walk<kW, kS2>(h, h0, h1, w, nw, wh, lane, acc);
    put_words<kW>(p, tr, w, nw, lane, acc);
  }
}

template <int kW, bool kS2>
__device__ void bits_heavy(const Params& p, long long t, int tr, int k,
                           int lane) {
  const int wh = (p.ho + 31) / 32, width = wh * 32;
  const int gi0 = p.grp_ptr[tr], gi1 = p.grp_ptr[tr + 1];
  const int gh0 = p.h_grp_ptr[tr], gh1 = p.h_grp_ptr[tr + 1];
  const int n_i = n_items(gi0, gi1, p.chunk), n_h = n_items(gh0, gh1, p.chunk);
  const bool in_halo = k >= n_i;
  const Side s = in_halo ? halo_side(p) : intra_side(p);
  const int g0 = (in_halo ? gh0 : gi0) + (in_halo ? k - n_i : k) * p.chunk;
  const int g1 = min(g0 + p.chunk, in_halo ? gh1 : gi1);
  const size_t slot = (size_t)kTile * width;
  int32_t* part = (int32_t*)p.part;
  for (int w = 0; w < wh; w += kW) {
    const int nw = min(kW, wh - w);
    int acc[kTile][kW] = {};
    bits_walk<kW, kS2>(s, g0, g1, w, nw, wh, lane, acc);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (j >= nw) break;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        part[t * slot + i * width + (w + j) * 32 + lane] = acc[i][j];
    }
  }
  if (!walk::last_arrival(p.row_done + tr, n_i + n_h, lane)) return;
  const int32_t* first = part + (size_t)(t - k) * slot;
  for (int w = 0; w < wh; ++w) {
    int acc[kTile][1] = {};
    for (int it = 0; it < n_i + n_h; ++it)
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        acc[i][0] += __ldcg(first + it * slot + i * width + w * 32 + lane);
    put_words<1>(p, tr, w, 1, lane, acc);
  }
}

template <int kW, bool kS2>
__global__ void __launch_bounds__(kThreads, walk::bits_min_blocks(kW))
    fused_pair_bits_kernel(const __grid_constant__ Params p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = (long long)blockIdx.x * kWarps + warp;
  if (t >= p.n_tasks) return;
  const int tr = p.tasks[2 * t], k = p.tasks[2 * t + 1];
  if (k < 0)
    bits_light<kW, kS2>(p, tr, lane);
  else
    bits_heavy<kW, kS2>(p, t, tr, k, lane);
}

}  // namespace

// One pair step on `stream`: a warp per task, 8 a block. A launch the card
// refuses returns its error.
extern "C" int fused_pair(const void* params, void* stream) {
  const Params& p = *(const Params*)params;
  if (p.ho <= 0 || p.chunk <= 0 || !p.tasks || !p.y || !p.rem)
    return (int)cudaErrorInvalidValue;
  if (p.n_tasks <= 0) return (int)cudaGetLastError();
  if (p.row_done) {
    const cudaError_t e = cudaMemsetAsync(
        p.row_done, 0, sizeof(int32_t) * p.n_tile_rows, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((p.n_tasks + kWarps - 1) / kWarps);
  auto run = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>(p);
    return cudaGetLastError();
  };
  if (p.fbb)
    return (int)walk::with_bits_pass((p.ho + 31) / 32, p.s2, [&](auto w, auto s2) {
      return run(fused_pair_bits_kernel<decltype(w)::value, decltype(s2)::value>);
    });
  return (int)walk::with_fp_layout(p.fp_sub, p.fp_cols, p.fp_vec,
                                   [&](auto sub, auto cols, auto vec) {
    return run(fused_pair_fp_kernel<decltype(sub)::value, decltype(cols)::value,
                                    decltype(vec)::value>);
  });
}

// Registers a thread, static shared bytes and resident blocks per SM of the
// fp pair kernel built for layout (sub, cols, vec): out[0..3].
extern "C" int fused_pair_fp_attrs(int sub, int cols, int vec, int* out) {
  return (int)walk::with_fp_layout(sub, cols, vec, [&](auto s, auto c, auto v) {
    return launch::attributes(
        fused_pair_fp_kernel<decltype(s)::value, decltype(c)::value,
                             decltype(v)::value>,
        kThreads, 0, out);
  });
}

// The same for the counts kernel of rows of `words` words and formula s2.
extern "C" int fused_pair_bits_attrs(int words, int s2, int* out) {
  return (int)walk::with_bits_pass(words, s2, [&](auto w, auto s) {
    return launch::attributes(
        fused_pair_bits_kernel<decltype(w)::value, decltype(s)::value>,
        kThreads, 0, out);
  });
}
