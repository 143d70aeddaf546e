// The task walk of the aggregating layer kernels: the single-host kinds of
// fused_layer.cu (one matrix, after the transform phase of the same launch)
// and the sharded pair step of fused_pair.cu (an intra and a halo matrix,
// after the transform launch).
//
// A launch walks a task list built once a plan (kernels/fused_layer.py
// pair_items), a warp a task. A tile-row is cut into items of `chunk`
// groups counted from its first group, at least one in each matrix. A
// light row (one item in each matrix) is one task (row, -1): its warp walks
// its items in turn and applies the epilogue in registers, with no scratch
// traffic. Every item of any other (heavy) row is a task (row, k) of its
// own, its intra items k < n_intra first; these come first in the list, so
// the long rows start first. Heavy task t writes its partial sums to
// scratch slot t; the warp that takes the row's last ticket
// (walk::last_arrival) adds the row's slots in item order and stores it.
//
// Association: each item's partial sums start from 0 (walk::fp and fold,
// or walk::bits); the row's sum starts at +0.0f and adds its intra items in
// order, then the sum of its halo items (from +0.0f, in order); then the
// row scale once, the self add ys + v and the ReLU, each one rounded
// operation; or the sign words of the integer counts (any order is exact),
// the tail past the width cleared. So a row without halo edges is
// bit-equal in both kernels.
//
// kHalo: the pair step. The rows y and rem come from earlier launches, and
// each column scale is applied at the gather (one rounded product of the
// gathered value, the product the single-host transform rounds). Without
// it, the single-host kinds: one matrix over rows that other blocks of this
// launch wrote (read past L1, ld.global.cg), the column scale already in
// them, and the self branch ys written by the same transform.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace tasks {

constexpr int kTile = walk::kTile;

// Items of a tile-row with groups [g0, g1): at least one.
__device__ __forceinline__ int n_items(int g0, int g1, int chunk) {
  return max(1, (g1 - g0 + chunk - 1) / chunk);
}

// One adjacency as a walk reads it: its arrays, the column scale applied at
// the gather (kHalo only) and the rows x its groups gather.
struct Side {
  const int32_t* grp_ptr;
  const int32_t* tiles;
  const int32_t* col_idx;
  const float* col_scale;
  const void* x;
  long long n_x;
};

// One launch's aggregation: a (the intra matrix, or the only one), h (the
// halo matrix, kHalo only) and the epilogue's operands.
struct Work {
  Side a;
  Side h;
  const float* row_scale;  // shared by both, applied once after the add
  const float* ys;         // (n_rows, ho) self branch, or null
  void* out;       // (n_rows, ho) float, or (n_rows, ceil(ho/32)) words
  void* part;      // (heavy tasks, 4, width) partial sums
  int32_t* row_done;  // (n_tile_rows) tickets, zero before the first item
  long long n_rows;
  int ho;
  int chunk;
  int relu;
};

// The groups of heavy task k of tile-row tr, in `a` or `h`; n_all: the
// row's items in both matrices.
template <bool kHalo>
__device__ __forceinline__ Side item(const Work& w, int tr, int k, int* g0,
                                     int* g1, int* n_intra, int* n_all) {
  const int gi0 = w.a.grp_ptr[tr], gi1 = w.a.grp_ptr[tr + 1];
  *n_intra = *n_all = n_items(gi0, gi1, w.chunk);
  if constexpr (kHalo) {
    const int gh0 = w.h.grp_ptr[tr], gh1 = w.h.grp_ptr[tr + 1];
    *n_all += n_items(gh0, gh1, w.chunk);
    if (k >= *n_intra) {
      *g0 = gh0 + (k - *n_intra) * w.chunk;
      *g1 = min(*g0 + w.chunk, gh1);
      return w.h;
    }
  }
  *g0 = gi0 + k * w.chunk;
  *g1 = min(*g0 + w.chunk, gi1);
  return w.a;
}

// ---- fp --------------------------------------------------------------------

// The fp epilogue of one output: the row scale, the self branch, the ReLU.
template <bool kHalo>
__device__ __forceinline__ void put_fp(const Work& w, long long row, int col,
                                       float v) {
  if (w.row_scale) v = __fmul_rn(v, w.row_scale[row]);
  if (w.ys) v = __fadd_rn(walk::load<!kHalo>(w.ys + row * w.ho + col), v);
  if (w.relu) v = fmaxf(v, 0.f);
  ((float*)w.out)[row * w.ho + col] = v;
}

// The raw sums of groups [g0, g1) of `s`, columns [c0, c0 + kPass), folded
// into lanes 0 .. kSub-1.
template <bool kHalo, int kSub, int kCols, bool kVec>
__device__ __forceinline__ void fp_walk(const Side& s, int ho, int g0, int g1,
                                        int c0, int lane, int2* hits,
                                        float acc[kTile][kCols]) {
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  walk::fp<kSub, kCols, kVec, !kHalo, kHalo>(s.tiles, s.col_idx,
                                             (const float*)s.x, g0, g1, c0, ho,
                                             ho, s.n_x, lane, hits, acc,
                                             s.col_scale);
  walk::fold<kSub, kCols>(acc);
}

// A light tile-row: its one intra item and, with kHalo, its one halo item
// in turn, the sums and the epilogue in registers.
template <bool kHalo, int kSub, int kCols, bool kVec>
__device__ void fp_light(const Work& w, int tr, int lane, int2* hits) {
  using L = walk::FpLanes<kSub, kCols, kVec>;
  const int g0 = w.a.grp_ptr[tr], g1 = w.a.grp_ptr[tr + 1];
  int h0 = 0, h1 = 0;
  if constexpr (kHalo) {
    h0 = w.h.grp_ptr[tr];
    h1 = w.h.grp_ptr[tr + 1];
  }
  for (int c0 = 0; c0 < w.ho; c0 += L::kPass) {
    float acc[kTile][kCols], hacc[kTile][kCols];
    fp_walk<kHalo, kSub, kCols, kVec>(w.a, w.ho, g0, g1, c0, lane, hits, acc);
    if constexpr (kHalo)
      fp_walk<kHalo, kSub, kCols, kVec>(w.h, w.ho, h0, h1, c0, lane, hits,
                                        hacc);
    if (lane < kSub) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = c0 + L::col(lane, c);
        if (col >= w.ho) continue;
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const long long row = (long long)tr * kTile + i;
          if (row >= w.n_rows) break;
          float v = __fadd_rn(0.f, acc[i][c]);
          if constexpr (kHalo) v = __fadd_rn(v, __fadd_rn(0.f, hacc[i][c]));
          put_fp<kHalo>(w, row, col, v);
        }
      }
    }
  }
}

// Item k of heavy tile-row tr (task t): its partial sums to scratch slot t;
// the last of the row's items to arrive adds the row's slots t - k ... in
// item order and stores the row.
template <bool kHalo, int kSub, int kCols, bool kVec>
__device__ void fp_heavy(const Work& w, long long t, int tr, int k, int lane,
                         int2* hits) {
  using L = walk::FpLanes<kSub, kCols, kVec>;
  int g0, g1, n_i, n_all;
  const Side s = item<kHalo>(w, tr, k, &g0, &g1, &n_i, &n_all);
  const size_t slot = (size_t)kTile * w.ho;
  float* part = (float*)w.part;
  for (int c0 = 0; c0 < w.ho; c0 += L::kPass) {
    float acc[kTile][kCols];
    fp_walk<kHalo, kSub, kCols, kVec>(s, w.ho, g0, g1, c0, lane, hits, acc);
    walk::store<kSub, kCols, kVec>(part + (size_t)t * slot, w.ho, c0, w.ho,
                                   lane, acc);
  }
  if (!walk::last_arrival(w.row_done + tr, n_all, lane)) return;
  const float* first = part + (size_t)(t - k) * slot;
  for (int col = lane; col < w.ho; col += 32) {
    float acc[kTile] = {0.f, 0.f, 0.f, 0.f}, hacc[kTile] = {0.f, 0.f, 0.f, 0.f};
    for (int it = 0; it < n_i; ++it) {
      const float* q = first + (size_t)it * slot + col;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        acc[i] = __fadd_rn(acc[i], __ldcg(q + (size_t)i * w.ho));
    }
    for (int it = n_i; it < n_all; ++it) {
      const float* q = first + (size_t)it * slot + col;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        hacc[i] = __fadd_rn(hacc[i], __ldcg(q + (size_t)i * w.ho));
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const long long row = (long long)tr * kTile + i;
      if (row >= w.n_rows) break;
      put_fp<kHalo>(w, row, col, kHalo ? __fadd_rn(acc[i], hacc[i]) : acc[i]);
    }
  }
}

// Task t = (tr, k) of an fp launch.
template <bool kHalo, int kSub, int kCols, bool kVec>
__device__ __forceinline__ void fp_task(const Work& w, long long t, int tr,
                                        int k, int lane, int2* hits) {
  if (k < 0)
    fp_light<kHalo, kSub, kCols, kVec>(w, tr, lane, hits);
  else
    fp_heavy<kHalo, kSub, kCols, kVec>(w, t, tr, k, lane, hits);
}

// ---- counts ----------------------------------------------------------------

// Sign words [wd, wd + nw) of the four rows of tile-row tr from the counts.
template <int kW>
__device__ __forceinline__ void put_words(const Work& w, int tr, int wd,
                                          int nw, int lane,
                                          const int acc[kTile][kW]) {
  const int wh = (w.ho + 31) / 32;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (j >= nw) break;
    const uint32_t keep = walk::tail_keep(wd + j, w.ho);
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const uint32_t word = walk::sign_word(acc[i][j], keep);
      const long long row = (long long)tr * kTile + i;
      if (lane == 0 && row < w.n_rows)
        ((uint32_t*)w.out)[row * wh + wd + j] = word;
    }
  }
}

template <bool kHalo, int kW, bool kS2>
__device__ __forceinline__ void bits_walk(const Side& s, int g0, int g1,
                                          int wd, int nw, int wh, int lane,
                                          int acc[kTile][kW]) {
  const uint32_t* x = (const uint32_t*)s.x;
  const bool vec = nw == kW && wh % kW == 0 && (uintptr_t)x % (4 * kW) == 0;
  walk::bits<kW, kS2, !kHalo>(s.tiles, s.col_idx, x, g0, g1, wd, nw, wh, vec,
                              s.n_x, lane, acc);
}

template <bool kHalo, int kW, bool kS2>
__device__ void bits_light(const Work& w, int tr, int lane) {
  const int wh = (w.ho + 31) / 32;
  const int g0 = w.a.grp_ptr[tr], g1 = w.a.grp_ptr[tr + 1];
  int h0 = 0, h1 = 0;
  if constexpr (kHalo) {
    h0 = w.h.grp_ptr[tr];
    h1 = w.h.grp_ptr[tr + 1];
  }
  for (int wd = 0; wd < wh; wd += kW) {
    const int nw = min(kW, wh - wd);
    int acc[kTile][kW] = {};
    bits_walk<kHalo, kW, kS2>(w.a, g0, g1, wd, nw, wh, lane, acc);
    if constexpr (kHalo)
      bits_walk<kHalo, kW, kS2>(w.h, h0, h1, wd, nw, wh, lane, acc);
    put_words<kW>(w, tr, wd, nw, lane, acc);
  }
}

template <bool kHalo, int kW, bool kS2>
__device__ void bits_heavy(const Work& w, long long t, int tr, int k,
                           int lane) {
  const int wh = (w.ho + 31) / 32, width = wh * 32;
  int g0, g1, n_i, n_all;
  const Side s = item<kHalo>(w, tr, k, &g0, &g1, &n_i, &n_all);
  const size_t slot = (size_t)kTile * width;
  int32_t* part = (int32_t*)w.part;
  for (int wd = 0; wd < wh; wd += kW) {
    const int nw = min(kW, wh - wd);
    int acc[kTile][kW] = {};
    bits_walk<kHalo, kW, kS2>(s, g0, g1, wd, nw, wh, lane, acc);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (j >= nw) break;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        part[t * slot + i * width + (wd + j) * 32 + lane] = acc[i][j];
    }
  }
  if (!walk::last_arrival(w.row_done + tr, n_all, lane)) return;
  const int32_t* first = part + (size_t)(t - k) * slot;
  for (int wd = 0; wd < wh; ++wd) {
    int acc[kTile][1] = {};
    for (int it = 0; it < n_all; ++it)
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        acc[i][0] += __ldcg(first + it * slot + i * width + wd * 32 + lane);
    put_words<1>(w, tr, wd, 1, lane, acc);
  }
}

// Task t = (tr, k) of a counts launch.
template <bool kHalo, int kW, bool kS2>
__device__ __forceinline__ void bits_task(const Work& w, long long t, int tr,
                                          int k, int lane) {
  if (k < 0)
    bits_light<kHalo, kW, kS2>(w, tr, lane);
  else
    bits_heavy<kHalo, kW, kS2>(w, t, tr, k, lane);
}

}  // namespace tasks
