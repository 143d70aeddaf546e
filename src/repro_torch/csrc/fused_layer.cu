// One launch per GNN layer: BN -> binary transform -> BSpMM aggregation ->
// combine / activation.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_layer.py:fused_call,
// which replays a whole layer's jaxpr inside one pallas_call. CUDA cannot
// replay a jaxpr, so this kernel is written for the layer kinds the three
// model families compose (reference models/gnn.py):
//   gcn_bin_l1   BN -> BMM.FBB (fp x times +-1 weights, sign) -> BSpMM.BBB
//                (trinary popc counts, sign) -> packed words;
//   gcn_bbf_fbf  [BN -> quantize_act] or packed input with unit scales ->
//                BMM.BBF -> BSpMM.FBF [-> ReLU];
//   branch_add   BN -> quantize_act -> BMM.BBF self + BSpMM.FBF(BMM.BBF agg)
//                [-> ReLU];
//   fc           BN -> quantize_act -> BMM.BBF.
//
// Aggregation needs every row's transform first, so the kernel is launched
// cooperatively (all blocks resident, grid sized from the occupancy) and
// runs three grid-stride phases separated by grid-wide barriers:
//   1. transform: one warp per row. BN is (x - mu) / sd; quantize_act takes
//      the sign bits and the mean |z| of the row; BMM.BBF is the XNOR-popc
//      count times the row and weight scales; BMM.FBB sums z times the
//      dequantized weight (+-scale) in k order and keeps the sign. The
//      column scale of the adjacency is folded into the aggregated operand.
//   2. aggregate: one warp per work item (at most `chunk` groups of one
//      tile-row, from item_ptr), walking its groups in order (walk.cuh) and
//      storing the item's partial sums.
//   3. combine: one warp per tile-row adds its items' partials in item order,
//      then applies the row scale, the self branch and the ReLU, or the sign
//      (with the tail bits past the width cleared).
// Every sum has a fixed order, so two runs give the same bits. The scratch
// (transform output, partials) comes from the caller's torch.empty.
// Bound on H100: bytes at serving shapes (the input rows are read once; the
// transform is at most 2 F H operations a row against 4 F bytes read).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kMaxWords = 128;  // input width <= 4096 features
constexpr int kMaxChunks = 8;   // output width <= 256
constexpr int kTile = walk::kTile;
constexpr unsigned kFull = walk::kFull;

struct Params {
  // transform input: fp rows x (with BN when mu != null) or packed words xw
  const float* x;
  const uint32_t* xw;
  const float* mu;
  const float* sd;
  long long n_in;
  int f;   // input features (bits of the weights' contraction)
  int wk;  // words of f
  // weights: packed W.T (ho, wk) and per-output scales; w_s/s_s: self branch
  const uint32_t* w_a;
  const float* s_a;
  const uint32_t* w_s;
  const float* s_s;
  int ho;
  int fbb;        // BMM.FBB + BSpMM.BBB (gcn_bin_l1)
  int aggregate;  // 0: no aggregation (fc)
  int s2;
  int relu;
  // adjacency
  const int32_t* grp_ptr;
  const int32_t* tiles;
  const int32_t* col_idx;
  const int32_t* item_ptr;
  const float* row_scale;
  const float* col_scale;
  int n_tile_rows;
  long long n_rows;
  int chunk;
  // scratch and output
  void* y;      // (n_in, ho) float, or (n_in, ceil(ho/32)) words when fbb
  float* ys;    // (n_in, ho) self branch
  void* part;   // (max_items, 4, width) partial sums
  void* out;    // (n_rows, ho) float, or (n_rows, ceil(ho/32)) words
  // the fp aggregation's lane layout (walk::FpLanes), from the wrapper
  int fp_sub;
  int fp_cols;
  int fp_vec;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Phase 1 for one row, one warp.
__device__ void transform_row(const Params& p, long long r, int lane,
                              uint32_t* sw) {
  const int wh = (p.ho + 31) / 32;
  if (p.fbb) {
    // BMM.FBB: acc[c] = sum_k z_k * (+-s_j), j = c*32 + lane
    float acc[kMaxChunks], sj[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      acc[c] = 0.f;
      sj[c] = c < wh ? p.s_a[min(c * 32 + lane, p.ho - 1)] : 0.f;
    }
    for (int k0 = 0; k0 < p.f; k0 += 32) {
      const int k = k0 + lane;
      float z = 0.f;
      if (k < p.f) {
        z = p.x[r * p.f + k];
        if (p.mu) z = (z - p.mu[k]) / p.sd[k];
      }
      uint32_t wword[kMaxChunks];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int j = c * 32 + lane;
        wword[c] = (c < wh && j < p.ho) ? p.w_a[(size_t)j * p.wk + k0 / 32] : 0u;
      }
      const int kn = min(32, p.f - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float zk = __shfl_sync(kFull, z, kk);
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          if (c >= wh) break;
          // the dequantized weight: +s_j where the bit is 1, else -s_j
          const uint32_t neg = (~(wword[c] >> kk) & 1u) << 31;
          acc[c] = fmaf(zk, __uint_as_float(__float_as_uint(sj[c]) ^ neg),
                        acc[c]);
        }
      }
    }
    uint32_t* yw = (uint32_t*)p.y;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c >= wh) break;
      const int j = c * 32 + lane;
      const uint32_t word = __ballot_sync(kFull, j < p.ho && acc[c] >= 0.f);
      if (lane == 0) yw[r * wh + c] = word;
    }
    return;
  }
  // quantize_act (or packed input with unit scales), then BMM.BBF
  float xs = 1.f;
  const uint32_t* words = sw;
  if (p.x) {
    float sabs = 0.f;
    for (int k0 = 0; k0 < p.f; k0 += 32) {
      const int k = k0 + lane;
      float z = 0.f;
      if (k < p.f) {
        z = p.x[r * p.f + k];
        if (p.mu) z = (z - p.mu[k]) / p.sd[k];
        sabs += fabsf(z);
      }
      const uint32_t word = __ballot_sync(kFull, k < p.f && z >= 0.f);
      if (lane == 0) sw[k0 / 32] = word;
    }
    __syncwarp();
    xs = warp_sum(sabs) / (float)p.f;
  } else {
    words = p.xw + r * p.wk;
  }
  const float cs = (p.aggregate && p.col_scale) ? p.col_scale[r] : 1.f;
  for (int j0 = 0; j0 < p.ho; j0 += 32) {
    const int j = j0 + lane;
    if (j >= p.ho) continue;
    int pa = 0, ps = 0;
    for (int w = 0; w < p.wk; ++w) {
      const uint32_t xv = words[w];
      pa += __popc(xv ^ p.w_a[(size_t)j * p.wk + w]);
      if (p.w_s) ps += __popc(xv ^ p.w_s[(size_t)j * p.wk + w]);
    }
    // (count * row scale) * weight scale, the order of core/bmm.py
    float ya = (float)(p.f - 2 * pa) * xs * p.s_a[j];
    if (!p.aggregate) {
      ((float*)p.out)[r * p.ho + j] = ya;
      continue;
    }
    if (p.col_scale) ya = ya * cs;
    ((float*)p.y)[r * p.ho + j] = ya;
    if (p.w_s) p.ys[r * p.ho + j] = (float)(p.f - 2 * ps) * xs * p.s_s[j];
  }
  __syncwarp();
}

// Warp `it`'s work item: tile-row `row` with item_ptr[row] <= it <
// item_ptr[row + 1], groups [g0, g1).
__device__ __forceinline__ void find_item(const Params& p, long long it,
                                          int* row, int* g0, int* g1) {
  int lo = 0, hi = p.n_tile_rows;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (p.item_ptr[mid] <= it) lo = mid; else hi = mid;
  }
  *row = lo;
  *g0 = p.grp_ptr[lo] + (int)(it - p.item_ptr[lo]) * p.chunk;
  *g1 = min(*g0 + p.chunk, p.grp_ptr[lo + 1]);
}

// Phase 2 for one fp work item: its partial sums, every column, to `part`.
template <int kSub, int kCols, bool kVec>
__device__ __forceinline__ void aggregate_fp(const Params& p, float* part,
                                             int g0, int g1, int lane,
                                             int2* hits) {
  using L = walk::FpLanes<kSub, kCols, kVec>;
  for (int c0 = 0; c0 < p.ho; c0 += L::kPass) {
    float acc[kTile][kCols] = {};
    walk::fp<kSub, kCols, kVec, true>(p.tiles, p.col_idx, (const float*)p.y,
                                      g0, g1, c0, p.ho, p.ho, p.n_in, lane,
                                      hits, acc);
    walk::fold<kSub, kCols>(acc);
    walk::store<kSub, kCols, kVec>(part, p.ho, c0, p.ho, lane, acc);
  }
}

__global__ void __launch_bounds__(kWarps * 32) fused_layer_kernel(Params p) {
  __shared__ uint32_t s_words[kWarps][kMaxWords];
  __shared__ int2 s_hits[kWarps][walk::kHitsPerLoad];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const int wh = (p.ho + 31) / 32;

  for (long long r = gw; r < p.n_in; r += n_warps)
    transform_row(p, r, lane, s_words[warp]);
  if (!p.aggregate) return;
  grid.sync();

  // 2. aggregate: partial sums per work item
  const int width = p.fbb ? wh * 32 : p.ho;
  const long long n_items = p.item_ptr[p.n_tile_rows];
  for (long long it = gw; it < n_items; it += n_warps) {
    int row, g0, g1;
    find_item(p, it, &row, &g0, &g1);
    if (p.fbb) {
      int32_t* part = (int32_t*)p.part + it * kTile * width;
      for (int w = 0; w < wh; ++w) {
        int acc[kTile] = {0, 0, 0, 0};
        walk::bits<true>(p.tiles, p.col_idx, (const uint32_t*)p.y, g0, g1, w, wh,
                   p.n_in, p.s2, lane, acc);
#pragma unroll
        for (int i = 0; i < kTile; ++i) part[i * width + w * 32 + lane] = acc[i];
      }
    } else {
      float* part = (float*)p.part + it * kTile * width;
#define AGGREGATE(S, C, V)                                              \
  if (p.fp_sub == S && p.fp_cols == C && p.fp_vec == (V))               \
    aggregate_fp<S, C, V>(p, part, g0, g1, lane, s_hits[warp]);         \
  else
      WALK_FP_LAYOUTS(AGGREGATE) {}
#undef AGGREGATE
    }
  }
  grid.sync();

  // 3. combine: add the items of each tile-row in order, then the epilogue
  for (long long tr = gw; tr < p.n_tile_rows; tr += n_warps) {
    const int i0 = p.item_ptr[tr], i1 = p.item_ptr[tr + 1];
    const long long row0 = tr * kTile;
    if (p.fbb) {
      for (int w = 0; w < wh; ++w) {
        int acc[kTile] = {0, 0, 0, 0};
        for (int it = i0; it < i1; ++it) {
          const int32_t* part = (const int32_t*)p.part + (long long)it * kTile * width;
#pragma unroll
          for (int i = 0; i < kTile; ++i) acc[i] += __ldcg(part + i * width + w * 32 + lane);
        }
        const uint32_t keep = (w == wh - 1 && p.ho % 32) ? (1u << (p.ho % 32)) - 1u : kFull;
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const uint32_t word = walk::sign_word(acc[i], keep);
          if (lane == 0 && row0 + i < p.n_rows)
            ((uint32_t*)p.out)[(row0 + i) * wh + w] = word;
        }
      }
    } else {
      for (int c0 = 0; c0 < p.ho; c0 += 32) {
        const int col = c0 + lane;
        if (col >= p.ho) break;
        float acc[kTile] = {0.f, 0.f, 0.f, 0.f};
        for (int it = i0; it < i1; ++it) {
          const float* part = (const float*)p.part + (long long)it * kTile * width;
#pragma unroll
          for (int i = 0; i < kTile; ++i) acc[i] += __ldcg(part + i * width + col);
        }
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const long long row = row0 + i;
          if (row >= p.n_rows) break;
          float v = acc[i];
          if (p.row_scale) v = v * p.row_scale[row];
          if (p.ys) v = __ldcg(p.ys + row * p.ho + col) + v;
          if (p.relu) v = fmaxf(v, 0.f);
          ((float*)p.out)[row * p.ho + col] = v;
        }
      }
    }
  }
}

}  // namespace

// Launch one layer cooperatively on `stream`; the grid is as many blocks as
// can be resident at once, capped by the rows and items the layer has.
extern "C" int fused_layer(const void* params, void* stream) {
  Params p = *(const Params*)params;
  if (p.wk > kMaxWords || (p.ho + 31) / 32 > kMaxChunks) return (int)cudaErrorInvalidValue;
  if (p.aggregate && !p.fbb &&
      walk::with_fp_layout(p.fp_sub, p.fp_cols, p.fp_vec,
                           [](auto, auto, auto) { return cudaSuccess; }) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_layer_kernel,
                                                      kWarps * 32, 0);
  if (e != cudaSuccess) return (int)e;
  long long want = (p.n_in + kWarps - 1) / kWarps;
  long long rows = ((long long)p.n_tile_rows + kWarps - 1) / kWarps;
  if (rows > want) want = rows;
  long long blocks = (long long)per_sm * sms;
  if (want < blocks) blocks = want;
  if (blocks < 1) blocks = 1;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)fused_layer_kernel, dim3((unsigned)blocks),
                                  dim3(kWarps * 32), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Registers a thread, static shared bytes and resident blocks per SM of the
// fused kernel (one build serves every layout): out[0..2].
extern "C" int fused_layer_attrs(int* out) {
  static_assert(kWarps == walk::kBlockWarps, "fp_attributes' block size");
  return (int)walk::fp_attributes(fused_layer_kernel, out);
}
