// FRDC binary-sparse x dense aggregation: the paper's Algorithm 1 (packed
// +-1 activations) and its fp counterpart.
//
// Replaces the Pallas TPU kernels repro/kernels/bspmm_kernel.py:bspmm_bits
// (_bits_kernel, 1D grid) and bspmm_kernel.py:bspmm_fp (_fp_kernel, 1D grid).
//
// Work split. The TPU kernels walk every group on a sequential grid and
// flush a row on its last nonzero group. Here work items are at most
// `chunk` (16) consecutive groups of one tile-row (4 output rows), so a
// power-law hub row is spread over many warps instead of serialising the
// launch on one. A row with one item stores its result directly. A row with
// several items stores per-item partial sums to `scratch`; the warp that
// finishes last (an atomic ticket per row, after a __threadfence) adds the
// partials in item order and stores the row, so the result does not depend
// on which warp finishes when. Consequences the design relies on:
//   * a tile-row with no groups stores 0 counts / 0.0, and in binarize mode
//     sign(0) = +1 bits with the tail masked (the TPU prefill);
//   * pad_frdc bucket groups past grp_ptr[-1] are never visited;
//   * neighbour rows at or past the activation's row count read as 0, so x
//     needs no padding to a multiple of 4 rows (their adjacency bits are 0).
//
// bspmm_bits: a warp per item of item_ptr (R+1 entries, built by the
// caller: max(1, ceil(groups / chunk)) items a tile-row). Per group and per
// feature word w (Steps 2-5):
//   lane k loads neighbour word x[col_idx[g, k/4]*4 + k%4, w];
//   the 8 tiles are OR-reduced into 4 adjacency words (Step 3);
//   32 __ballot_sync calls transpose the 32x32 bit block, lane f keeping
//   ballot f, whose bit k is neighbour k's bit of feature w*32+f (Step 4).
//   Bits are LSB-first, so no __brev is needed;
//   lane f accumulates the trinary popc for the 4 rows (Step 5):
//   s3 = 2*popc(a & b) - popc(a), s2 = popc(a & b) - popc(a & ~b).
// bspmm_fp: walk::fp_block with a warp per tile-row of at most 16 groups;
// a longer one is cut into chunk items in group space that each warp finds
// from group_row and grp_ptr, so nothing is built before the launch. The
// walk is edge-driven: per group a ballot finds the hit neighbour columns,
// and only those are gathered, with lanes on (neighbour, feature) pairs at
// small widths (walk.cuh).
// Column scales are folded into x and the row scale is applied by the
// caller. Both group walks live in walk.cuh, shared with the 2D block grid
// (bspmm_grid.cu) and the fused layer (fused_layer.cu).
// Bound on H100: bytes for both (group arrays, gathered activations,
// output); the arithmetic is a few operations per adjacency bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

constexpr unsigned kFull = walk::kFull;
constexpr int kWarpsPerBlock = 8;
constexpr int kTile = walk::kTile;

struct Item {
  int row;    // tile-row
  int g0;     // first group
  int g1;     // one past the last group
  int first;  // first item of the row
  int count;  // items of the row
};

// Warp `w`'s item: the tile-row r with item_ptr[r] <= w < item_ptr[r+1].
__device__ __forceinline__ bool find_item(const int32_t* __restrict__ item_ptr,
                                          const int32_t* __restrict__ grp_ptr,
                                          int n_tile_rows, int chunk, long long w,
                                          Item* it) {
  if (w >= item_ptr[n_tile_rows]) return false;
  int lo = 0, hi = n_tile_rows;  // invariant: item_ptr[lo] <= w < item_ptr[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (item_ptr[mid] <= w) lo = mid; else hi = mid;
  }
  it->row = lo;
  it->first = item_ptr[lo];
  it->count = item_ptr[lo + 1] - it->first;
  const int g_end = grp_ptr[lo + 1];
  it->g0 = grp_ptr[lo] + (int)(w - it->first) * chunk;
  it->g1 = min(it->g0 + chunk, g_end);
  return true;
}

__global__ void bspmm_bits_kernel(const int32_t* __restrict__ item_ptr,
                                  const int32_t* __restrict__ grp_ptr,
                                  const int32_t* __restrict__ tiles,
                                  const int32_t* __restrict__ col_idx,
                                  const uint32_t* __restrict__ x,
                                  int32_t* __restrict__ out_counts,
                                  uint32_t* __restrict__ out_bits,
                                  int32_t* scratch, int32_t* row_done,
                                  int n_tile_rows, int chunk, int n_x_rows,
                                  int wf, int n_feat, int binarize, int s2) {
  const int lane = threadIdx.x & 31;
  const long long w_id =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  Item it;
  if (!find_item(item_ptr, grp_ptr, n_tile_rows, chunk, w_id, &it)) return;
  const int width = wf * 32;
  const size_t out_row = (size_t)it.row * kTile;
  const bool single = it.count == 1;
  for (int w = 0; w < wf; ++w) {
    int acc[kTile] = {0, 0, 0, 0};
    walk::bits(tiles, col_idx, x, it.g0, it.g1, w, wf, n_x_rows, s2, lane, acc);
    if (!single) {
      int32_t* part = scratch + (size_t)w_id * kTile * width;
#pragma unroll
      for (int i = 0; i < kTile; ++i) part[i * width + w * 32 + lane] = acc[i];
      continue;
    }
    if (binarize) {
      const bool tail = (w == wf - 1) && (n_feat % 32);
      const uint32_t keep = tail ? (1u << (n_feat % 32)) - 1u : kFull;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const uint32_t word = walk::sign_word(acc[i], keep);
        if (lane == 0) out_bits[(out_row + i) * wf + w] = word;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        out_counts[(out_row + i) * width + (size_t)w * 32 + lane] = acc[i];
    }
  }
  if (single || !walk::last_arrival(row_done + it.row, it.count, lane))
    return;
  for (int w = 0; w < wf; ++w) {
    int acc[kTile] = {0, 0, 0, 0};
    for (int k = 0; k < it.count; ++k) {
      const int32_t* part = scratch + (size_t)(it.first + k) * kTile * width;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        acc[i] += __ldcg(part + i * width + w * 32 + lane);
    }
    if (binarize) {
      const bool tail = (w == wf - 1) && (n_feat % 32);
      const uint32_t keep = tail ? (1u << (n_feat % 32)) - 1u : kFull;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const uint32_t word = walk::sign_word(acc[i], keep);
        if (lane == 0) out_bits[(out_row + i) * wf + w] = word;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        out_counts[(out_row + i) * width + (size_t)w * 32 + lane] = acc[i];
    }
  }
}

// The fp aggregation: walk::fp_block with one warp a tile-row (tb_rows =
// kBlockWarps), the full width in one feature block, and heavy tile-rows
// (more than kChunk groups) cut into items of at most kChunk groups.
template <int kSub, int kCols, bool kVec>
__global__ void __launch_bounds__(walk::kBlockWarps * 32)
    bspmm_fp_kernel(const walk::FpGrid a) {
  walk::fp_block<kSub, kCols, kVec>(a);
}

unsigned blocks_for(long long n_warps) {
  return (unsigned)((n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// item_ptr: (R+1,) int32; max_items: an upper bound of item_ptr[R] (the
// grid size); scratch: max_items * 4 * (wf*32) int32; row_done: R zeros.
extern "C" int bspmm_bits(const void* item_ptr, const void* grp_ptr,
                          const void* tiles, const void* col_idx, const void* x,
                          void* out, void* scratch, void* row_done,
                          int n_tile_rows, long long max_items, int chunk,
                          int n_x_rows, int wf, int n_feat, int binarize,
                          int s2, void* stream) {
  if (n_tile_rows > 0 && wf > 0 && max_items > 0) {
    bspmm_bits_kernel<<<blocks_for(max_items), kWarpsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t*)item_ptr, (const int32_t*)grp_ptr,
        (const int32_t*)tiles, (const int32_t*)col_idx, (const uint32_t*)x,
        (int32_t*)out, (uint32_t*)out, (int32_t*)scratch, (int32_t*)row_done,
        n_tile_rows, chunk, n_x_rows, wf, n_feat, binarize, s2);
  }
  return (int)cudaGetLastError();
}

// scratch: ceil(n_groups / 16) * 2 * 4 * f floats; row_done: R int32,
// zeroed here; (sub, cols, vec): the walk's lane layout (walk::FpLanes).
extern "C" int bspmm_fp(const void* grp_ptr, const void* group_row,
                        const void* tiles, const void* col_idx, const void* x,
                        void* out, void* scratch, void* row_done,
                        int n_tile_rows, long long n_groups, long long n_x_rows,
                        int f, int sub, int cols, int vec, void* stream) {
  if (n_tile_rows <= 0 || f <= 0) return (int)cudaGetLastError();
  constexpr int kWarps = walk::kBlockWarps;  // a warp per tile-row
  const long long chunks = (n_groups + walk::kChunk - 1) / walk::kChunk;
  walk::FpGrid a{(const int32_t*)grp_ptr, (const int32_t*)group_row,
                 (const int32_t*)tiles, (const int32_t*)col_idx,
                 (const float*)x, (float*)out, (float*)scratch,
                 (int32_t*)row_done, n_x_rows, n_tile_rows,
                 (int)((chunks + kWarps - 1) / kWarps), kWarps, f, f,
                 walk::kChunk};
  const unsigned blocks =
      (unsigned)(a.n_chunk_blocks + (n_tile_rows + kWarps - 1) / kWarps);
  const cudaError_t e = cudaMemsetAsync(row_done, 0, sizeof(int32_t) * n_tile_rows,
                                        (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)walk::with_fp_layout(sub, cols, vec, [&](auto s, auto c, auto v) {
    bspmm_fp_kernel<decltype(s)::value, decltype(c)::value, decltype(v)::value>
        <<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  });
}

// Registers a thread, static shared bytes and resident blocks per SM of the
// fp kernel built for layout (sub, cols, vec): out[0..2].
extern "C" int bspmm_fp_attrs(int sub, int cols, int vec, int* out) {
  return (int)walk::with_fp_layout(sub, cols, vec, [&](auto s, auto c, auto v) {
    return walk::fp_attributes(
        bspmm_fp_kernel<decltype(s)::value, decltype(c)::value, decltype(v)::value>,
        out);
  });
}
