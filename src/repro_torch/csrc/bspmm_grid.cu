// FRDC BSpMM over a 2D (row-block x feature-block) grid: the block-shape
// tunable SessionPlan.bspmm_block of the serving sessions.
//
// Replaces the Pallas TPU kernels repro/kernels/bspmm_kernel.py:
// _bspmm_bits_grid (_bits_grid_kernel) and _bspmm_fp_grid (_fp_grid_kernel).
// On the TPU one grid step owns `rows` output rows x one feature block and
// walks each of its tile-rows' grp_ptr ranges with a double-buffered DMA
// gather. Here one CTA owns the same block. Groups past grp_ptr[R] (pad_frdc
// bucket padding) are never visited, and a tile-row with no groups stores 0
// counts / 0.0, or sign(0) = +1 bits.
//
// Load balance (Flickr has a tile-row of 1,399 groups against a mean of 5):
// each warp takes the light tile-rows (at most kHeavy groups) round-robin
// and walks each whole, in group order, from registers. A heavy tile-row
// leaves the CTA in the fp grid: it is cut into chunk items of at most 16
// groups spread over the whole launch and added in chunk order
// (walk::fp_block). In the bits grid it is walked by all kWarps warps of
// the CTA together: warp k takes the k-th contiguous slice of its group
// range, the partial sums go to shared memory, and warp 0 adds them in warp
// order. Every output is a fixed sum in a fixed order, so two runs give the
// same bits.
//
// Binarize mode packs sign(count) per word, with the bits past n_feat % 32
// cleared in word n_feat / 32 only (the TPU grid masks that word in the
// block that holds it). Counts mode stores int32 counts.
// Bound on H100: bytes (group arrays, gathered rows, output), as for the 1D
// kernels; the arithmetic is a few operations per adjacency bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kHeavy = 32;  // groups a single warp walks alone
constexpr int kTile = walk::kTile;

__device__ __forceinline__ uint32_t tail_keep(int w, int n_feat) {
  return (n_feat % 32 && w == n_feat / 32) ? (1u << (n_feat % 32)) - 1u
                                           : walk::kFull;
}

__device__ __forceinline__ void store_bits(int32_t* out_counts,
                                           uint32_t* out_bits, size_t row0,
                                           int w, int wf, int lane,
                                           int binarize, int n_feat,
                                           const int acc[kTile]) {
  if (binarize) {
    const uint32_t keep = tail_keep(w, n_feat);
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const uint32_t word = walk::sign_word(acc[i], keep);
      if (lane == 0) out_bits[(row0 + i) * wf + w] = word;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kTile; ++i)
      out_counts[(row0 + i) * (size_t)wf * 32 + (size_t)w * 32 + lane] = acc[i];
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    bits_grid_kernel(const int32_t* __restrict__ grp_ptr,
                     const int32_t* __restrict__ tiles,
                     const int32_t* __restrict__ col_idx,
                     const uint32_t* __restrict__ x,
                     int32_t* __restrict__ out_counts,
                     uint32_t* __restrict__ out_bits, int n_tile_rows,
                     int tb_rows, int fbw, long long n_x_rows, int wf,
                     int n_feat, int binarize, int s2) {
  __shared__ int part[kWarps][kTile][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tr0 = blockIdx.x * tb_rows;
  const int tr1 = min(tr0 + tb_rows, n_tile_rows);
  const int w0 = blockIdx.y * fbw, w1 = min(w0 + fbw, wf);
  for (int tr = tr0 + warp; tr < tr1; tr += kWarps) {
    const int g0 = grp_ptr[tr], g1 = grp_ptr[tr + 1];
    if (g1 - g0 > kHeavy) continue;
    for (int w = w0; w < w1; ++w) {
      int acc[kTile] = {0, 0, 0, 0};
      walk::bits(tiles, col_idx, x, g0, g1, w, wf, n_x_rows, s2, lane, acc);
      store_bits(out_counts, out_bits, (size_t)tr * kTile, w, wf, lane,
                 binarize, n_feat, acc);
    }
  }
  for (int tr = tr0; tr < tr1; ++tr) {
    const int g0 = grp_ptr[tr], n_g = grp_ptr[tr + 1] - g0;
    if (n_g <= kHeavy) continue;  // uniform across the CTA
    const int per = (n_g + kWarps - 1) / kWarps;
    const int lo = g0 + min(warp * per, n_g), hi = g0 + min((warp + 1) * per, n_g);
    for (int w = w0; w < w1; ++w) {
      int acc[kTile] = {0, 0, 0, 0};
      walk::bits(tiles, col_idx, x, lo, hi, w, wf, n_x_rows, s2, lane, acc);
#pragma unroll
      for (int i = 0; i < kTile; ++i) part[warp][i][lane] = acc[i];
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          acc[i] = 0;
          for (int k = 0; k < kWarps; ++k) acc[i] += part[k][i][lane];
        }
        store_bits(out_counts, out_bits, (size_t)tr * kTile, w, wf, lane,
                   binarize, n_feat, acc);
      }
      __syncthreads();
    }
  }
}

// The fp grid: walk::fp_block with the plan's row and feature blocks; heavy
// tile-rows (more than kHeavy groups) leave their row CTA for chunk items
// spread over the whole launch.
template <int kSub, int kCols, bool kVec>
__global__ void __launch_bounds__(walk::kBlockWarps * 32)
    fp_grid_kernel(const walk::FpGrid a) {
  walk::fp_block<kSub, kCols, kVec>(a);
}

}  // namespace

// grid (n_rb, n_fb); out: (n_tile_rows*4, wf) words or (n_tile_rows*4,
// wf*32) int32 counts.
extern "C" int bspmm_bits_grid(const void* grp_ptr, const void* tiles,
                               const void* col_idx, const void* x, void* out,
                               int n_tile_rows, int tb_rows, int n_rb, int fbw,
                               int n_fb, long long n_x_rows, int wf,
                               int n_feat, int binarize, int s2,
                               void* stream) {
  if (n_rb > 0 && n_fb > 0 && wf > 0) {
    bits_grid_kernel<<<dim3(n_rb, n_fb), kWarps * 32, 0,
                       (cudaStream_t)stream>>>(
        (const int32_t*)grp_ptr, (const int32_t*)tiles,
        (const int32_t*)col_idx, (const uint32_t*)x, (int32_t*)out,
        (uint32_t*)out, n_tile_rows, tb_rows, fbw, n_x_rows, wf, n_feat,
        binarize, s2);
  }
  return (int)cudaGetLastError();
}

// out: (n_tile_rows*4, f) raw sums (no scales); scratch: ceil(n_groups /
// 16) * 2 * 4 * f floats; row_done: n_tile_rows * n_fb int32, zeroed here;
// (sub, cols, vec): the walk's lane layout for a feature block of fw
// columns.
extern "C" int bspmm_fp_grid(const void* grp_ptr, const void* group_row,
                             const void* tiles, const void* col_idx,
                             const void* x, void* out, void* scratch,
                             void* row_done, int n_tile_rows,
                             long long n_groups, int tb_rows, int n_rb, int fw,
                             int n_fb, long long n_x_rows, int f, int sub,
                             int cols, int vec, void* stream) {
  if (n_rb <= 0 || n_fb <= 0 || f <= 0) return (int)cudaGetLastError();
  const long long chunks = (n_groups + walk::kChunk - 1) / walk::kChunk;
  walk::FpGrid a{(const int32_t*)grp_ptr, (const int32_t*)group_row,
                 (const int32_t*)tiles, (const int32_t*)col_idx,
                 (const float*)x, (float*)out, (float*)scratch,
                 (int32_t*)row_done, n_x_rows, n_tile_rows,
                 (int)((chunks + walk::kBlockWarps - 1) / walk::kBlockWarps),
                 tb_rows, fw, f, kHeavy};
  const dim3 grid((unsigned)(a.n_chunk_blocks + n_rb), (unsigned)n_fb);
  const cudaError_t e = cudaMemsetAsync(
      row_done, 0, sizeof(int32_t) * n_tile_rows * n_fb, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)walk::with_fp_layout(sub, cols, vec, [&](auto s, auto c, auto v) {
    fp_grid_kernel<decltype(s)::value, decltype(c)::value, decltype(v)::value>
        <<<grid, walk::kBlockWarps * 32, 0, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  });
}

// Registers a thread, static shared bytes and resident blocks per SM of the
// fp grid kernel built for layout (sub, cols, vec): out[0..2].
extern "C" int bspmm_fp_grid_attrs(int sub, int cols, int vec, int* out) {
  return (int)walk::with_fp_layout(sub, cols, vec, [&](auto s, auto c, auto v) {
    return walk::fp_attributes(
        fp_grid_kernel<decltype(s)::value, decltype(c)::value, decltype(v)::value>,
        out);
  });
}
