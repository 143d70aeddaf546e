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
// Load balance (Flickr has a tile-row of 1,399 groups against a mean of 5;
// a serve bucket one of 1,074): each warp takes the light tile-rows (at most
// kBitsHeavy / kHeavy groups) round-robin and walks each whole, in group
// order. A heavy
// tile-row leaves its row CTA: it is cut into chunk items of at most 16
// groups spread over the whole launch and added in chunk order by the warp
// that finishes the row last (walk::split_block, the split of the 1D
// kernels). Every output is a fixed sum in a fixed order, so two runs give
// the same bits.
//
// The bits grid walks a feature block's words in passes of up to 4 words
// (walk::bits: one gather a lane and the register transpose); binarize mode
// packs sign(count) per word, with the bits past n_feat % 32 cleared in word
// n_feat / 32 only (the TPU grid masks that word in the block that holds
// it). Counts mode stores int32 counts.
// Bound on H100: bytes (group arrays, gathered rows, output), as for the 1D
// kernels; a word block of one word (feats = 32) walks every group once a
// word.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "walk.cuh"

namespace {

// groups a single warp walks alone: hub tile-rows split best at one chunk
// in the bits grid (tools/bits_variants.py), at 32 in the fp grid
// (tools/fp_variants.py)
constexpr int kBitsHeavy = walk::kChunk;
constexpr int kHeavy = 32;
constexpr int kThreads = walk::kBlockWarps * 32;

template <int kW, bool kS2>
__global__ void __launch_bounds__(kThreads, walk::bits_min_blocks(kW))
    bits_grid_kernel(const __grid_constant__ walk::BitsGrid a) {
  walk::bits_block<kW, kS2>(a);
}

template <int kSub, int kCols, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fp_grid_kernel(const __grid_constant__ walk::FpGrid a) {
  walk::fp_block<kSub, kCols, kVec>(a);
}

}  // namespace

// Blocks of tb_rows tile-rows x fbw words; out: (n_tile_rows*4, wf) words or
// (n_tile_rows*4, wf*32) int32 counts; scratch: ceil(n_groups / 16) * 2 * 4
// * wf * 32 int32; row_done: n_tile_rows * ceil(wf / fbw) int32, zeroed
// here.
extern "C" int bspmm_bits_grid(const void* grp_ptr, const void* group_row,
                               const void* tiles, const void* col_idx,
                               const void* x, void* out, void* scratch,
                               void* row_done, int n_tile_rows,
                               long long n_groups, int tb_rows, int fbw,
                               long long n_x_rows, int wf, int n_feat,
                               int binarize, int s2, void* stream) {
  if (n_tile_rows <= 0 || wf <= 0 || tb_rows <= 0 || fbw <= 0)
    return (int)cudaGetLastError();
  walk::BitsGrid a{{(const int32_t*)grp_ptr, (const int32_t*)group_row,
                    (int32_t*)row_done, n_tile_rows, 0, tb_rows, kBitsHeavy},
                   (const int32_t*)tiles, (const int32_t*)col_idx,
                   (const uint32_t*)x, (int32_t*)out, (int32_t*)scratch,
                   n_x_rows, wf, fbw, n_feat, binarize, 0};
  dim3 grid;
  const cudaError_t e = walk::bits_setup(&a, n_groups, &grid, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)walk::with_bits_pass(fbw, s2, [&](auto w, auto s) {
    bits_grid_kernel<decltype(w)::value, decltype(s)::value>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  });
}

// Registers a thread, static shared bytes and resident blocks per SM of the
// bits grid kernel built for blocks of `words` words and the formula s2:
// out[0..3].
extern "C" int bspmm_bits_grid_attrs(int words, int s2, int* out) {
  return (int)walk::with_bits_pass(words, s2, [&](auto w, auto s) {
    return launch::attributes(
        bits_grid_kernel<decltype(w)::value, decltype(s)::value>, kThreads, 0,
        out);
  });
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
  walk::FpGrid a{{(const int32_t*)grp_ptr, (const int32_t*)group_row,
                  (int32_t*)row_done, n_tile_rows, walk::chunk_blocks(n_groups),
                  tb_rows, kHeavy},
                 (const int32_t*)tiles, (const int32_t*)col_idx,
                 (const float*)x, (float*)out, (float*)scratch, n_x_rows, fw,
                 f};
  const dim3 grid((unsigned)(a.s.n_chunk_blocks + n_rb), (unsigned)n_fb);
  const cudaError_t e = cudaMemsetAsync(
      row_done, 0, sizeof(int32_t) * n_tile_rows * n_fb, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)walk::with_fp_layout(sub, cols, vec, [&](auto s, auto c, auto v) {
    fp_grid_kernel<decltype(s)::value, decltype(c)::value, decltype(v)::value>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  });
}

// Registers a thread, static shared bytes and resident blocks per SM of the
// fp grid kernel built for layout (sub, cols, vec): out[0..3].
extern "C" int bspmm_fp_grid_attrs(int sub, int cols, int vec, int* out) {
  return (int)walk::with_fp_layout(sub, cols, vec, [&](auto s, auto c, auto v) {
    return launch::attributes(
        fp_grid_kernel<decltype(s)::value, decltype(c)::value, decltype(v)::value>,
        kThreads, 0, out);
  });
}
