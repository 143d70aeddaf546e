// FRDC binary-sparse x dense aggregation: the paper's Algorithm 1 (packed
// +-1 activations) and its fp counterpart.
//
// Replaces the Pallas TPU kernels repro/kernels/bspmm_kernel.py:bspmm_bits
// (_bits_kernel, 1D grid) and bspmm_kernel.py:bspmm_fp (_fp_kernel, 1D grid).
//
// Work split. The TPU kernels walk every group on a sequential grid and
// flush a row on its last nonzero group. Here both kernels are
// walk::split_block with a warp per tile-row of at most kChunk (16) groups
// and 8 tile-rows a CTA; a longer tile-row is cut into 16-group chunk items
// in group space, which each warp finds from group_row and grp_ptr, so
// nothing is built before the launch and a power-law hub row (1,399 groups
// on Flickr, mean 5) is spread over the whole launch. The warp that takes a
// row's last ticket (an atomic after a __threadfence) adds its items'
// partial sums in chunk order and stores the row, so the result does not
// depend on which warp finishes when. Consequences the design relies on:
//   * a tile-row with no groups stores 0 counts / 0.0, and in binarize mode
//     sign(0) = +1 bits with the tail masked (the TPU prefill);
//   * pad_frdc bucket groups past grp_ptr[-1] are never visited;
//   * neighbour rows at or past the activation's row count read as 0, so x
//     needs no padding to a multiple of 4 rows (their adjacency bits are 0).
//
// bspmm_bits: the bits walk (walk::bits). Per group the tiles and col_idx
// are loaded and the four adjacency words built once for up to 4 feature
// words (Step 3); lane k gathers neighbour k's words in one 8- or 16-byte
// load where aligned (Step 2); each word's 32 x 32 bit block is transposed
// in registers by five __shfl_xor_sync rounds (Step 4, LSB-first, so no
// __brev), and lane f accumulates the trinary popc of feature f for the 4
// rows (Step 5): s3 = 2*popc(a & b) - popc(a), s2 = popc(a & b) -
// popc(a & ~b). Partial sums are int32, so any order gives the same bits.
// bspmm_fp: the edge-driven fp walk: per group a ballot finds the hit
// neighbour columns, and only those are gathered, with lanes on (neighbour,
// feature) pairs at small widths (walk.cuh).
// Column scales are folded into x and the row scale is applied by the
// caller. The walks and the split live in walk.cuh, shared with the 2D
// block grid (bspmm_grid.cu) and the fused layer (fused_layer.cu).
// Bound on H100: bytes for both (group arrays, gathered activations,
// output). The bits walk issues about 40 instructions a group and word
// (transpose and popc) besides its loads, so at Flickr's density it is held
// by issue and load latency before bytes; a pass of up to 4 words shares a
// group's index loads, adjacency words and gather.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "walk.cuh"

namespace {

constexpr int kThreads = walk::kBlockWarps * 32;
constexpr int kHeavy = walk::kChunk;  // groups a single warp walks alone

// Both 1D kernels: a warp per tile-row (tb_rows = kBlockWarps), the full
// width in one feature block, and tile-rows of more than kHeavy groups cut
// into chunk items.
template <int kW, bool kS2>
__global__ void __launch_bounds__(kThreads, walk::bits_min_blocks(kW))
    bspmm_bits_kernel(const __grid_constant__ walk::BitsGrid a) {
  walk::bits_block<kW, kS2>(a);
}

template <int kSub, int kCols, bool kVec>
__global__ void __launch_bounds__(kThreads)
    bspmm_fp_kernel(const __grid_constant__ walk::FpGrid a) {
  walk::fp_block<kSub, kCols, kVec>(a);
}

}  // namespace

// out: (n_tile_rows*4, wf) sign words or (n_tile_rows*4, wf*32) int32
// counts; scratch: ceil(n_groups / 16) * 2 * 4 * wf * 32 int32; row_done:
// n_tile_rows int32, zeroed here.
extern "C" int bspmm_bits(const void* grp_ptr, const void* group_row,
                          const void* tiles, const void* col_idx, const void* x,
                          void* out, void* scratch, void* row_done,
                          int n_tile_rows, long long n_groups,
                          long long n_x_rows, int wf, int n_feat, int binarize,
                          int s2, void* stream) {
  if (n_tile_rows <= 0 || wf <= 0) return (int)cudaGetLastError();
  walk::BitsGrid a{{(const int32_t*)grp_ptr, (const int32_t*)group_row,
                    (int32_t*)row_done, n_tile_rows, 0, walk::kBlockWarps,
                    kHeavy},
                   (const int32_t*)tiles, (const int32_t*)col_idx,
                   (const uint32_t*)x, (int32_t*)out, (int32_t*)scratch,
                   n_x_rows, wf, wf, n_feat, binarize, 0};
  dim3 grid;
  const cudaError_t e = walk::bits_setup(&a, n_groups, &grid, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)walk::with_bits_pass(wf, s2, [&](auto w, auto s) {
    bspmm_bits_kernel<decltype(w)::value, decltype(s)::value>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  });
}

// Registers a thread, static shared bytes and resident blocks per SM of the
// bits kernel built for rows of `words` words and the formula s2: out[0..3].
extern "C" int bspmm_bits_attrs(int words, int s2, int* out) {
  return (int)walk::with_bits_pass(words, s2, [&](auto w, auto s) {
    return launch::attributes(
        bspmm_bits_kernel<decltype(w)::value, decltype(s)::value>, kThreads, 0,
        out);
  });
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
  walk::FpGrid a{{(const int32_t*)grp_ptr, (const int32_t*)group_row,
                  (int32_t*)row_done, n_tile_rows,
                  walk::chunk_blocks(n_groups), kWarps, kHeavy},
                 (const int32_t*)tiles, (const int32_t*)col_idx,
                 (const float*)x, (float*)out, (float*)scratch, n_x_rows, f,
                 f};
  const unsigned blocks =
      (unsigned)(a.s.n_chunk_blocks + (n_tile_rows + kWarps - 1) / kWarps);
  const cudaError_t e = cudaMemsetAsync(row_done, 0, sizeof(int32_t) * n_tile_rows,
                                        (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)walk::with_fp_layout(sub, cols, vec, [&](auto s, auto c, auto v) {
    bspmm_fp_kernel<decltype(s)::value, decltype(c)::value, decltype(v)::value>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  });
}

// Registers a thread, static shared bytes and resident blocks per SM of the
// fp kernel built for layout (sub, cols, vec): out[0..3].
extern "C" int bspmm_fp_attrs(int sub, int cols, int vec, int* out) {
  return (int)walk::with_fp_layout(sub, cols, vec, [&](auto s, auto c, auto v) {
    return launch::attributes(
        bspmm_fp_kernel<decltype(s)::value, decltype(c)::value, decltype(v)::value>,
        kThreads, 0, out);
  });
}
