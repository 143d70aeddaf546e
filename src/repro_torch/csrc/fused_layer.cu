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
//   fc           BN -> quantize_act -> BMM.BBF: no aggregation, so it is an
//                ordinary launch of its own over rows (fused_fc, at the
//                end of this file).
//
// Aggregation needs every row's transform first, so fused_layer_kernel is
// launched cooperatively (all blocks resident, grid sized from the
// occupancy with the launch's dynamic shared memory) and runs two
// grid-stride phases separated by one grid-wide barrier:
//   1. transform: one block per row tile.
//      BMM.FBB (gcn_bin_l1): a register-tiled fp32 GEMM of 192 rows x 64
//      columns a tile pass, 12 x 4 outputs a thread. Chunks of 32 features
//      of x come into shared memory by cp.async, one ahead of their use
//      over the block's tiles, BN (x - mu) / sd is applied there once an
//      element, and the chunk's weight word of each column is expanded to
//      +-scale floats (mu, sd and the weights sit in shared memory). Each
//      output's sum is one fmaf chain in k order from 0, so the sign words
//      do not depend on the tiling.
//      BMM.BBF (the other kinds): quantize_act from a cp.async stream of
//      32-feature chunks (64 rows a tile, a warp 8 rows; mean |z| as lane
//      partials in k order, then the butterfly) into a shared tile of sign
//      words and row scales, or packed input words with unit scales; the
//      weights (and the self branch's) are staged in shared memory once a
//      block (in chunks of 32 words and 64 columns past that) and
//      multiplied with the mma tile of xnor.cuh (b1 tensor-core AND-popc),
//      then scaled as (count * row scale) * weight scale [* column scale].
//      The phase also zeroes the heavy rows' tickets; the barrier orders
//      them before the first item.
//   2. aggregate and store: the task walk of tasks.cuh over the one matrix,
//      a warp a task of the list built once a plan (kernels/fused_layer.py
//      pair_items). A light tile-row (at most `chunk` groups) walks its
//      groups (walk.cuh; the counts walk takes up to 4 words of y a pass,
//      with the register bit transpose) and applies the epilogue in
//      registers: the row scale, the self branch and the ReLU, or the sign
//      (with the tail bits past the width cleared). Each item of a heavy
//      row stores its partial sums to scratch (sized by the list's heavy
//      count); the warp with the row's last ticket adds them in item order
//      and stores the row. The association is that of the two-barrier
//      kernel it replaced (items of `chunk` groups from the row's first,
//      each summed from 0, the row from +0.0f in item order), so the
//      outputs are bit-equal to it.
// With aggregate = 0 the kernel stops after phase 1: the sharded steps'
// transform alone, the rows the executors exchange, written without the
// column scale (and, with w_s, the self branch's product to ys). Their pair
// step then aggregates it with fused_pair.cu, the same task walk over an
// intra and a halo matrix. bn_rcp takes BN as
// (x - mu) * (1 / sd), the executors' apply_bn, where the single-host kinds
// divide; fc takes either form.
// Every sum has a fixed order, so two runs give the same bits. The scratch
// (transform output, partials, tickets) comes from the caller's torch.empty.
// Bound on H100: BMM.FBB is 2 F H fp32 operations a row (89,252 x 500 x 64
// fma at the serve bucket, 0.085 ms at 67 TFLOP/s, against 0.053 ms for
// the 178.5 MB of x), so gcn_bin_l1 is bound by operations; the BBF kinds
// by the bytes of x and of their fp outputs. In both, BN's IEEE division
// (kept so that z is bit-identical to the unfused BN) costs about a fifth
// of the transform.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "tasks.cuh"
#include "walk.cuh"
#include "xnor.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWords = 128;  // input width <= 4096 features
constexpr int kMaxChunks = 8;   // output width <= 256
constexpr unsigned kFull = walk::kFull;
// BMM.FBB tile: 16 x 16 threads, 12 rows x 4 columns each (8 rows: 4-8%
// slower at the serve bucket, tools/xform_variants.py)
constexpr int kFbbRM = 12, kFbbRN = 4;
constexpr int kFbbRows = 16 * kFbbRM;   // 192
constexpr int kFbbCols = 16 * kFbbRN;   // 64 a pass
// chunks of fp input rows staged by cp.async
constexpr int kChunk = 32;              // features a chunk
constexpr int kChunkLd = kChunk + 4;    // floats between staged rows
// BMM.BBF tile: 4 x 2 warps of xnor.cuh's mma tile (16 rows x 64 columns)
constexpr int kBbfRows = 4 * xnor::kMmaRows;   // 64
constexpr int kBbfCols = xnor::kMmaCols;       // 64 a pass
constexpr int kBbfStages = 4;                  // fp chunks: 3 in flight
static_assert(kThreads == xnor::kThreads && kWarps == 8, "4 x 2 warps");

struct Params {
  // transform input: fp rows x (with BN when mu != null) or packed words xw
  const float* x;
  const uint32_t* xw;
  const float* mu;
  const float* sd;
  long long n_in;
  int f;   // input features (bits of the weights' contraction)
  int wk;  // words of f
  int bn_rcp;  // sd holds 1 / sd: z = (x - mu) * sd (the sharded steps)
  // weights: packed W.T (ho, wk) and per-output scales; w_s/s_s: self branch
  const uint32_t* w_a;
  const float* s_a;
  const uint32_t* w_s;
  const float* s_s;
  int ho;
  int fbb;        // BMM.FBB + BSpMM.BBB (gcn_bin_l1)
  int aggregate;  // 0: the transform alone (the sharded steps)
  int s2;
  int relu;
  // adjacency
  const int32_t* grp_ptr;
  const int32_t* tiles;
  const int32_t* col_idx;
  const float* row_scale;
  const float* col_scale;
  int n_tile_rows;
  long long n_rows;
  int chunk;
  // (n_tasks, 2): (tile-row, -1) for a light row, (tile-row, k) for item k
  // of a heavy row; the n_part heavy tasks first (tasks.cuh)
  const int32_t* tasks;
  int32_t* row_done;  // (n_tile_rows) tickets, zeroed in phase 1
  int n_tasks;
  int n_part;
  // scratch and output
  void* y;      // (n_in, ho) float, or (n_in, ceil(ho/32)) words when fbb
  float* ys;    // (n_in, ho) self branch
  void* part;   // (n_part, 4, width) partial sums
  void* out;    // (n_rows, ho) float, or (n_rows, ceil(ho/32)) words
  // the fp aggregation's lane layout (walk::FpLanes), from the wrapper
  int fp_sub;
  int fp_cols;
  int fp_vec;
};

// Dynamic shared memory of the transform phase for f input features, in
// BMM.FBB or BMM.BBF (with or without the self branch's weights).
int transform_smem(int f, bool fbb, bool self_branch) {
  const int wk = (f + 31) / 32;
  if (fbb)
    return 4 * (2 * kFbbRows * kChunkLd + kChunk * kFbbCols +
                2 * ((f + 3) & ~3) + kFbbCols * (wk + 1));
  const int kw = wk < xnor::kKWords ? wk : xnor::kKWords;
  return 4 * (kBbfStages * kBbfRows * kChunkLd + kBbfRows * (xnor::pad_ld(wk) + 1) +
              2 * kBbfCols + (self_branch ? 2 : 1) * kBbfCols * xnor::pad_ld(kw));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Start copying features [k0, k0 + kChunk) of rows r0 .. r0 + rows of x
// into xb (stride kChunkLd): 16 bytes a copy where rows and x are 16-byte
// aligned.
__device__ __forceinline__ void load_chunk(const Params& p, float* xb,
                                           long long r0, int rows, int k0,
                                           bool vec, int tid) {
  const int kn = min(kChunk, p.f - k0);
  if (vec) {
    for (int e = tid; e < rows * (kChunk / 4); e += kThreads) {
      const int r = e / (kChunk / 4), q = (e % (kChunk / 4)) * 4;
      if (q < kn) cp_async16(xb + r * kChunkLd + q, p.x + (r0 + r) * p.f + k0 + q);
    }
  } else {
    for (int e = tid; e < rows * kChunk; e += kThreads) {
      const int r = e / kChunk, k = e % kChunk;
      if (k < kn) cp_async4(xb + r * kChunkLd + k, p.x + (r0 + r) * p.f + k0 + k);
    }
  }
}

// Phase 1, BMM.FBB: y's sign words of sum_k z_k * (+-s_j), every sum one
// fmaf chain in k order from 0 (thread (tx, ty) holds rows ty + 16 i and
// columns tx * 4 + j of the pass). The block's chunks of x, over its tiles
// and passes, come in by cp.async one ahead of their use.
template <bool kRcp>
__device__ void transform_fbb(const Params& p, float* smem) {
  const int f4 = (p.f + 3) & ~3;
  float* xs = smem;                            // [2][kFbbRows][kChunkLd]
  float* ws = smem + 2 * kFbbRows * kChunkLd;  // [kChunk][kFbbCols]
  float* mus = ws + kChunk * kFbbCols;         // [f4] BN mean
  float* sds = mus + f4;                       // [f4] BN sd
  float* sc = sds + f4;                        // [kFbbCols] the pass's scales
  uint32_t* wt = (uint32_t*)(sc + kFbbCols);   // [wk][kFbbCols] its words
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int wh = (p.ho + 31) / 32;
  const long long n_tiles = (p.n_in + kFbbRows - 1) / kFbbRows;
  const int n_kc = (p.f + kChunk - 1) / kChunk;
  const bool vec = (p.f & 3) == 0 && ((uintptr_t)p.x & 15) == 0;
  uint32_t* y = (uint32_t*)p.y;
  auto tile_rows = [&](long long t) {
    return (int)min((long long)kFbbRows, p.n_in - t * kFbbRows);
  };
  if (blockIdx.x >= n_tiles) return;
  load_chunk(p, xs, blockIdx.x * kFbbRows, tile_rows(blockIdx.x), 0, vec, tid);
  // BN statistics and the weights in shared memory, so that no barrier
  // waits on a global load: mu and sd once a block, the words (transposed,
  // word w of column c at wt[w * 64 + c]) and scales of a pass's columns
  // before its first chunk (every read of the last pass's was before a
  // barrier every thread has passed)
  if (p.mu)
    for (int k = tid; k < p.f; k += kThreads) {
      mus[k] = p.mu[k];
      sds[k] = p.sd[k];
    }
  int step = 0;  // chunks of the stream so far: chunk `step` is in xs[step & 1]
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long r0 = t * kFbbRows;
    const int rows = tile_rows(t);
    for (int c0 = 0; c0 < p.ho; c0 += kFbbCols) {
      if (t == blockIdx.x || p.ho > kFbbCols) {
        for (int e = tid; e < p.wk * kFbbCols; e += kThreads) {
          const int w = e / kFbbCols, col = c0 + e % kFbbCols;
          wt[e] = col < p.ho ? p.w_a[(size_t)col * p.wk + w] : 0u;
        }
        if (tid < kFbbCols) sc[tid] = c0 + tid < p.ho ? p.s_a[c0 + tid] : 0.f;
      }
      float acc[kFbbRM][kFbbRN];
#pragma unroll
      for (int i = 0; i < kFbbRM; ++i)
#pragma unroll
        for (int j = 0; j < kFbbRN; ++j) acc[i][j] = 0.f;
      for (int kc = 0; kc < n_kc; ++kc, ++step) {
        const int k0 = kc * kChunk, kn = min(kChunk, p.f - k0);
        float* xb = xs + (step & 1) * kFbbRows * kChunkLd;
        cp_async_wait_all();
        __syncthreads();  // chunk `step` is in; every thread is past step - 1
        float* next = xs + ((step + 1) & 1) * kFbbRows * kChunkLd;
        if (kc + 1 < n_kc)
          load_chunk(p, next, r0, rows, k0 + kChunk, vec, tid);
        else if (c0 + kFbbCols < p.ho)
          load_chunk(p, next, r0, rows, 0, vec, tid);
        else if (t + gridDim.x < n_tiles)
          load_chunk(p, next, r0 + (long long)gridDim.x * kFbbRows,
                     tile_rows(t + gridDim.x), 0, vec, tid);
        if (p.mu) {  // BN once an element: z = (x - mu) / sd, or * (1 / sd)
          const int k = tid & 31;
          if (k < kn) {
            const float mu = mus[k0 + k], sd = sds[k0 + k];
            for (int r = tid >> 5; r < rows; r += kWarps) {
              const float d = xb[r * kChunkLd + k] - mu;
              xb[r * kChunkLd + k] = kRcp ? d * sd : d / sd;
            }
          }
        }
        {  // the chunk is word kc of each column's weights: +s_j where the
           // bit is 1, else -s_j
          const int c = tid & (kFbbCols - 1);
          const uint32_t word = wt[kc * kFbbCols + c];
          const float sj = sc[c];
          for (int k = tid / kFbbCols; k < kn; k += kThreads / kFbbCols)
            ws[k * kFbbCols + c] = __uint_as_float(
                __float_as_uint(sj) ^ ((~(word >> k) & 1u) << 31));
        }
        __syncthreads();
        int k = 0;
        for (; k + 4 <= kn; k += 4) {
          float4 w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            w[q] = *(const float4*)(ws + (k + q) * kFbbCols + tx * kFbbRN);
#pragma unroll
          for (int i = 0; i < kFbbRM; ++i) {
            const float4 z = *(const float4*)(xb + (ty + 16 * i) * kChunkLd + k);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float zq = q == 0 ? z.x : q == 1 ? z.y : q == 2 ? z.z : z.w;
              acc[i][0] = fmaf(zq, w[q].x, acc[i][0]);
              acc[i][1] = fmaf(zq, w[q].y, acc[i][1]);
              acc[i][2] = fmaf(zq, w[q].z, acc[i][2]);
              acc[i][3] = fmaf(zq, w[q].w, acc[i][3]);
            }
          }
        }
        for (; k < kn; ++k) {
          const float4 w = *(const float4*)(ws + k * kFbbCols + tx * kFbbRN);
#pragma unroll
          for (int i = 0; i < kFbbRM; ++i) {
            const float zk = xb[(ty + 16 * i) * kChunkLd + k];
            acc[i][0] = fmaf(zk, w.x, acc[i][0]);
            acc[i][1] = fmaf(zk, w.y, acc[i][1]);
            acc[i][2] = fmaf(zk, w.z, acc[i][2]);
            acc[i][3] = fmaf(zk, w.w, acc[i][3]);
          }
        }
      }
      // signs: a nibble a thread and row, OR-ed over the 8 threads of a word
      const int wd = c0 / 32 + (tx >> 3);
#pragma unroll
      for (int i = 0; i < kFbbRM; ++i) {
        uint32_t nib = 0u;
#pragma unroll
        for (int j = 0; j < kFbbRN; ++j)
          nib |= (uint32_t)(c0 + tx * kFbbRN + j < p.ho && acc[i][j] >= 0.f) << j;
        uint32_t word = nib << ((tx & 7) * kFbbRN);
        word |= __shfl_xor_sync(kFull, word, 1);
        word |= __shfl_xor_sync(kFull, word, 2);
        word |= __shfl_xor_sync(kFull, word, 4);
        const int r = ty + 16 * i;
        if ((tx & 7) == 0 && r < rows && wd < wh) y[(r0 + r) * wh + wd] = word;
      }
    }
  }
}

// Phase 1, BMM.BBF: y (and ys) or, without aggregation, out.
// quantize_act: chunks of 32 features of the tile's rows stream in by
// cp.async, three ahead of their use across the block's tiles (a chunk is
// 8 KB; fewer in flight leave the loads latency-bound); warp w takes rows
// w, w + 8, ...: per row, lane k % 32 adds
// its |z| in k order, one ballot gives the chunk's sign word, and the row
// scale is warp_sum of the partials over f. Packed input words are staged
// with unit scales. The products are mma tiles of xnor.cuh: warp w takes
// rows (w % 4) * 16 .. + 16 of the tile; with a self branch warps 4-7
// multiply w_s, else they take the column n-tiles 4-7 of the pass.
template <bool kRcp>
__device__ void transform_bbf(const Params& p, uint32_t* smem) {
  constexpr int kRowsPerWarp = kBbfRows / kWarps;
  const int lda = xnor::pad_ld(p.wk);
  const int kwc = min(p.wk, xnor::kKWords), ldb = xnor::pad_ld(kwc);
  float* xs = (float*)smem;                 // [kBbfStages][kBbfRows][kChunkLd]
  uint32_t* as = (uint32_t*)(xs + kBbfStages * kBbfRows * kChunkLd);  // [kBbfRows][lda]
  float* xsc = (float*)(as + kBbfRows * lda);       // [kBbfRows] row scales
  int* pbs = (int*)(xsc + kBbfRows);                // [2][kBbfCols] popc(w)
  uint32_t* ba = (uint32_t*)(pbs + 2 * kBbfCols);   // [kBbfCols][ldb]
  uint32_t* bself = ba + kBbfCols * ldb;            // [kBbfCols][ldb]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = warp & 3, half = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const bool self = p.w_s && half;                  // this warp's weights
  const int nt0 = p.w_s ? 0 : half * 4, nt1 = p.w_s ? 8 : half * 4 + 4;
  const int wk4 = (p.wk + 3) & ~3;
  const int n_cc = (p.ho + kBbfCols - 1) / kBbfCols;
  const int n_kc = (p.wk + xnor::kKWords - 1) / xnor::kKWords;
  const int n_xc = (p.f + kChunk - 1) / kChunk;    // chunks of an fp row
  const bool resident = n_cc == 1 && n_kc == 1;  // weights staged once
  const bool vec = (p.f & 3) == 0 && ((uintptr_t)p.x & 15) == 0;
  const bool vec_x = (p.wk & 3) == 0 && ((uintptr_t)p.xw & 15) == 0;
  const bool vec_w = (p.wk & 3) == 0 && ((uintptr_t)p.w_a & 15) == 0 &&
                     ((uintptr_t)p.w_s & 15) == 0;
  const long long n_tiles = (p.n_in + kBbfRows - 1) / kBbfRows;
  // the block's fp chunks, tile after tile, form one stream: chunk s sits
  // in stage s % kBbfStages, and kBbfStages - 1 chunks are in flight
  const int total = (p.x && blockIdx.x < n_tiles)
      ? (int)((n_tiles - 1 - blockIdx.x) / gridDim.x + 1) * n_xc : 0;
  auto load = [&](int s) {  // one commit group a chunk, empty past the end
    if (s < total) {
      const int tile = s / n_xc, kc = s - tile * n_xc;
      const long long r0 =
          ((long long)blockIdx.x + (long long)gridDim.x * tile) * kBbfRows;
      load_chunk(p, xs + (s % kBbfStages) * kBbfRows * kChunkLd, r0,
                 (int)min((long long)kBbfRows, p.n_in - r0), kc * kChunk, vec,
                 tid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // this lane's BN feature of a chunk, fetched one chunk ahead
  float mu_n = 0.f, sd_n = 1.f;
  auto fetch = [&](int kc) {
    const int k = kc * kChunk + lane;
    if (p.mu && k < p.f) {
      mu_n = p.mu[k];
      sd_n = p.sd[k];
    }
  };
  if (total > 0) {
    for (int s = 0; s < kBbfStages - 1; ++s) load(s);
    fetch(0);
  }
  int step = 0;  // chunks of the stream so far
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long r0 = t * kBbfRows;
    const int rows = (int)min((long long)kBbfRows, p.n_in - r0);
    if (p.x) {
      float sabs[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) sabs[i] = 0.f;
      for (int kc = 0; kc < n_xc; ++kc, ++step) {
        const float* xb = xs + (step % kBbfStages) * kBbfRows * kChunkLd;
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kBbfStages - 2));
        __syncthreads();  // chunk `step` is in; every thread is past step - 1
        load(step + kBbfStages - 1);
        const int k = kc * kChunk + lane;
        const bool in = k < p.f;
        const float mu = mu_n, sd = sd_n;
        fetch(kc + 1 < n_xc ? kc + 1 : 0);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = warp + kWarps * i;
          if (r >= rows) break;  // uniform across the warp
          float z = in ? xb[r * kChunkLd + lane] : 0.f;
          if (in) {
            if (p.mu) z = kRcp ? (z - mu) * sd : (z - mu) / sd;
            sabs[i] += fabsf(z);
          }
          const uint32_t word = __ballot_sync(kFull, in && z >= 0.f);
          if (lane == 0) as[r * lda + kc] = word;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        if (r >= rows) break;
        const float s = warp_sum(sabs[i]) / (float)p.f;
        if (lane == 0) xsc[r] = s;
        for (int w = p.wk + lane; w < wk4; w += 32) as[r * lda + w] = 0u;
      }
    } else {
      xnor::stage_rows(as, lda, p.xw, r0, p.n_in, kBbfRows, p.wk, 0, p.wk,
                       wk4, vec_x, tid);
      if (tid < kBbfRows) xsc[tid] = 1.f;
    }
    const int my_rows = max(0, min(xnor::kMmaRows, rows - slice * xnor::kMmaRows));
    for (int cc = 0; cc < n_cc; ++cc) {
      const int c0 = cc * kBbfCols;
      const int n_t = max(0, min((min(kBbfCols, p.ho - c0) + 7) / 8, nt1) - nt0);
      int acc[xnor::kMmaCols / 8][4] = {};
      int pa[2] = {0, 0};
      for (int kc = 0; kc < n_kc; ++kc) {
        const int w0 = kc * xnor::kKWords, kw = min(xnor::kKWords, p.wk - w0);
        if (!resident || t == blockIdx.x) {
          // zero past kw up to a whole mma step, as mma_popc takes B
          const int kw8 = (kw + xnor::kMmaStep - 1) / xnor::kMmaStep * xnor::kMmaStep;
          xnor::stage_rows(ba, ldb, p.w_a, c0, p.ho, kBbfCols, p.wk, w0, kw, kw8,
                           vec_w, tid);
          if (p.w_s)
            xnor::stage_rows(bself, ldb, p.w_s, c0, p.ho, kBbfCols, p.wk, w0,
                             kw, kw8, vec_w, tid);
          if (kc == 0)  // column popcounts over the whole K
            for (int e = tid; e < 2 * kBbfCols; e += kThreads) {
              const uint32_t* w = e < kBbfCols ? p.w_a : p.w_s;
              const int col = c0 + e % kBbfCols;
              int s = 0;
              if (w && col < p.ho)
                for (int i = 0; i < p.wk; ++i) s += __popc(w[(size_t)col * p.wk + i]);
              pbs[e] = s;
            }
        }
        __syncthreads();
        if (n_t > 0)
          xnor::mma_popc(as + slice * xnor::kMmaRows * lda + w0, lda, my_rows,
                         kw, (self ? bself : ba) + nt0 * 8 * ldb, ldb, n_t, lane,
                         acc, pa);
        if (!resident) __syncthreads();  // before the weights are restaged
      }
      float xr[2], cs[2];
      long long row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pa[h] += __shfl_xor_sync(kFull, pa[h], 1);
        pa[h] += __shfl_xor_sync(kFull, pa[h], 2);
        const int r = slice * xnor::kMmaRows + g + 8 * h;
        row[h] = r < rows ? r0 + r : -1;
        xr[h] = r < rows ? xsc[r] : 0.f;
        cs[h] = (r < rows && !self && p.aggregate && p.col_scale)
                    ? p.col_scale[r0 + r] : 1.f;
      }
      const int* pb = pbs + (self ? kBbfCols : 0);
      const float* scale = self ? p.s_s : p.s_a;
      float* dst = self ? p.ys : (float*)(p.aggregate ? p.y : p.out);
#pragma unroll
      for (int nt = 0; nt < xnor::kMmaCols / 8; ++nt) {
        if (nt >= n_t) break;
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int cl = (nt0 + nt) * 8 + 2 * t4 + e1, col = c0 + cl;
          if (col >= p.ho) continue;
          const int pbc = pb[cl];
          const float sc = scale[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (row[h] < 0) continue;
            // n_bits - 2 popc(a ^ b) from the AND counts; then (count * row
            // scale) * weight scale, the order of core/bmm.py, then the
            // column scale (none without aggregation: the output is out)
            const int cnt = p.f - 2 * (pa[h] + pbc) + 4 * acc[nt][2 * h + e1];
            float v = (float)cnt * xr[h] * sc;
            if (cs[h] != 1.f) v = v * cs[h];
            dst[row[h] * p.ho + col] = v;
          }
        }
      }
      if (!resident) __syncthreads();  // before the column popcounts change
    }
    __syncthreads();  // before the next tile's words
  }
}

// The kernel's parameter: the launch's Params and, for phase 2, the walk
// over the one matrix (tasks.cuh), read from the parameter space where they
// are used.
struct Args {
  Params p;
  tasks::Work w;
};

// kRcp: BN as (x - mu) * sd, sd holding 1 / sd (p.bn_rcp). A template
// argument, so that the single-host kinds run an instantiation without it
// (as a runtime choice they read 2-5% slower in tools/xform_step0.py).
// kAgg: the launch holds an adjacency (p.grp_ptr); the sharded steps'
// transform alone (none) runs an instance without phase 2, whose registers
// the task walk does not share (7e's step read 5% slower with one instance
// in tools/pair_step0.py). With aggregate = 0 the other instance also stops
// after phase 1.
template <bool kRcp, bool kAgg>
__global__ void __launch_bounds__(kThreads, 2)
    fused_layer_kernel(const __grid_constant__ Args a) {
  const Params& p = a.p;
  extern __shared__ uint4 s_tile[];
  __shared__ int2 s_hits[kWarps][walk::kHitsPerLoad];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  const long long n_warps = (long long)gridDim.x * kWarps;

  // 1. transform; the heavy rows' tickets zeroed (each row's first item),
  // ordered before their first use by the grid barrier
  if (kAgg && p.aggregate)
    for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
         t < p.n_part; t += (long long)gridDim.x * kThreads)
      if (p.tasks[2 * t + 1] == 0) p.row_done[p.tasks[2 * t]] = 0;
  if (p.fbb)
    transform_fbb<kRcp>(p, (float*)s_tile);
  else
    transform_bbf<kRcp>(p, (uint32_t*)s_tile);
  if (!kAgg || !p.aggregate) return;
  grid.sync();

  // 2. aggregate and store: a warp a task (tasks.cuh)
  const tasks::Work& w = a.w;
  for (long long t = gw; t < p.n_tasks; t += n_warps) {
    const int tr = p.tasks[2 * t], k = p.tasks[2 * t + 1];
    if (p.fbb) {
#define TASK(W)                                                         \
  if (p.s2)                                                             \
    tasks::bits_task<false, W, true>(w, t, tr, k, lane);                \
  else                                                                  \
    tasks::bits_task<false, W, false>(w, t, tr, k, lane);
      switch (walk::bits_pass((p.ho + 31) / 32)) {
        case 1: TASK(1) break;
        case 2: TASK(2) break;
        default: TASK(4)
      }
#undef TASK
    } else {
#define TASK(S, C, V)                                                   \
  if (p.fp_sub == S && p.fp_cols == C && p.fp_vec == (V))               \
    tasks::fp_task<false, S, C, V>(w, t, tr, k, lane, s_hits[warp]);    \
  else
      WALK_FP_LAYOUTS(TASK) {}
#undef TASK
    }
  }
}

// fc: BN -> quantize_act -> BMM.BBF, the fc body of fused_call, with no
// aggregation and so no grid barrier: an ordinary launch over rows
// (fused_fc), bit-equal to the cooperative kernel's transform. A warp takes
// kFcRows consecutive rows. Lane l reads feature 32 kc + l of each of them
// straight from device memory (a row's chunk is one 128-byte load a warp;
// chunk kc + 1 is in flight while chunk kc is quantized) and adds its |z|
// in chunk order; one ballot a chunk and row gives the sign word. So the
// words and the row scale (warp_sum / f) come in the order of
// transform_bbf. The words and row scales go to the warp's slice of shared
// memory; then lane l takes the outputs l, l + 32, ... of the warp's rows
// (row-major, so the stores are contiguous): f - 2 popc(a ^ w) over the
// row's words, times the row scale, times the column's scale, the weights
// read through the read-only cache. At most 16 KB of shared memory (the
// words and row scales), no opt-in. Measured at 64 -> 7 on device time
// (24,508 and 89,252 rows): weights staged in shared memory once a block
// read 6-15% slower, a warp taking 2 or 4 groups of rows in turn (the next
// group's loads under this group's outputs) 9-40% slower, 2 rows a warp
// 21-30% and a cap of 32 registers (8 blocks a SM) 9-12% slower, 8 rows a
// warp 2% faster on the fewer rows and 7% slower on the more
// (tools/xform_variants.py times the last three).
// Bound on H100: the bytes of x and of the fp output (64 -> 7: 284 bytes a
// row, 85 ps at 3.35 TB/s, against 448 binary multiply-adds, under 1 ps at
// the int8 tensor-core rate). At the serve bucket it takes about 2.4 times
// that. By a count of its instructions (per element a load, BN with an
// IEEE division on the single-host path, |z| and a compare; per row a
// ballot a chunk, the butterfly and the product) the instruction rate,
// not the bytes, bounds it; no profiler counter on the card confirms that.
constexpr int kFcWarps = 8;
constexpr int kFcThreads = kFcWarps * 32;
constexpr int kFcRows = 4;                        // rows a warp
constexpr int kFcBlockRows = kFcWarps * kFcRows;  // 32 rows a block

struct FcParams {
  // input: fp rows x (with BN when mu != null) or packed words xw
  const float* x;
  const uint32_t* xw;
  const float* mu;
  const float* sd;  // sd, or 1 / sd with bn_rcp
  long long n_in;
  int f;   // input features
  int wk;  // words of f
  int bn_rcp;
  // weights: packed W.T (ho, wk) and per-output scales
  const uint32_t* w_a;
  const float* s_a;
  int ho;
  float* out;  // (n_in, ho)
};

// Dynamic shared memory of fused_fc_kernel: the words and row scales of
// every warp's rows.
int fc_smem(int wk) { return 4 * kFcBlockRows * (wk + 1); }

template <bool kRcp>
__global__ void __launch_bounds__(kFcThreads) fused_fc_kernel(FcParams p) {
  extern __shared__ uint32_t s_fc[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* words = s_fc + warp * kFcRows * p.wk;             // [kFcRows][wk]
  float* rs = (float*)(s_fc + kFcBlockRows * p.wk) + warp * kFcRows;
  const long long r0 = ((long long)blockIdx.x * kFcWarps + warp) * kFcRows;
  if (r0 >= p.n_in) return;
  const int rows = (int)min((long long)kFcRows, p.n_in - r0);
  if (p.x) {
    const int n_xc = (p.f + 31) / 32;
    float cur[kFcRows], nxt[kFcRows] = {}, sabs[kFcRows] = {};
    auto load = [&](int kc, float* v) {
      const int k = kc * 32 + lane;
#pragma unroll
      for (int i = 0; i < kFcRows; ++i)
        v[i] = (i < rows && k < p.f) ? p.x[(r0 + i) * p.f + k] : 0.f;
    };
    load(0, cur);
    for (int kc = 0; kc < n_xc; ++kc) {
      if (kc + 1 < n_xc) load(kc + 1, nxt);
      const int k = kc * 32 + lane;
      const bool in = k < p.f;
      float mu = 0.f, sd = 1.f;
      if (p.mu && in) {
        mu = __ldg(p.mu + k);
        sd = __ldg(p.sd + k);
      }
#pragma unroll
      for (int i = 0; i < kFcRows; ++i) {
        float z = cur[i];
        if (in) {
          if (p.mu) z = kRcp ? (z - mu) * sd : (z - mu) / sd;
          sabs[i] += fabsf(z);
        }
        const uint32_t word = __ballot_sync(kFull, in && z >= 0.f);
        if (lane == 0 && i < rows) words[i * p.wk + kc] = word;
        cur[i] = nxt[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kFcRows; ++i) {
      const float s = warp_sum(sabs[i]) / (float)p.f;
      if (lane == 0) rs[i] = s;
    }
  } else {
    for (int e = lane; e < rows * p.wk; e += 32)
      words[e] = p.xw[r0 * p.wk + e];
    if (lane < kFcRows) rs[lane] = 1.f;
  }
  __syncwarp();
  float* out = p.out + r0 * p.ho;
  for (int e = lane; e < rows * p.ho; e += 32) {
    const int i = e / p.ho, c = e - i * p.ho;
    const uint32_t* a = words + i * p.wk;
    const uint32_t* b = p.w_a + (size_t)c * p.wk;
    int pc = 0;
    for (int w = 0; w < p.wk; ++w) pc += __popc(a[w] ^ __ldg(b + w));
    // n_bits - 2 popc(a ^ b), then (count * row scale) * weight scale, the
    // order of core/bmm.py and of transform_bbf
    out[e] = (float)(p.f - 2 * pc) * rs[i] * __ldg(p.s_a + c);
  }
}

}  // namespace

// Launch one layer cooperatively on `stream`: the transform's dynamic shared
// memory, and a grid of as many blocks as are resident at once with it,
// capped by the transform's row tiles and by the tasks (a warp each). A
// launch the card refuses returns its error.
extern "C" int fused_layer(const void* params, void* stream) {
  Params p = *(const Params*)params;
  if (p.wk > kMaxWords || (p.ho + 31) / 32 > kMaxChunks ||
      p.wk != (p.f + 31) / 32)
    return (int)cudaErrorInvalidValue;
  if (p.aggregate &&
      (!p.grp_ptr || p.chunk <= 0 || p.n_part < 0 || p.n_part > p.n_tasks ||
       (p.n_tasks > 0 && !p.tasks) ||
       (p.n_part > 0 && (!p.row_done || !p.part))))
    return (int)cudaErrorInvalidValue;
  if (p.aggregate && !p.fbb &&
      walk::with_fp_layout(p.fp_sub, p.fp_cols, p.fp_vec,
                           [](auto, auto, auto) { return cudaSuccess; }) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  const int smem = transform_smem(p.f, p.fbb, p.w_s != nullptr);
  int resident = 0;
  using Kernel = void (*)(Args);
  const Kernel kernel =
      p.grp_ptr ? (p.bn_rcp ? fused_layer_kernel<true, true>
                            : fused_layer_kernel<false, true>)
                : (p.bn_rcp ? fused_layer_kernel<true, false>
                            : fused_layer_kernel<false, false>);
  cudaError_t e = launch::allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = launch::resident_blocks(kernel, kThreads, smem, &resident);
  if (e != cudaSuccess) return (int)e;
  const int tile_rows = p.fbb ? kFbbRows : kBbfRows;
  long long want = (p.n_in + tile_rows - 1) / tile_rows;
  const long long task_blocks = ((long long)p.n_tasks + kWarps - 1) / kWarps;
  if (p.aggregate && task_blocks > want) want = task_blocks;
  long long blocks = want < resident ? want : resident;
  if (blocks < 1) blocks = 1;
  // the walk over y as the transform writes it (the column scale in it)
  Args a = {p,
            {{p.grp_ptr, p.tiles, p.col_idx, nullptr, p.y, p.n_in},
             {},
             p.row_scale, p.ys, p.out, p.part, p.row_done, p.n_rows, p.ho,
             p.chunk, p.relu}};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)blocks),
                                  dim3(kThreads), args, (size_t)smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Registers a thread, static shared bytes, resident blocks per SM and the
// dynamic shared bytes of the fused kernel when the transform takes f
// features in BMM.FBB (fbb) or BMM.BBF (with the self branch's weights or
// without): out[0..3]. One build serves every kind and layout.
extern "C" int fused_layer_attrs(int f, int fbb, int self_branch, int* out) {
  return (int)launch::attributes(fused_layer_kernel<false, true>, kThreads,
                                 transform_smem(f, fbb, self_branch), out);
}

// Launch fc on `stream` (fused_fc_kernel): an ordinary launch of
// kFcBlockRows rows a block, at least one block; no occupancy query, no
// shared-memory opt-in, no grid barrier. A launch the card refuses returns
// its error.
extern "C" int fused_fc(const void* params, void* stream) {
  FcParams p = *(const FcParams*)params;
  if (p.wk > kMaxWords || (p.ho + 31) / 32 > kMaxChunks ||
      p.wk != (p.f + 31) / 32)
    return (int)cudaErrorInvalidValue;
  long long blocks = (p.n_in + kFcBlockRows - 1) / kFcBlockRows;
  if (blocks < 1) blocks = 1;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchKernel(
      p.bn_rcp ? (const void*)fused_fc_kernel<true>
               : (const void*)fused_fc_kernel<false>,
      dim3((unsigned)blocks), dim3(kFcThreads), args,
      (size_t)fc_smem(p.wk), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Registers a thread, static shared bytes, resident blocks per SM and the
// dynamic shared bytes of fused_fc_kernel for f input features: out[0..3].
extern "C" int fused_fc_attrs(int f, int* out) {
  return (int)launch::attributes(fused_fc_kernel<false>, kFcThreads,
                                 fc_smem((f + 31) / 32), out);
}
