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
// Association and work split: the task walk of tasks.cuh (kHalo), which
// the single-host kinds of fused_layer.cu run over their one matrix, so a
// row without halo edges is bit-equal to the one-launch kind. A tile-row is
// cut into items of `chunk` groups counted from its first group, in each
// matrix; the row's sum adds its intra items in order, then the sum of its
// halo items; then the row scale once, the self add and the ReLU. Each
// column scale is applied at the gather, one rounded product of the
// gathered value, the product the one-launch kind's transform rounds.
// Counts are integers: any order is exact. A warp takes a task of the list
// built once a plan (kernels/fused_layer.py pair_items): a light row (one
// intra item and at most one halo item, nearly every row of a sharded
// plan) walks both in turn with the epilogue in registers; each item of a
// heavy row writes partial sums to scratch and the row's last warp adds
// them. The launch is an ordinary one, a block per 8 tasks: no grid-wide
// barrier, no dynamic shared memory, and the walks' own launch bounds.
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
#include "tasks.cuh"
#include "walk.cuh"

namespace {

constexpr int kWarps = walk::kBlockWarps;
constexpr int kThreads = kWarps * 32;

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

// The kernels' parameter: the launch's walk and its task list, read from
// the parameter space where they are used.
struct Args {
  tasks::Work w;
  const int32_t* tasks;
  int n_tasks;
};

Args args_of(const Params& p) {
  return {{{p.grp_ptr, p.tiles, p.col_idx, p.col_scale, p.y, p.n_y},
           {p.h_grp_ptr, p.h_tiles, p.h_col_idx, p.h_col_scale, p.rem,
            p.n_rem},
           p.row_scale, p.ys, p.out, p.part, p.row_done, p.n_rows, p.ho,
           p.chunk, p.relu},
          p.tasks, p.n_tasks};
}

template <int kSub, int kCols, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_pair_fp_kernel(const __grid_constant__ Args a) {
  __shared__ int2 s_hits[kWarps][walk::kHitsPerLoad];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = (long long)blockIdx.x * kWarps + warp;
  if (t >= a.n_tasks) return;
  tasks::fp_task<true, kSub, kCols, kVec>(a.w, t, a.tasks[2 * t],
                                          a.tasks[2 * t + 1], lane,
                                          s_hits[warp]);
}

template <int kW, bool kS2>
__global__ void __launch_bounds__(kThreads, walk::bits_min_blocks(kW))
    fused_pair_bits_kernel(const __grid_constant__ Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = (long long)blockIdx.x * kWarps + warp;
  if (t >= a.n_tasks) return;
  tasks::bits_task<true, kW, kS2>(a.w, t, a.tasks[2 * t], a.tasks[2 * t + 1],
                                  lane);
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
  const Args a = args_of(p);
  auto run = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>(a);
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
