// XNOR-popc dense binary matmul: the compute core of BMM.BB?.
//
// Replaces the Pallas TPU kernel repro/kernels/bmm_kernel.py:bmm_xnor
// (_bmm_xnor_kernel, _bmm_xnor_bin_kernel). A (M, Wk) and B (N, Wk) hold
// +-1 values packed along K (pad bits 0 in both). The result is
// out[m, n] = n_bits - 2 * sum_w popc(A[m, w] ^ B[n, w]) as int32, or, fused
// (Step 6), the sign bits of that value packed along N, with the bits of
// columns past N left 0.
//
// Bound on H100: at the GNN shapes (N = hidden width or class count, Wk of
// 2..19 words) the int32 output is most of the bytes; on CUDA cores the
// popc work (M N Wk popcs at 16 a clock an SM) takes about three times as
// long as those bytes. Design: a tiled bit GEMM in two routes (xnor.cuh).
// A block keeps one column tile of B in shared memory (the whole B at
// every GNN shape, 4 KB at (64, 16)) and walks row tiles in a grid-stride
// loop, so B is staged once a block; K longer than 32 words is taken in
// chunks, restaging B. The launcher picks the route from N: up to 8
// columns (the class layers) the simt route, which stages each row tile
// of A with 16-byte loads into 512 x 8 tiles, so N = 7 keeps 7 of 8 lanes
// busy; above, the mma route, which runs b1 tensor-core AND-popc steps on
// 16 x 64 warp tiles, reading A straight from global memory, and adds
// n_bits - 2 (popc(a) + popc(b)). Each is the faster of the two at its
// shapes on the H100 (PERF.md; tools/xform_variants.py times the other).
// Counts are staged through shared memory and stored row-contiguous (16
// bytes a thread where N is a multiple of 4); sign words are assembled
// from the staged tile (the mma fragment is not a lane-per-column layout).
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "xnor.cuh"

namespace {

constexpr int kThreads = xnor::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMmaTileRows = kWarps * xnor::kMmaRows;

struct Args {
  const uint32_t* a;
  const uint32_t* b;
  int32_t* counts;
  uint32_t* bits;
  long long m;
  int n, wk, n_bits, binarize;
  int kw;   // K words a chunk
  int ld;   // stride of the staged rows
  bool vec_a, vec_b;
};

// The simt tile: kSimtCT threads across its columns, so 4 kSimtCT
// columns by 1,024 / kSimtCT rows; N up to kSimtMaxN runs on it, wider N
// on the tensor cores. (tools/xform_variants.py rewrites both to time the
// other route at each shape.)
constexpr int kSimtCT = 2;
constexpr int kSimtMaxN = kSimtCT * xnor::kRN;
using Simt = xnor::Simt<kSimtCT>;

int chunk_words(int wk) { return wk < xnor::kKWords ? wk : xnor::kKWords; }

// Dynamic shared memory of a launch at (n, wk).
int smem_bytes(int n, int wk) {
  const int ld = xnor::pad_ld(chunk_words(wk));
  if (n > kSimtMaxN)
    return 4 * (xnor::kMmaCols * ld + xnor::kMmaCols +
                kWarps * xnor::kMmaRows * xnor::kStageLd);
  return 4 * ((Simt::kRows + Simt::kCols) * ld + Simt::kRows * Simt::kCols);
}

// Store `rows` x `cols` staged values (stride ld_c) at out rows r0.., columns
// c0.. of an (M, N) int32 matrix: contiguous 16-byte stores where the tile
// spans whole rows of a width that is a multiple of 4.
__device__ __forceinline__ void store_counts(const int32_t* cs, int ld_c,
                                             int32_t* out, long long r0,
                                             int c0, int rows, int cols,
                                             int n, int tid, int nthreads) {
  if (c0 == 0 && cols == n && (n & 3) == 0) {
    const int q4 = n >> 2;
    int4* dst = (int4*)(out + r0 * n);
    for (int e = tid; e < rows * q4; e += nthreads) {
      const int r = e / q4, c = (e - r * q4) * 4;
      dst[e] = *(const int4*)(cs + r * ld_c + c);
    }
    return;
  }
  for (int e = tid; e < rows * cols; e += nthreads) {
    const int r = e / cols, c = e - r * cols;
    out[(r0 + r) * n + c0 + c] = cs[r * ld_c + c];
  }
}

// Sign words of the staged tile: word w of row r has bit c set where
// column w * 32 + c (< cols) is >= 0.
__device__ __forceinline__ void store_bits(const int32_t* cs, int ld_c,
                                           uint32_t* out, long long r0,
                                           int c0, int rows, int cols, int n,
                                           int tid, int nthreads) {
  const int wn = (n + 31) / 32, tw = (cols + 31) / 32;
  for (int e = tid; e < rows * tw; e += nthreads) {
    const int r = e / tw, w = e - r * tw;
    const int nc = min(32, cols - w * 32);
    uint32_t word = 0u;
    for (int c = 0; c < nc; ++c)
      word |= (uint32_t)(cs[r * ld_c + w * 32 + c] >= 0) << c;
    out[(r0 + r) * wn + c0 / 32 + w] = word;
  }
}

__global__ void __launch_bounds__(kThreads) bmm_simt_kernel(Args p) {
  using T = Simt;
  extern __shared__ uint4 smem[];
  uint32_t* as = (uint32_t*)smem;
  uint32_t* bs = as + T::kRows * p.ld;
  int32_t* cs = (int32_t*)(bs + T::kCols * p.ld);
  const int tid = threadIdx.x, tx = tid % kSimtCT, ty = tid / kSimtCT;
  const int c0 = blockIdx.y * T::kCols;
  const int cols = min(T::kCols, p.n - c0);
  const long long n_tiles = (p.m + T::kRows - 1) / T::kRows;
  const int n_kc = (p.wk + p.kw - 1) / p.kw;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long r0 = t * T::kRows;
    const int rows = (int)min((long long)T::kRows, p.m - r0);
    int acc[xnor::kRM][xnor::kRN] = {};
    for (int kc = 0; kc < n_kc; ++kc) {
      const int w0 = kc * p.kw, kw = min(p.kw, p.wk - w0);
      const int kw4 = (kw + 3) & ~3;
      if (n_kc > 1 || t == blockIdx.x)   // B stays while K is one chunk
        xnor::stage_rows(bs, p.ld, p.b, c0, p.n, T::kCols, p.wk, w0, kw, kw4,
                         p.vec_b, tid);
      xnor::stage_rows(as, p.ld, p.a, r0, p.m, T::kRows, p.wk, w0, kw, kw4,
                       p.vec_a, tid);
      __syncthreads();
      xnor::simt_popc<kSimtCT>(as, p.ld, bs, p.ld, kw4, tid, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < xnor::kRM; ++i)
#pragma unroll
      for (int j = 0; j < xnor::kRN; ++j)
        cs[(ty + T::kRowThreads * i) * T::kCols + tx + kSimtCT * j] =
            p.n_bits - 2 * acc[i][j];
    __syncthreads();
    if (p.binarize)
      store_bits(cs, T::kCols, p.bits, r0, c0, rows, cols, p.n, tid,
                 kThreads);
    else
      store_counts(cs, T::kCols, p.counts, r0, c0, rows, cols, p.n, tid,
                   kThreads);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) bmm_mma_kernel(Args p) {
  extern __shared__ uint4 smem[];
  uint32_t* bs = (uint32_t*)smem;
  int* pb = (int*)(bs + xnor::kMmaCols * p.ld);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* cs = pb + xnor::kMmaCols + warp * xnor::kMmaRows * xnor::kStageLd;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.y * xnor::kMmaCols;
  const int cols = min(xnor::kMmaCols, p.n - c0);
  const int n_tiles = (cols + 7) / 8;
  const int n_kc = (p.wk + p.kw - 1) / p.kw;
  for (int c = threadIdx.x; c < xnor::kMmaCols; c += kThreads) {
    int s = 0;
    if (c < cols)
      for (int w = 0; w < p.wk; ++w) s += __popc(p.b[(size_t)(c0 + c) * p.wk + w]);
    pb[c] = s;
  }
  const long long n_row_tiles = (p.m + kMmaTileRows - 1) / kMmaTileRows;
  for (long long t = blockIdx.x; t < n_row_tiles; t += gridDim.x) {
    const long long r0 = t * kMmaTileRows + warp * xnor::kMmaRows;
    const int rows = (int)max(0LL, min((long long)xnor::kMmaRows, p.m - r0));
    int acc[xnor::kMmaCols / 8][4] = {};
    int pa[2] = {0, 0};
    for (int kc = 0; kc < n_kc; ++kc) {
      const int w0 = kc * p.kw, kw = min(p.kw, p.wk - w0);
      if (n_kc > 1 || t == blockIdx.x) {
        __syncthreads();
        xnor::stage_rows(bs, p.ld, p.b, c0, p.n, xnor::kMmaCols, p.wk, w0, kw,
                         (kw + xnor::kMmaStep - 1) / xnor::kMmaStep *
                             xnor::kMmaStep,
                         p.vec_b, threadIdx.x);
        __syncthreads();
      }
      xnor::mma_popc(p.a + r0 * p.wk + w0, p.wk, rows, kw, bs, p.ld, n_tiles,
                     lane, acc, pa);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 1);
      pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 2);
    }
    // n_bits - 2 popc(a ^ b) = n_bits - 2 (popc a + popc b) + 4 popc(a & b)
#pragma unroll
    for (int nt = 0; nt < xnor::kMmaCols / 8; ++nt) {
      if (nt >= n_tiles) break;
      const int c = nt * 8 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int2 v;
        v.x = p.n_bits - 2 * (pa[h] + pb[c]) + 4 * acc[nt][2 * h];
        v.y = p.n_bits - 2 * (pa[h] + pb[c + 1]) + 4 * acc[nt][2 * h + 1];
        *(int2*)(cs + (g + 8 * h) * xnor::kStageLd + c) = v;
      }
    }
    __syncwarp();
    if (rows > 0) {
      if (p.binarize)
        store_bits(cs, xnor::kStageLd, p.bits, r0, c0, rows, cols, p.n, lane,
                   32);
      else
        store_counts(cs, xnor::kStageLd, p.counts, r0, c0, rows, cols, p.n,
                     lane, 32);
    }
    __syncwarp();
  }
}

}  // namespace

// One launch on `stream`: the route N picks, its tiles and shared memory,
// and a grid of as many blocks as are resident at once (at most one a row
// tile; each walks row tiles in a grid-stride loop) by the column tiles.
extern "C" int bmm_xnor(const void* a, const void* b, void* out, long long m,
                        int n, int wk, int n_bits, int binarize, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (wk <= 0) return (int)cudaErrorInvalidValue;
  Args p;
  p.a = (const uint32_t*)a;
  p.b = (const uint32_t*)b;
  p.counts = (int32_t*)out;
  p.bits = (uint32_t*)out;
  p.m = m;
  p.n = n;
  p.wk = wk;
  p.n_bits = n_bits;
  p.binarize = binarize;
  p.kw = chunk_words(wk);
  p.ld = xnor::pad_ld(p.kw);
  p.vec_a = wk % 4 == 0 && ((uintptr_t)a & 15) == 0;
  p.vec_b = wk % 4 == 0 && ((uintptr_t)b & 15) == 0;
  const bool simt = n <= kSimtMaxN;
  auto* kernel = simt ? bmm_simt_kernel : bmm_mma_kernel;
  const int tile_rows = simt ? Simt::kRows : kMmaTileRows;
  const int tile_cols = simt ? Simt::kCols : xnor::kMmaCols;
  const int smem = smem_bytes(n, wk);
  int resident = 0;
  cudaError_t e = launch::allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = launch::resident_blocks(kernel, kThreads, smem, &resident);
  if (e != cudaSuccess) return (int)e;
  const long long row_tiles = (m + tile_rows - 1) / tile_rows;
  const long long grid_x = row_tiles < resident ? row_tiles : resident;
  dim3 grid((unsigned)(grid_x > 1 ? grid_x : 1),
            (unsigned)((n + tile_cols - 1) / tile_cols));
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers a thread, static shared bytes, resident blocks per SM and the
// dynamic shared bytes of the kernel that a launch at (n, wk) runs:
// out[0..3].
extern "C" int bmm_xnor_attrs(int n, int wk, int* out) {
  return (int)launch::attributes(n <= kSimtMaxN ? bmm_simt_kernel
                                                : bmm_mma_kernel,
                                 kThreads, smem_bytes(n, wk > 0 ? wk : 1), out);
}
