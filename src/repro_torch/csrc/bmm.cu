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
// 2..19 words) the int32 output dominates the bytes and the popc work is
// small, so the kernel is bound by bytes. Design: one thread per output
// element; a warp covers 32 consecutive n of one row m, so A's words are a
// broadcast, the stores are coalesced, and in binarize mode one
// __ballot_sync gives the output word directly. A block stages the words of
// its 32 B rows in shared memory, transposed, 32 words of K at a time, so
// the lanes read B without the stride of Wk words between them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;
constexpr int kKTile = 32;  // words of K per shared-memory tile

__global__ void bmm_xnor_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                int32_t* __restrict__ out_counts,
                                uint32_t* __restrict__ out_bits, int m, int n,
                                int wk, int n_bits, int binarize) {
  __shared__ uint32_t sb[kKTile][33];  // [word][column], padded: no conflicts
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.y;  // uniform in warp
  const int col0 = blockIdx.y * 32;
  const int col = col0 + threadIdx.x;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const bool ok = row < m && col < n;
  int acc = 0;
  for (int k0 = 0; k0 < wk; k0 += kKTile) {
    const int kt = min(kKTile, wk - k0);
    for (int e = tid; e < 32 * kKTile; e += 32 * kRowsPerBlock) {
      const int c = e / kKTile, w = e % kKTile;
      sb[w][c] = (col0 + c < n && w < kt)
                     ? b[(size_t)(col0 + c) * wk + k0 + w] : 0u;
    }
    __syncthreads();
    if (row < m) {
      const uint32_t* ar = a + (size_t)row * wk + k0;
      for (int w = 0; w < kt; ++w) acc += __popc(ar[w] ^ sb[w][threadIdx.x]);
    }
    __syncthreads();
  }
  const int val = n_bits - 2 * acc;
  if (!binarize) {
    if (ok) out_counts[(size_t)row * n + col] = val;
    return;
  }
  const uint32_t word = __ballot_sync(kFull, ok && val >= 0);
  if (threadIdx.x == 0 && row < m)
    out_bits[(size_t)row * gridDim.y + blockIdx.y] = word;
}

}  // namespace

extern "C" int bmm_xnor(const void* a, const void* b, void* out, int m, int n,
                        int wk, int n_bits, int binarize, void* stream) {
  if (m > 0 && n > 0) {
    dim3 block(32, kRowsPerBlock);
    dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock, (n + 31) / 32);
    bmm_xnor_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, (uint32_t*)out,
        m, n, wk, n_bits, binarize);
  }
  return (int)cudaGetLastError();
}
