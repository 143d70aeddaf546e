// Dense XNOR-popc products of packed +-1 words, shared by bmm_xnor
// (bmm.cu) and the BMM.BBF transform of the fused layer (fused_layer.cu).
//
// Both multiply a tile of A rows by a tile of B rows (B is the transposed
// weight), each packed along K with pad bits 0, out of shared memory, and
// count sum_w popc(a_w ^ b_w) per (row, column). Two routes:
//   simt  each of a block's 256 threads owns kRM rows x kRN columns in
//         registers and runs __popc(a ^ b) over 16-byte (uint4) loads of
//         both operands: popc throughput (16 a clock an SM) bounds it;
//   mma   a warp owns 16 rows x 64 columns and runs the b1 tensor-core
//         product mma.sync.m16n8k256.and.popc, which counts popc(a & b);
//         popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b), so the caller
//         adds the row and column popcounts (pad bits are 0 in both
//         operands, so padding K up to 256 adds nothing).
// Shared-memory rows have a stride of ld words, ld = 4 (mod 8), so the
// 16-byte loads of 8 consecutive rows fall in distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xnor {

constexpr int kThreads = 256;    // a block
constexpr int kRM = 4;           // simt: rows a thread
constexpr int kRN = 4;           // simt: columns a thread
constexpr int kKWords = 32;      // K words staged at once (1,024 bits)
constexpr int kMmaRows = 16;     // mma: rows a warp
constexpr int kMmaCols = 64;     // mma: columns a warp (8 n-tiles of 8)
constexpr int kMmaStep = 8;      // mma: K words a step (256 bits)
constexpr int kStageLd = kMmaCols + 8;  // mma: stride of a warp's staged C

__host__ __device__ constexpr int pad_ld(int words) {
  return (words + 7) / 8 * 8 + 4;
}

// The simt tile: kCT threads across the columns, kThreads / kCT down the
// rows. Thread tid owns rows ty + kRowThreads * i and columns tx + kCT * j
// (tx = tid % kCT, ty = tid / kCT): neighbouring threads read neighbouring
// B rows and store neighbouring columns.
template <int kCT>
struct Simt {
  static constexpr int kRowThreads = kThreads / kCT;
  static constexpr int kRows = kRowThreads * kRM;
  static constexpr int kCols = kCT * kRN;
};

// acc[i][j] += sum over the words [0, kw4) of popc(A[row i] ^ B[col j]);
// kw4 is a multiple of 4, and words past the real K are 0 in both tiles.
template <int kCT>
__device__ __forceinline__ void simt_popc(const uint32_t* __restrict__ as,
                                          int lda,
                                          const uint32_t* __restrict__ bs,
                                          int ldb, int kw4, int tid,
                                          int acc[kRM][kRN]) {
  using T = Simt<kCT>;
  const int tx = tid % kCT, ty = tid / kCT;
  for (int w = 0; w < kw4; w += 4) {
    uint4 a[kRM], b[kRN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      a[i] = *(const uint4*)(as + (ty + T::kRowThreads * i) * lda + w);
#pragma unroll
    for (int j = 0; j < kRN; ++j)
      b[j] = *(const uint4*)(bs + (tx + kCT * j) * ldb + w);
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j)
        acc[i][j] += __popc(a[i].x ^ b[j].x) + __popc(a[i].y ^ b[j].y) +
                     __popc(a[i].z ^ b[j].z) + __popc(a[i].w ^ b[j].w);
  }
}

// Copy rows [r0, r0 + rows) and words [w0, w0 + kw) of a (n_rows, wk)
// word matrix into s (stride ld), zero-filling rows past n_rows and words
// [kw, kw_pad); `vec` (wk and kw multiples of 4, g 16-byte aligned) copies
// 16 bytes at a time.
__device__ __forceinline__ void stage_rows(uint32_t* s, int ld,
                                           const uint32_t* __restrict__ g,
                                           long long r0, long long n_rows,
                                           int rows, int wk, int w0, int kw,
                                           int kw_pad, bool vec, int tid) {
  if (vec) {
    const int q4 = kw_pad >> 2;
    for (int e = tid; e < rows * q4; e += kThreads) {
      const int r = e / q4, q = (e - r * q4) * 4;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < n_rows && q < kw)
        v = *(const uint4*)(g + (r0 + r) * wk + w0 + q);
      *(uint4*)(s + r * ld + q) = v;
    }
    return;
  }
  for (int e = tid; e < rows * kw_pad; e += kThreads) {
    const int r = e / kw_pad, w = e - r * kw_pad;
    s[r * ld + w] = (r0 + r < n_rows && w < kw) ? g[(r0 + r) * wk + w0 + w]
                                                : 0u;
  }
}

// d += AND-popc of one m16n8k256 step (b1 operands, s32 accumulators).
__device__ __forceinline__ void mma_and_popc(int d[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's 16 rows against up to kMmaCols columns over the words
// [0, kw) of a K chunk. A row g of the warp is `a + g * lda` (global or
// shared memory), rows at or past `rows` and words at or past kw read as 0;
// B is in shared memory (stride ldb), and both callers stage it zero past
// kw up to a multiple of kMmaStep and past the real columns, so that the
// product counts nothing but real words whatever its bit operation. acc[nt] holds the fragment of n-tile nt: rows g (d0, d1)
// and g + 8 (d2, d3), columns nt * 8 + 2 * (lane % 4) + {0, 1}, with
// g = lane / 4. pa[0], pa[1] gather the popcounts of rows g and g + 8 of
// this lane's words (the caller adds them over the 4 lanes of a row).
__device__ __forceinline__ void mma_popc(const uint32_t* a, long long lda,
                                         int rows, int kw,
                                         const uint32_t* __restrict__ bs,
                                         int ldb, int n_tiles, int lane,
                                         int acc[kMmaCols / 8][4], int pa[2]) {
  const int g = lane >> 2, t = lane & 3;
  for (int s = 0; s < kw; s += kMmaStep) {
    uint32_t f[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = g + (q & 1) * 8, w = s + t + (q >> 1) * 4;
      f[q] = (row < rows && w < kw) ? a[row * lda + w] : 0u;
    }
    pa[0] += __popc(f[0]) + __popc(f[2]);
    pa[1] += __popc(f[1]) + __popc(f[3]);
#pragma unroll
    for (int nt = 0; nt < kMmaCols / 8; ++nt) {
      if (nt >= n_tiles) break;  // uniform across the warp
      const uint32_t* br = bs + (nt * 8 + g) * ldb + s + t;
      mma_and_popc(acc[nt], f, br[0], br[4]);
    }
  }
}

}  // namespace xnor
