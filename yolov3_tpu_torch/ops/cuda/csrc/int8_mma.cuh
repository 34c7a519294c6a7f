// Shared machinery of the int8 matrix-product kernels K3 and K6 for rows that
// are not a whole number of 16-byte chunks: block tiles staged through shared
// memory and multiplied on the tensor cores with mma.sync.m16n8k32
// (s8 x s8 -> s32).
//
// A block has 256 threads = 8 warps, 4 along the rows (M) and 2 along the
// columns (N) of a (kBM x BN) output tile, BN = 16 * NF; each warp owns a
// 32 x (BN/2) sub-tile as 2 x NF fragments of 16 x 8 s32 sums in registers.
// Both operands are read with the contraction contiguous ("row.col"): A as
// rows of activations, B as rows of the packed weights (one row per output
// channel). A staged tile holds kBK = 64 contraction bytes per row, at a row
// stride of 80 bytes: the 32-bit fragment loads of a warp (8 rows x 4 words)
// then fall into 32 distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace yolo_int8 {

constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBK = 64;
constexpr int kLd = kBK + 16;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int NF>
__device__ __forceinline__ void zero_acc(int (&acc)[2][NF][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;
}

// acc += A[32 rows, 32*kfrags bytes] . B[8*NF rows, 32*kfrags bytes]^T for one
// warp. `a` points at (first of the warp's 32 rows, k = 0) with row stride
// `lda` bytes, `b` at (first of the warp's 8*NF weight rows, k = 0) with row
// stride `ldb`; both in shared memory, 4-byte aligned.
// Fragment layout of m16n8k32 (PTX ISA): with g = lane / 4, t = lane % 4,
// A regs hold rows {g, g+8} x k {4t..4t+3, 16+4t..16+4t+3}; B regs hold
// column g x the same k; C regs hold rows {g, g+8} x columns {2t, 2t+1}.
template <int NF>
__device__ __forceinline__ void warp_mma(const int8_t* a, int lda, const int8_t* b, int ldb,
                                         int kfrags, int (&acc)[2][NF][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int kf = 0; kf < kfrags; ++kf) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = a + (size_t)(mi * 16 + g) * lda + kf * 32 + t * 4;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * (size_t)lda);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * (size_t)lda + 16);
    }
#pragma unroll
    for (int ni = 0; ni < NF; ++ni) {
      const int8_t* p = b + (size_t)(ni * 8 + g) * ldb + kf * 32 + t * 4;
      uint32_t bf[2];
      bf[0] = *reinterpret_cast<const uint32_t*>(p);
      bf[1] = *reinterpret_cast<const uint32_t*>(p + 16);
      mma_s8(acc[0][ni], af[0], bf);
      mma_s8(acc[1][ni], af[1], bf);
    }
  }
}

// Copy the (ROWS x kBK)-byte tile of a row-major int8 matrix `g` (row stride
// `ldg` bytes) that starts at (row0, k0) into shared memory (row stride kLd),
// with zeros where row >= nrows or k >= kmax. `vec`: 16-byte loads, which
// need ldg % 16 == 0, kmax % 16 == 0 and a 16-byte aligned base; otherwise
// byte loads (any shape).
template <int ROWS>
__device__ __forceinline__ void stage_rows(int8_t* s, const int8_t* g, int ldg, int row0,
                                           int nrows, int k0, int kmax, bool vec, int tid) {
  if (vec) {
    for (int c = tid; c < ROWS * (kBK / 16); c += kThreads) {
      const int r = c >> 2, kc = (c & 3) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (row0 + r < nrows && k0 + kc < kmax)
        v = *reinterpret_cast<const int4*>(g + (size_t)(row0 + r) * ldg + k0 + kc);
      *reinterpret_cast<int4*>(s + r * kLd + kc) = v;
    }
  } else {
    for (int e = tid; e < ROWS * kBK; e += kThreads) {
      const int r = e >> 6, k = e & 63;
      int8_t v = 0;
      if (row0 + r < nrows && k0 + k < kmax) v = g[(size_t)(row0 + r) * ldg + k0 + k];
      s[r * kLd + k] = v;
    }
  }
}

// Call f(row, col, sum0, sum1) for every pair of adjacent columns (col even)
// of the warp's sums; row and col are relative to the block tile.
template <int NF, class F>
__device__ __forceinline__ void for_each_pair(const int (&acc)[2][NF][4], int warp_m,
                                              int warp_n, int lane, F f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(warp_m * 32 + mi * 16 + g + h * 8, warp_n * (NF * 8) + ni * 8 + t * 2,
          acc[mi][ni][h * 2], acc[mi][ni][h * 2 + 1]);
}

}  // namespace yolo_int8
