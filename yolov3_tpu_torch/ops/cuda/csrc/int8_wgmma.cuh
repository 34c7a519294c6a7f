// The Hopper machinery of the int8 matrix-product kernels K3 (conv1x1_int8.cu),
// K6 (conv_int8.cu) and K4 (resblock_int8.cu, which takes the copies, the
// descriptors and the products and runs loops of its own): a main loop over a
// ring of tiles in shared memory filled by 16-byte cp.async copies
// (zero-filled where a copy is masked), multiplied by wgmma.mma_async
// (s8 x s8 -> s32, m64nNk32) with both operands read from shared memory
// through descriptors; the caller supplies the functor
// that issues one stage's copies (K6 gathers taps, K3 copies plain rows). Then
// the requant epilogue (requant.cuh) staged through shared memory and stored
// 16 bytes a thread.
//
// A block has 256 threads = two warpgroups; warpgroup g owns rows [64g, 64g+64)
// of a (kBM x BN) output tile, BN = 32, 64 or 128, as BN/2 s32 sums a thread. A
// stage holds kBK = 128 contraction bytes of the kBM rows of A and then of the
// BN rows of B (one row per output channel), both "K-major": a row is 128
// contiguous bytes, rows follow each other, and 8 rows form a 1024-byte atom
// in the 128-byte swizzle (the 16-byte chunk c of row r lies at chunk
// c ^ (r & 7)), which is what the descriptor's layout type 1 reads and what
// keeps the copies and the tensor cores off each other's banks. Every tile
// therefore starts on a 1024-byte boundary. One wgmma takes 32 contraction
// bytes; the four of a stage advance the descriptors' start address by 32
// bytes inside the swizzled row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace yolo_int8 {
namespace wg {

constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBK = 128;
constexpr int kStages = 3;
constexpr int kSms = 132;         // H100 SXM
constexpr int kBlockSlots = 2 * kSms;  // two blocks of a kernel on each SM

template <int BN>
__host__ __device__ constexpr uint32_t stage_bytes() { return (kBM + BN) * kBK; }
// dynamic shared memory of a launch: the ring and room to align it to 1024
template <int BN>
__host__ __device__ constexpr uint32_t ring_bytes() { return kStages * stage_bytes<BN>() + 1024; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory address of 16-byte chunk `chunk` (0..7) of row `row` of the
// tile that starts at `tile`.
__device__ __forceinline__ uint32_t swizzled(uint32_t tile, int row, int chunk) {
  return tile + row * kBK + ((chunk ^ (row & 7)) << 4);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is then
// not read but must be an address). L1: keep (`ca`, an operand that is read
// again by the same block) or bypass (`cg`).
__device__ __forceinline__ void cp_async_16_ca(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_16_cg(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes this thread's completed copies visible to the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a K-major, 128-byte-swizzled operand whose first row starts
// at shared address `addr`: start address / 16 in bits 0-13, leading byte
// offset (not used by this layout) 1 in bits 16-29, stride between 8-row
// atoms 1024 / 16 in bits 32-45, layout type 1 (128-byte swizzle) in bits
// 62-63.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// d += A[64 rows, 32 bytes] . B[N rows, 32 bytes]^T for one warpgroup.
// Accumulator layout (PTX ISA, wgmma D fragment): with w = warp in the
// warpgroup, g = lane / 4, t = lane % 4, d[4j + 2h + e] is row 16w + g + 8h,
// column 8j + 2t + e.
__device__ __forceinline__ void mma_m64n32k32(int (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void mma_m64n64k32(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void mma_m64n128k32(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void mma_k32(int (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  static_assert(BN == 32 || BN == 64 || BN == 128, "tile widths of the int8 kernels");
  if constexpr (BN == 32) mma_m64n32k32(d, desc_a, desc_b);
  else if constexpr (BN == 64) mma_m64n64k32(d, desc_a, desc_b);
  else mma_m64n128k32(d, desc_a, desc_b);
}

// acc += A . B^T over k-tiles [kt0, kt1). `ring` is the 1024-aligned shared
// address of kStages stages. `load(stage)` issues this thread's cp.async
// copies of the next k-tile (the first call is k-tile kt0, each call one
// further) into the stage at shared address `stage`: A's kBM rows first, then
// B's BN rows. Every thread of the block calls this.
//
// Two k-tiles are in flight while one is multiplied. A stage is refilled one
// iteration after its products were waited for by every thread (the barrier
// at the top of the iteration orders that), and a tile is read only after
// each thread waited for its own copies, fenced them for the tensor cores and
// passed the same barrier.
template <int BN, class Load>
__device__ __forceinline__ void mainloop(uint32_t ring, int kt0, int kt1, Load load,
                                         int (&acc)[BN / 2]) {
  constexpr uint32_t kStage = stage_bytes<BN>();
  const uint32_t a_rows = (threadIdx.x >> 7) * 64 * kBK;
  int issued = kt0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (issued < kt1) {
      load(ring + s * kStage);
      ++issued;
    }
    cp_async_commit();
  }
  int slot = 0, fill = kStages - 1;
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t a = ring + slot * kStage + a_rows;
    const uint32_t b = ring + slot * kStage + kBM * kBK;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 32; ++j)
      mma_k32<BN>(acc, tile_desc(a + 32 * j), tile_desc(b + 32 * j));
    wgmma_commit();
    if (issued < kt1) {
      load(ring + fill * kStage);
      ++issued;
    }
    cp_async_commit();
    wgmma_wait<0>();
    slot = slot + 1 == kStages ? 0 : slot + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;
  }
  cp_async_wait<0>();
  // the sums are defined from here on: no read of them may move above the wait
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// The epilogue of one (kBM x BN) tile at (m0, n0): every thread turns its
// sums into outputs (requant.cuh: scale, bias, leaky, then s8 or f32) in
// `stage` (kBM rows of BN + 16 elements: the padding keeps the writes off
// each other's banks), a barrier, then the block stores the tile 16 bytes a
// thread along N (`vec_out`: N and `out` allow it; else byte by byte),
// masked at M and N. `stage` must be free when it is called; it is read
// until the last store.
template <int BN>
__device__ __forceinline__ void store_tile(uint8_t* stage, const int (&acc)[BN / 2], int m0,
                                           int n0, int m, int n, const float* scale,
                                           const float* bias, int leaky_on, int out_f32,
                                           float inv, int vec_out, void* out) {
  constexpr int kLdOut = BN + 16;   // elements
  const int tid = threadIdx.x;
  {
    const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t, col = n0 + c;
      if (col < n) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * warp + gq + 8 * hh;
          conv_epilogue_pair(stage, (size_t)r * kLdOut + c, col + 1 < n, true,
                             acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1], scale + col,
                             bias + col, leaky_on, out_f32, inv);
        }
      }
    }
  }
  __syncthreads();
  const int esize = out_f32 ? 4 : 1, per_chunk = 16 / esize;
  const int chunks_per_row = BN / per_chunk;
  for (int c = tid; c < kBM * chunks_per_row; c += kThreads) {
    const int r = c / chunks_per_row, col0 = (c - r * chunks_per_row) * per_chunk;
    const int row = m0 + r, col = n0 + col0;
    if (row >= m || col >= n) continue;
    const uint8_t* src = stage + ((size_t)r * kLdOut + col0) * esize;
    uint8_t* dst = reinterpret_cast<uint8_t*>(out) + ((size_t)row * n + col) * esize;
    if (vec_out && col + per_chunk <= n) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const int bytes = (n - col < per_chunk ? n - col : per_chunk) * esize;
      for (int i = 0; i < bytes; ++i) dst[i] = src[i];
    }
  }
}

// 16-byte stores of the output: N a whole number of chunks and `out` aligned.
inline int vec_out_ok(const void* out, int n, int out_f32) {
  return (n % (out_f32 ? 4 : 16)) == 0 && ((uintptr_t)out % 16) == 0;
}

}  // namespace wg
}  // namespace yolo_int8
