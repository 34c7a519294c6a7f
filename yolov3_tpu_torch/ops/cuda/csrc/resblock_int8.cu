// K4 — one whole int8 Darknet residual block in one launch, on wgmma.
//
// Replaces the Pallas TPU kernel yolov3_tpu/ops/pallas/resblock.py
// (fused_resblock / _kernel). Same contract and the same flat zero-halo
// layout, so blocks chain with one layout change per stage: activations are
// a matrix (B * (H+2) * (W+2), C) s8 whose rows are pixels of the image
// padded by a ring of zeros. Per block:
//   q1  = requant(leaky(acc1 * scale1 + bias1), inv_s1)   1x1 squeeze C -> Cm
//   q1  = 0 on the halo ring, except on a halo row that holds a
//         neighbouring band's pixels (halo_top / halo_bottom: a band of the
//         spatial split, parallel/spatial.py), where it is the row's squeeze
//   q2  = requant(leaky(acc2 * scale2 + bias2), inv_s2)   3x3 expand Cm -> C,
//         as 9 products over q1 shifted by (dy-1)*(W+2) + (dx-1) rows
//   out = requant(x * s_x + q2 * s2, inv_out)             shortcut add
//   out = 0 on the halo ring
// w1 (Cm, C) and w2 (9, C, Cm) are packed with one row per output channel.
// Every epilogue is requant.cuh's arithmetic in the unfused chain's order
// (requant_int and small_int_float, its conversion-free integer forms), so the
// output is bit-equal to ops/cuda/resblock.py::fused_resblock_plain.
//
// What bounds it on an H100: by operations, 10 * C * Cm products a pixel
// against one byte in and one out per channel (2.84e10 int8 operations at
// 52^2, C = 256, B = 16: 14 us at the dense int8 peak). The fusion keeps q1,
// both s32 sums and q2 out of device memory. An SM's 227 KB of shared memory
// cannot hold q1 of a whole large image (52^2 at Cm = 128 is 373 KB), so the
// work is cut into items (image, band of R output rows, slice of the C output
// channels), and a persistent grid of one block an SM walks them
// (ops/cuda/resblock.py::plan picks R and the slices that fit and take the
// fewest tile steps on the slowest SM). An item:
//   squeeze  the 1x1 conv over the band's (R + 2) * (W+2) flat rows (one halo
//            row above and below, recomputed by the neighbouring band):
//            tiles of 128 rows x BN1 channels, wgmma with both operands from
//            a cp.async ring of four slots, two k-steps in flight; its
//            epilogue writes q1, halo pixels as zero, into a band buffer in
//            shared memory (row pitch round_up(Cm, 32) + 16 bytes: eight rows
//            of 16-byte chunks fall in distinct banks);
//   expand   the 3x3 conv as one contraction of 9 * Cm bytes, tap-major,
//            in k-steps of 128 bytes. The tap shift is a row offset
//            (dy-1) * (W+2) + (dx-1) into the band buffer, which is not a
//            multiple of wgmma's 8-row core matrices, so A is taken from
//            registers: each lane loads its rows with ldmatrix at the shifted
//            address (any row, 16-byte aligned), which lands exactly in
//            wgmma's register fragment for s8 (the m16n8k32 A layout per
//            warp). This keeps one copy of q1; the alternative, a pitch
//            padded to 8 pixels with three dx-shifted copies, would triple
//            the buffer and shrink the bands. The weights of the next four
//            k-steps stream through a six-slot cp.async ring (B from shared
//            memory, 128-byte swizzle, as K3/K6); two k-steps' products are in
//            flight, with two sets of A registers. A k-step spans several taps
//            where Cm < 128 (Cm = 32 at the 208^2 stage: four taps a step,
//            three steps), so the narrow stage multiplies zeros only in its
//            last step;
//   shortcut the expand's epilogue loads this thread's x chunks first (16-byte
//            loads whose latency overlaps the requant of q2), stages q2 in
//            shared memory, adds, requantizes and stores 16 bytes a thread.
// Both rings run on across tiles, so a tile's epilogue overlaps the next
// tile's loads. What the block then waits on (measured by cutting parts out,
// PERF.md, K4) is the epilogues: some 40 f32 and integer operations an output
// element, bit-exact, at eight warps an SM, which is why the requants avoid the
// quarter-rate conversion instructions. The first and last band also write
// the zero halo rows of the output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_wgmma.cuh"
#include "requant.cuh"

// RESBLOCK_CUT leaves one part of the block out, to time what the rest costs
// (ops/cuda/kernel_times.py k4parts builds such variants on their own; the
// library is built with 0): 1 the squeeze, 2 the expand, 3 the expand's
// products, 4 the shortcut epilogue.
#ifndef RESBLOCK_CUT
#define RESBLOCK_CUT 0
#endif

namespace {

using namespace yolo_int8;

// k-steps in flight ahead of the one multiplied, and ring slots: a slot is
// refilled two steps after its products were issued (the wgmma of the step
// before may still read its own), so slots = ahead + 2
constexpr int kSqAhead = 2, kSqSlots = kSqAhead + 2;
constexpr int kExAhead = 4, kExSlots = kExAhead + 2;

struct Block {
  int batch, h, w, c, cm;
  int band_rows;    // R: output rows of a band
  int slice_cols;   // output channels of a slice (a multiple of BN2, or C)
  int bands, slices, items;
  int ldq;          // row pitch of the q1 band buffer, bytes
  int q1_lo, q1_hi; // halo-coordinate rows whose q1 is computed: 1 - halo_top .. h + halo_bottom
};

// One work item: image, band, channel slice.
struct Item {
  size_t img;       // first flat row of the image
  int r0, rb;       // first output row (halo coordinates) and rows of the band
  int f1, m1, m2;   // squeeze rows [f1, f1 + m1) of the image, output pixels m2
  int c_lo, c_hi;   // output channels of the slice
};

// Shared memory of a launch, in this order: the ring (the squeeze's slots of
// (kBM + BN1) x kBK and the expand's of BN2 x kBK take turns in it) with room
// to align it to 1024 bytes, the shortcut's output stage (kBM x (BN2 + 16)),
// and the q1 band buffer of (R + 2) * (W + 2) + 2 rows.
template <int BN1, int BN2>
__host__ __device__ constexpr uint32_t ring_bytes() {
  constexpr uint32_t squeeze = kSqSlots * wg::stage_bytes<BN1>();
  constexpr uint32_t expand = kExSlots * BN2 * wg::kBK;
  return (squeeze > expand ? squeeze : expand) + 1024;
}
template <int BN2>
__host__ __device__ constexpr uint32_t out_stage_bytes() { return wg::kBM * (BN2 + 16); }

// d += A . B^T for one warpgroup, A (64 rows x 32 bytes) from registers in
// the s8 fragment layout (warp w: rows 16w..16w+15; with g = lane / 4,
// t = lane % 4: a[0] row g, bytes 4t..4t+3; a[1] row g + 8; a[2], a[3] the
// same rows at bytes 16 + 4t), B (N rows x 32 bytes) from shared memory.
__device__ __forceinline__ void mma_rs_m64n64k32(int (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void mma_rs_m64n128k32(int (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void mma_rs(int (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(BN == 64 || BN == 128, "tile widths of the expand");
  if constexpr (BN == 64) mma_rs_m64n64k32(d, a, desc_b);
  else mma_rs_m64n128k32(d, a, desc_b);
}

// Four 8x8 matrices of 16-bit elements (8 rows of 16 bytes each) from shared
// memory; lane L gives the address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

template <int N>
__device__ __forceinline__ void keep(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[k][i])::"memory");
}

// ---- squeeze: q1 of the item's image-flat rows [f1, f1 + m1), at q1 row
// 1 + j, halo pixels zero. Tiles (128 rows x BN1 channels of Cm) one after
// the other, each over ceil(C / 128) k-steps of wgmma with both operands from
// the ring; the ring runs on across tiles, so the next tile's first k-steps
// load under this tile's last products and its epilogue.
template <int BN1>
__device__ __forceinline__ void squeeze(uint32_t ring, int8_t* q1, const Block& p,
                                        const Item& it, const int8_t* __restrict__ xp,
                                        const int8_t* __restrict__ w1,
                                        const float* __restrict__ scale1,
                                        const float* __restrict__ bias1, float inv_s1) {
  constexpr uint32_t kStage = wg::stage_bytes<BN1>();
  const int tid = threadIdx.x, chunk = tid & 7, row0 = tid >> 3;
  const int wgi = tid >> 7, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, t = tid & 3;
  const int wp = p.w + 2;
  const int kts = (p.c + wg::kBK - 1) / wg::kBK, nts = (p.cm + BN1 - 1) / BN1;
  const int total = (it.m1 + wg::kBM - 1) / wg::kBM * nts * kts;
  const int8_t* xa = xp + (it.img + it.f1) * p.c;
  auto load = [&](int u) {
    const int tile = u / kts, kt = u - tile * kts, mtile = tile / nts;
    const int mt = mtile * wg::kBM, nt = (tile - mtile * nts) * BN1;
    const uint32_t st = ring + (u % kSqSlots) * kStage;
    const int kk = kt * wg::kBK + chunk * 16;
    const bool k_in = kk < p.c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = mt + row0 + 32 * j;
      const bool ok = k_in && row < it.m1;
      wg::cp_async_16_cg(wg::swizzled(st, row0 + 32 * j, chunk),
                         ok ? xa + (size_t)row * p.c + kk : xp, ok);
    }
#pragma unroll
    for (int j = 0; j < BN1 / 32; ++j) {
      const int r = row0 + 32 * j;
      const bool ok = k_in && nt + r < p.cm;
      wg::cp_async_16_ca(wg::swizzled(st + wg::kBM * wg::kBK, r, chunk),
                         ok ? w1 + (size_t)(nt + r) * p.c + kk : w1, ok);
    }
  };
#pragma unroll
  for (int u = 0; u < kSqAhead; ++u) {
    if (u < total) load(u);
    wg::cp_async_commit();
  }
  const uint32_t a_rows = wgi * 64 * wg::kBK;
  int u = 0;
  for (int tile = 0; u < total; ++tile) {
    int acc[BN1 / 2];
#pragma unroll
    for (int i = 0; i < BN1 / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < kts; ++kt, ++u) {
      wg::cp_async_wait<kSqAhead - 1>();
      wg::fence_proxy_async();
      // step u's tiles are in; every thread has waited for the products of
      // step u - 2, whose slot the load below refills
      __syncthreads();
      if (u + kSqAhead < total) load(u + kSqAhead);
      wg::cp_async_commit();
      const uint32_t st = ring + (u % kSqSlots) * kStage;
      wg::wgmma_fence();
#pragma unroll
      for (int j = 0; j < wg::kBK / 32; ++j)
        wg::mma_k32<BN1>(acc, wg::tile_desc(st + a_rows + 32 * j),
                         wg::tile_desc(st + wg::kBM * wg::kBK + 32 * j));
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
    }
    wg::wgmma_wait<0>();
    keep(acc);
    const int mtile = tile / nts;
    const int mt = mtile * wg::kBM, nt = (tile - mtile * nts) * BN1;
    bool valid[2], inside[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int jr = mt + 64 * wgi + 16 * warp + g + 8 * hh;
      const int idx = it.f1 + jr, i = idx / wp, jj = idx - i * wp;
      valid[hh] = jr < it.m1;
      inside[hh] = i >= p.q1_lo && i <= p.q1_hi && jj >= 1 && jj <= p.w;
    }
#pragma unroll
    for (int j = 0; j < BN1 / 8; ++j) {
      const int col = nt + 8 * j + 2 * t;
      if (col >= p.cm) continue;
      const float sc0 = scale1[col], sc1 = scale1[col + 1], b0 = bias1[col], b1 = bias1[col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!valid[hh]) continue;
        uint32_t q = 0;
        if (inside[hh]) {
          const int q0 = requant_int(leaky(scale_bias(acc[4 * j + 2 * hh], sc0, b0)), inv_s1);
          const int q1v = requant_int(leaky(scale_bias(acc[4 * j + 2 * hh + 1], sc1, b1)), inv_s1);
          q = (uint32_t)(q0 & 0xff) | ((uint32_t)(q1v & 0xff) << 8);
        }
        const int jr = mt + 64 * wgi + 16 * warp + g + 8 * hh;
        *reinterpret_cast<uint16_t*>(q1 + (size_t)(1 + jr) * p.ldq + col) = (uint16_t)q;
      }
    }
  }
}

// ---- expand + shortcut: output image-flat rows [r0 * wp, r0 * wp + m2),
// tiles of 128 pixels x BN2 channels of the slice, each over the 9 * Cm
// tap-major contraction in k-steps of 128 bytes; A (q1 at the tap's shifted
// rows) from registers by ldmatrix, B (w2) through the ring, which runs on
// across tiles. Pixel p of the band sits at q1 row 1 + wp + p; its neighbour
// (dy, dx) at that row plus (dy-1) * wp + (dx-1). Rows 0 and m1 + 1 of q1 are
// read only for halo columns, and pixels past the band read pixel 0's rows:
// their outputs are never stored or stored as zero.
template <int BN2>
__device__ __forceinline__ void expand(uint32_t ring, uint32_t q1s, uint8_t* ostage,
                                       const Block& p, const Item& it,
                                       const int8_t* __restrict__ xp,
                                       const int8_t* __restrict__ w2,
                                       const float* __restrict__ scale2,
                                       const float* __restrict__ bias2, float inv_s2, float s2,
                                       float s_x, float inv_out, int8_t* __restrict__ out) {
  constexpr uint32_t kStage = BN2 * wg::kBK;
  constexpr int kLdOut = BN2 + 16;
  constexpr int kChunks = BN2 / 16;                                  // 16-byte chunks a row
  constexpr int kPer = wg::kBM * kChunks / wg::kThreads;             // a thread's chunks
  const int tid = threadIdx.x, lane = tid & 31, chunk = tid & 7, row0 = tid >> 3;
  const int wgi = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int wp = p.w + 2, kall = 9 * p.cm;
  const int steps = (kall + wg::kBK - 1) / wg::kBK;
  const int nts = (it.c_hi - it.c_lo + BN2 - 1) / BN2;
  const int total = (it.m2 + wg::kBM - 1) / wg::kBM * nts * steps;
  // q / Cm for a contraction index q < 9 * Cm: (q + 1/2) / Cm lies at least
  // 1 / (2 Cm) from an integer, far beyond float's error at these sizes
  const float inv_cm = 1.0f / (float)p.cm;
  auto tap_of = [&](int q) { return (int)(((float)q + 0.5f) * inv_cm); };
  // this thread copies 16-byte chunk `chunk` of weight rows row0 + 32 j of a
  // step: contraction bytes q .. q + 15 lie inside one tap (Cm % 16 == 0)
  auto load = [&](int u) {
    const int tile = u / steps, s = u - tile * steps;
    const int nt = it.c_lo + (tile % nts) * BN2;
    const uint32_t st = ring + (u % kExSlots) * kStage;
    const int q = s * wg::kBK + chunk * 16;
    const bool k_in = q < kall;
    const int tap = k_in ? tap_of(q) : 0;
    const int8_t* wt = w2 + (size_t)tap * p.c * p.cm + (q - tap * p.cm);
#pragma unroll
    for (int j = 0; j < BN2 / 32; ++j) {
      const int r = row0 + 32 * j;
      const bool ok = k_in && nt + r < it.c_hi;
      wg::cp_async_16_ca(wg::swizzled(st, r, chunk), ok ? wt + (size_t)(nt + r) * p.cm : w2,
                         ok);
    }
  };
#pragma unroll
  for (int u = 0; u < kExAhead; ++u) {
    if (u < total) load(u);
    wg::cp_async_commit();
  }
  const int khalf = (lane >> 4) * 16;
  int u = 0;
  for (int tile = 0; u < total; ++tile) {
    const int mt = tile / nts * wg::kBM, nt = it.c_lo + (tile % nts) * BN2;
    const int pix = mt + 64 * wgi + 16 * warp + (lane & 15);
    const int a_row = 1 + wp + (pix < it.m2 ? pix : 0);
    int acc[BN2 / 2];
#pragma unroll
    for (int i = 0; i < BN2 / 2; ++i) acc[i] = 0;
    uint32_t a0[4][4], a1[4][4];
    // one k-step: its weights landed, the next ones' loads issued, A loaded at
    // the tap's shift, four products issued; on return the step before is done
    auto step = [&](uint32_t (&a)[4][4], uint32_t (&before)[4][4], int s) {
      wg::cp_async_wait<kExAhead - 1>();
      wg::fence_proxy_async();
      __syncthreads();
      if (u + kExAhead < total) load(u + kExAhead);
      wg::cp_async_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        int q = s * wg::kBK + kk * 32 + khalf;
        if (q >= kall) q = 0;   // the weights are zero there: any readable row will do
        const int tap = tap_of(q);
        const int off = (tap / 3 - 1) * wp + (tap % 3 - 1);
        ldmatrix_x4(a[kk], q1s + (uint32_t)((a_row + off) * p.ldq + (q - tap * p.cm)));
      }
      wg::wgmma_fence();
      const uint32_t st = ring + (u % kExSlots) * kStage;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if constexpr (RESBLOCK_CUT != 3) mma_rs<BN2>(acc, a[kk], wg::tile_desc(st + 32 * kk));
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
      keep(before);   // the step before has read its A: its registers are free
      ++u;
    };
    int s = 0;
    for (; s + 1 < steps; s += 2) {
      step(a0, a1, s);
      step(a1, a0, s + 1);
    }
    if (s < steps) step(a0, a1, s);
    wg::wgmma_wait<0>();
    keep(acc);
    keep(a0);
    keep(a1);

    if constexpr (RESBLOCK_CUT != 4) {
      // the shortcut: this thread's x chunks first (their latency overlaps the
      // requant of q2 below), q2 through the output stage, then 16-byte stores
      uint4 xv[kPer];
      bool in_img[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * wg::kThreads, r = e / kChunks, c0 = (e - r * kChunks) * 16;
        const int px = mt + r, col = nt + c0, jj = px % wp;
        in_img[i] = px < it.m2 && col < it.c_hi && jj >= 1 && jj <= p.w;
        xv[i] = in_img[i] ? *reinterpret_cast<const uint4*>(
                                xp + (it.img + (size_t)it.r0 * wp + px) * p.c + col)
                          : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < BN2 / 8; ++j) {
        const int cc = 8 * j + 2 * t, col = nt + cc;
        if (col >= it.c_hi) continue;
        const float sc0 = scale2[col], sc1 = scale2[col + 1], b0 = bias2[col], b1 = bias2[col + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 64 * wgi + 16 * warp + g + 8 * hh;
          const int q0 = requant_int(leaky(scale_bias(acc[4 * j + 2 * hh], sc0, b0)), inv_s2);
          const int q1v = requant_int(leaky(scale_bias(acc[4 * j + 2 * hh + 1], sc1, b1)), inv_s2);
          *reinterpret_cast<uint16_t*>(ostage + r * kLdOut + cc) =
              (uint16_t)((q0 & 0xff) | ((q1v & 0xff) << 8));
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * wg::kThreads, r = e / kChunks, c0 = (e - r * kChunks) * 16;
        const int px = mt + r, col = nt + c0;
        if (px >= it.m2 || col >= it.c_hi) continue;
        uint4 o = make_uint4(0, 0, 0, 0);
        if (in_img[i]) {
          const uint4 qv = *reinterpret_cast<const uint4*>(ostage + r * kLdOut + c0);
          const uint32_t xw[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
          const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
          uint32_t ow[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            ow[k] = 0;
#pragma unroll
            for (int byte = 0; byte < 4; ++byte) {
              // the signed bytes as ints by arithmetic shifts, then as f32
              const int xi = (int)(xw[k] << (24 - 8 * byte)) >> 24;
              const int qi = (int)(qw[k] << (24 - 8 * byte)) >> 24;
              const float y = __fadd_rn(__fmul_rn(small_int_float(xi), s_x),
                                        __fmul_rn(small_int_float(qi), s2));
              ow[k] |= (uint32_t)(requant_int(y, inv_out) & 0xff) << (8 * byte);
            }
          }
          o = make_uint4(ow[0], ow[1], ow[2], ow[3]);
        }
        *reinterpret_cast<uint4*>(out + (it.img + (size_t)it.r0 * wp + px) * p.c + col) = o;
      }
    }
    // the output stage is next written after the next tile's first k-step,
    // whose barrier every thread passes only when done reading it here
  }
}

template <int BN1, int BN2>
__global__ void __launch_bounds__(wg::kThreads, 1)
resblock_int8_kernel(const int8_t* __restrict__ xp, const int8_t* __restrict__ w1,
                     const int8_t* __restrict__ w2, const float* __restrict__ scale1,
                     const float* __restrict__ bias1, const float* __restrict__ scale2,
                     const float* __restrict__ bias2, const float* __restrict__ inv_s1_p,
                     const float* __restrict__ inv_s2_p, const float* __restrict__ s2_p,
                     const float* __restrict__ s_x_p, const float* __restrict__ inv_out_p,
                     int8_t* __restrict__ out, Block p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const ostage = smem_raw + ring_bytes<BN1, BN2>();
  int8_t* const q1 =
      reinterpret_cast<int8_t*>(smem_raw + ring_bytes<BN1, BN2>() + out_stage_bytes<BN2>());
  const uint32_t q1s = raw + ring_bytes<BN1, BN2>() + out_stage_bytes<BN2>();

  const int tid = threadIdx.x;
  const int wp = p.w + 2, hp = p.h + 2;
  const float inv_s1 = *inv_s1_p, inv_s2 = *inv_s2_p, s2 = *s2_p, s_x = *s_x_p;
  const float inv_out = *inv_out_p;

  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int slice = item % p.slices, band = (item / p.slices) % p.bands;
    Item it;
    it.img = (size_t)(item / (p.slices * p.bands)) * hp * wp;
    it.r0 = 1 + band * p.band_rows;
    it.rb = min(p.band_rows, p.h + 1 - it.r0);
    it.f1 = (it.r0 - 1) * wp;
    it.m1 = (it.rb + 2) * wp;
    it.m2 = it.rb * wp;
    it.c_lo = slice * p.slice_cols;
    it.c_hi = min(it.c_lo + p.slice_cols, p.c);

    // the output's zero halo rows, for this item's channel slice
    if (band == 0 || band == p.bands - 1) {
      const int n16 = (it.c_hi - it.c_lo) / 16;
      for (int e = tid; e < wp * n16; e += wg::kThreads) {
        const int j = e / n16, col = it.c_lo + (e - j * n16) * 16;
        if (band == 0)
          *reinterpret_cast<uint4*>(out + (it.img + j) * p.c + col) = make_uint4(0, 0, 0, 0);
        if (band == p.bands - 1)
          *reinterpret_cast<uint4*>(out + (it.img + (size_t)(hp - 1) * wp + j) * p.c + col) =
              make_uint4(0, 0, 0, 0);
      }
    }
    if constexpr (RESBLOCK_CUT != 1) squeeze<BN1>(ring, q1, p, it, xp, w1, scale1, bias1, inv_s1);
    __syncthreads();   // q1 of the band is complete; the ring is free
    if constexpr (RESBLOCK_CUT != 2)
      expand<BN2>(ring, q1s, ostage, p, it, xp, w2, scale2, bias2, inv_s2, s2, s_x, inv_out, out);
    __syncthreads();   // every thread is done with q1 and the ring
  }
}

// ops/cuda/resblock.py::smem_bytes repeats the shared-memory formula.
template <int BN1, int BN2>
int launch(const void* const* ptrs, void* out, const Block& p, cudaStream_t stream) {
  auto kernel = resblock_int8_kernel<BN1, BN2>;
  const int smem = (int)(ring_bytes<BN1, BN2>() + out_stage_bytes<BN2>()) +
                   ((p.band_rows + 2) * (p.w + 2) + 2) * p.ldq;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.items < wg::kSms ? p.items : wg::kSms;
  const auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  kernel<<<grid, wg::kThreads, smem, stream>>>(
      (const int8_t*)ptrs[0], (const int8_t*)ptrs[1], (const int8_t*)ptrs[2], f(3), f(4), f(5),
      f(6), f(7), f(8), f(9), f(10), f(11), (int8_t*)out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// inv_s1, inv_s2, s2, s_x, inv_out: one f32 each on the device. Needs
// C % 32 == 0, Cm % 16 == 0, 16-byte aligned xp, w1, w2 and out, the tile
// widths (bn1 over Cm for the squeeze, bn2 over C for the expand) one of the
// pairs Darknet-53's blocks take: 32 x 64 (C = 64, Cm = 32), 64 x 128
// (C = 128, Cm = 64) or 128 x 128 (C >= 256), and slice_cols a multiple of
// bn2 or C itself. halo_top / halo_bottom (0 or 1): that halo row holds a
// neighbouring band's pixels, whose q1 the expand reads. The grid is one block
// an SM (132) or one a work item, if fewer. Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int resblock_int8_launch(const void* xp, const void* w1, const void* w2,
                                    const void* scale1, const void* bias1, const void* scale2,
                                    const void* bias2, const void* inv_s1, const void* inv_s2,
                                    const void* s2, const void* s_x, const void* inv_out,
                                    void* out, int batch, int h, int w, int c, int cm,
                                    int band_rows, int slice_cols, int bn1, int bn2,
                                    int halo_top, int halo_bottom, void* stream) {
  if (batch == 0) return 0;
  if (c % 32 || cm % 16 || band_rows < 1 || slice_cols < 1 || (halo_top | halo_bottom) & ~1 ||
      (slice_cols != c && slice_cols % bn2) ||
      (((uintptr_t)xp | (uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)out) % 16))
    return (int)cudaErrorInvalidValue;
  Block p{batch, h, w, c, cm, band_rows, slice_cols, 0, 0, 0, (cm + 31) / 32 * 32 + 16,
          1 - halo_top, h + halo_bottom};
  p.bands = (h + band_rows - 1) / band_rows;
  p.slices = (c + slice_cols - 1) / slice_cols;
  p.items = batch * p.bands * p.slices;
  const void* ptrs[] = {xp, w1, w2, scale1, bias1, scale2, bias2, inv_s1, inv_s2, s2, s_x,
                        inv_out};
  cudaStream_t s = (cudaStream_t)stream;
#define K4_LAUNCH(A, B) \
  if (bn1 == A && bn2 == B) return launch<A, B>(ptrs, out, p, s);
  K4_LAUNCH(32, 64) K4_LAUNCH(64, 128) K4_LAUNCH(128, 128)
#undef K4_LAUNCH
  return (int)cudaErrorInvalidValue;
}
