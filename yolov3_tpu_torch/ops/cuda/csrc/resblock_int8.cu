// K4 — one whole int8 Darknet residual block in one launch.
//
// Replaces the Pallas TPU kernel yolov3_tpu/ops/pallas/resblock.py
// (fused_resblock / _kernel). Same contract and the same flat zero-halo
// layout, so blocks chain with one layout change per stage: activations are
// a matrix (B * (H+2) * (W+2), C) s8 whose rows are pixels of the image
// padded by a ring of zeros. Per block:
//   q1  = requant(leaky(acc1 * scale1 + bias1), inv_s1)   1x1 squeeze C -> Cm
//   q1  = 0 on the halo ring
//   q2  = requant(leaky(acc2 * scale2 + bias2), inv_s2)   3x3 expand Cm -> C,
//         as 9 products over q1 shifted by (dy-1)*(W+2) + (dx-1) rows
//   out = requant(x * s_x + q2 * s2, inv_out)             shortcut add
//   out = 0 on the halo ring
// w1 (Cm, C) and w2 (9, C, Cm) are packed with one row per output channel.
//
// What bounds it on an H100: operations (10 * C * Cm products per pixel for
// 2 bytes moved). What the fusion buys is bytes: q1, both s32 accumulators
// and q2 never reach device memory. The TPU kernel kept whole images in
// VMEM; an SM's 227 KB of shared memory cannot (q1 of one 52^2 image at
// Cm = 128 is 373 KB), so a block of threads takes (image, band of R output
// rows, slice of the C output channels):
//   phase 1  computes q1 for the band plus one halo row above and below
//            (the two rows it shares with its neighbours are recomputed)
//            into shared memory, halo pixels written as zero;
//   phase 2  runs the 9 taps as matrix products whose A operand is read
//            straight from that shared q1 (the flat row shift is an address
//            offset), streams the weights of each tap through a staged tile,
//            and finishes with the shortcut epilogue.
// The wrapper picks R and the channel slices so that the q1 band fits and the
// grid fills the card. The first and last band also write the zero halo rows
// of the output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"
#include "requant.cuh"

namespace {

using namespace yolo_int8;

struct Block {
  int h, w, c, cm;
  int band_rows;    // R: output rows per band
  int slice_cols;   // output channels per slice (even)
  int q_rows;       // rows of the shared q1 buffer
};

template <int NF>
__global__ void __launch_bounds__(kThreads, 1)
resblock_int8_kernel(const int8_t* __restrict__ xp, const int8_t* __restrict__ w1,
                     const int8_t* __restrict__ w2, const float* __restrict__ scale1,
                     const float* __restrict__ bias1, const float* __restrict__ scale2,
                     const float* __restrict__ bias2, const float* __restrict__ sc,
                     int8_t* __restrict__ out, Block p) {
  constexpr int BN = NF * 16;
  extern __shared__ __align__(16) int8_t smem[];
  const int ldq = p.cm + 16;
  int8_t* q1 = smem;                               // (q_rows, ldq)
  int8_t* a_s = smem + (size_t)p.q_rows * ldq;     // (kBM, kLd)
  int8_t* b_s = a_s + kBM * kLd;                   // (BN, kLd)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int wp = p.w + 2, hp = p.h + 2;
  const int r0 = 1 + blockIdx.x * p.band_rows;                 // first output row (halo coords)
  const int rb = min(p.band_rows, p.h + 1 - r0);               // rows of this band
  const int c_lo = blockIdx.y * p.slice_cols;
  const int c_hi = min(c_lo + p.slice_cols, p.c);
  const size_t img = (size_t)blockIdx.z * hp * wp;             // first flat row of the image
  const float inv_s1 = sc[0], inv_s2 = sc[1], s2 = sc[2], s_x = sc[3], inv_out = sc[4];

  // the output's zero halo rows, for this block's channel slice
  const bool first = blockIdx.x == 0, last = r0 + rb == p.h + 1;
  if (first || last) {
    const int ncol = c_hi - c_lo;
    for (int e = tid; e < wp * ncol; e += kThreads) {
      const int j = e / ncol, c = c_lo + e - j * ncol;
      if (first) out[(img + j) * p.c + c] = 0;
      if (last) out[(img + (size_t)(hp - 1) * wp + j) * p.c + c] = 0;
    }
  }

  // ---- phase 1: q1 over image-flat rows [f1, f1 + m1), kept at q1 row (1 + j)
  const int f1 = (r0 - 1) * wp, m1 = (rb + 2) * wp;
  const int8_t* x1 = xp + (img + f1) * p.c;
  int acc[2][NF][4];
  for (int mt = 0; mt < m1; mt += kBM) {
    for (int nt = 0; nt < p.cm; nt += BN) {
      zero_acc<NF>(acc);
      for (int k0 = 0; k0 < p.c; k0 += kBK) {
        stage_rows<kBM>(a_s, x1, p.c, mt, m1, k0, p.c, true, tid);
        stage_rows<BN>(b_s, w1, p.c, nt, p.cm, k0, p.c, true, tid);
        __syncthreads();
        warp_mma<NF>(a_s + warp_m * 32 * kLd, kLd, b_s + warp_n * (BN / 2) * kLd, kLd,
                     (p.c - k0) > 32 ? 2 : 1, acc, lane);
        __syncthreads();
      }
      for_each_pair<NF>(acc, warp_m, warp_n, lane, [&](int r, int c, int s0, int s1) {
        const int j = mt + r, col = nt + c;
        if (j >= m1 || col >= p.cm) return;
        const int idx = f1 + j, i = idx / wp, jj = idx - i * wp;
        const bool inside = i >= 1 && i <= p.h && jj >= 1 && jj <= p.w;
        const float y0 = leaky(scale_bias(s0, scale1[col], bias1[col]));
        const float y1 = leaky(scale_bias(s1, scale1[col + 1], bias1[col + 1]));
        int8_t* q = q1 + (size_t)(1 + j) * ldq + col;
        q[0] = inside ? (int8_t)(int)requant_clip(y0, inv_s1) : (int8_t)0;
        q[1] = inside ? (int8_t)(int)requant_clip(y1, inv_s1) : (int8_t)0;
      });
    }
  }
  __syncthreads();

  // ---- phase 2: output image-flat rows [r0 * wp, r0 * wp + m2). Pixel p of
  // the band sits at q1 row (1 + wp + p); its neighbour (dy, dx) at that row
  // plus (dy-1) * wp + (dx-1). Rows 0 and m1 + 1 of q1 are touched only by the
  // halo columns, whose outputs are written as zero whatever they sum.
  const int m2 = rb * wp;
  for (int mt = 0; mt < m2; mt += kBM) {
    for (int nt = c_lo; nt < c_hi; nt += BN) {
      zero_acc<NF>(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3 - 1) * wp + (tap % 3 - 1);
        const int8_t* wt = w2 + (size_t)tap * p.c * p.cm;
        const int8_t* a = q1 + (size_t)(1 + wp + mt + warp_m * 32 + off) * ldq;
        for (int k0 = 0; k0 < p.cm; k0 += kBK) {
          stage_rows<BN>(b_s, wt, p.cm, nt, c_hi, k0, p.cm, true, tid);
          __syncthreads();
          warp_mma<NF>(a + k0, ldq, b_s + warp_n * (BN / 2) * kLd, kLd,
                       (p.cm - k0) > 32 ? 2 : 1, acc, lane);
          __syncthreads();
        }
      }
      for_each_pair<NF>(acc, warp_m, warp_n, lane, [&](int r, int c, int s0, int s1) {
        const int pix = mt + r, col = nt + c;
        if (pix >= m2 || col >= c_hi) return;
        const int jj = pix % wp;
        const bool inside = jj >= 1 && jj <= p.w;
        const size_t at = (img + (size_t)r0 * wp + pix) * p.c + col;
        const float q20 = requant_clip(leaky(scale_bias(s0, scale2[col], bias2[col])), inv_s2);
        const float q21 =
            requant_clip(leaky(scale_bias(s1, scale2[col + 1], bias2[col + 1])), inv_s2);
        const char2 xv = *reinterpret_cast<const char2*>(xp + at);
        const float y0 = __fadd_rn(__fmul_rn((float)xv.x, s_x), __fmul_rn(q20, s2));
        const float y1 = __fadd_rn(__fmul_rn((float)xv.y, s_x), __fmul_rn(q21, s2));
        char2 o = make_char2(0, 0);
        if (inside) {
          o.x = (int8_t)(int)requant_clip(y0, inv_out);
          o.y = (int8_t)(int)requant_clip(y1, inv_out);
        }
        *reinterpret_cast<char2*>(out + at) = o;
      });
    }
  }
}

template <int NF>
int launch(const void* xp, const void* w1, const void* w2, const void* scale1,
           const void* bias1, const void* scale2, const void* bias2, const void* sc, void* out,
           int batch, const Block& p, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(resblock_int8_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.h + p.band_rows - 1) / p.band_rows,
            (p.c + p.slice_cols - 1) / p.slice_cols, batch);
  resblock_int8_kernel<NF><<<grid, kThreads, smem_bytes, stream>>>(
      (const int8_t*)xp, (const int8_t*)w1, (const int8_t*)w2, (const float*)scale1,
      (const float*)bias1, (const float*)scale2, (const float*)bias2, (const float*)sc,
      (int8_t*)out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for a plan (the wrapper sizes its plan with
// the same formula): the q1 band, one A tile and one B tile.
extern "C" int resblock_int8_smem_bytes(int cm, int q_rows, int tile_cols) {
  return q_rows * (cm + 16) + (yolo_int8::kBM + tile_cols) * yolo_int8::kLd;
}

// sc: five f32 on the device, [inv_s1, inv_s2, s2, s_x, inv_out]. tile_cols is
// 64 or 128; needs C % 32 == 0, Cm % 16 == 0, slice_cols even (a multiple of
// tile_cols wastes no tile) and
// q_rows >= round_up(band_rows * (W+2), 128) + 2 * (W+2) + 2. Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int resblock_int8_launch(const void* xp, const void* w1, const void* w2,
                                    const void* scale1, const void* bias1, const void* scale2,
                                    const void* bias2, const void* sc, void* out, int batch,
                                    int h, int w, int c, int cm, int band_rows, int slice_cols,
                                    int q_rows, int tile_cols, void* stream) {
  if (batch == 0) return 0;
  const Block p{h, w, c, cm, band_rows, slice_cols, q_rows};
  const int smem = resblock_int8_smem_bytes(cm, q_rows, tile_cols);
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_cols == 128)
    return launch<8>(xp, w1, w2, scale1, bias1, scale2, bias2, sc, out, batch, p, smem, s);
  if (tile_cols == 64)
    return launch<4>(xp, w1, w2, scale1, bias1, scale2, bias2, sc, out, batch, p, smem, s);
  return (int)cudaErrorInvalidValue;
}
