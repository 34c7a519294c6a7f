// K6 — int8 k x k conv over NHWC as an implicit GEMM, with K3's epilogue.
//
// The JAX package has no Pallas kernel here: its int8 3x3 and strided convs
// are XLA's convolution (yolov3_tpu/models/layers.py, conv2d_int8, the
// lax.conv_general_dilated branch, lines 256-270). PyTorch has no int8
// convolution on CUDA, so the port needs this kernel for the int8 tier to
// run on the card at all. Contract:
//   acc[b,oh,ow,n] = sum over (dy,dx,ci) of
//       x[b, oh*s - top + dy, ow*s - left + dx, ci] * w[n, dy, dx, ci]
//   (x reads as zero outside the image), then
//   y = f32(acc) * scale[n] + bias[n];  y = leaky(y) if asked
//   out = s8(requant_clip(y, *inv))   or   out = y (f32)
// x (B,H,W,Cin) s8, w (N,kh,kw,Cin) s8 (one row of kh*kw*Cin contraction
// bytes per output channel, tap-major), out (B,Ho,Wo,N).
//
// What bounds it on an H100: operations (a 3x3 conv does 9*Cin products per
// output byte) except for the stem convs at 416^2. The design never builds
// the im2col matrix in device memory: a block gathers its (128 rows x 64
// contraction bytes) A-tile straight from the image into shared memory,
// computing each element's (ih, iw) and writing zero outside, and multiplies
// it on the tensor cores with the main loop it shares with K3
// (int8_mma.cuh). When Cin is a multiple of 16 a 16-byte chunk of the
// contraction lies inside one tap and is one vector load; otherwise (Cin = 3,
// the image) the gather goes byte by byte and the contraction is padded to
// the tile with zeros in shared memory, never in the activations. Any
// kh = kw, stride, asymmetric padding and ragged M / N work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"
#include "requant.cuh"

namespace {

using namespace yolo_int8;

struct Geom {
  int h, w, cin, kw, stride, top, left, ho, wo;
};

// Row m of the implicit matrix -> (pointer to the image of its batch
// element, ih0, iw0): the input position of tap (0, 0).
struct RowOrigin {
  const int8_t* img;
  int ih0, iw0;
  bool valid;
};

__device__ __forceinline__ RowOrigin row_origin(const int8_t* x, const Geom& g, int row, int m) {
  RowOrigin o;
  o.valid = row < m;
  const int r = o.valid ? row : 0;
  const int ow = r % g.wo, t = r / g.wo;
  const int oh = t % g.ho, b = t / g.ho;
  o.img = x + (size_t)b * g.h * g.w * g.cin;
  o.ih0 = oh * g.stride - g.top;
  o.iw0 = ow * g.stride - g.left;
  return o;
}

template <int NF>
__global__ void __launch_bounds__(kThreads, 2)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 const float* __restrict__ inv_ptr, void* __restrict__ out, Geom g, int m, int k,
                 int n, int leaky_on, int out_f32) {
  constexpr int BN = NF * 16;
  __shared__ __align__(16) int8_t a_s[kBM * kLd];
  __shared__ __align__(16) int8_t b_s[BN * kLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const bool vec_a = (g.cin % 16) == 0, vec_b = (k % 16) == 0;

  // vector gather: this thread owns 16-byte chunk (tid & 3) of rows
  // tid / 4 and tid / 4 + 64 of the tile, for every step of the contraction
  RowOrigin own[2];
  if (vec_a) {
    own[0] = row_origin(x, g, m0 + (tid >> 2), m);
    own[1] = row_origin(x, g, m0 + (tid >> 2) + 64, m);
  }

  int acc[2][NF][4];
  zero_acc<NF>(acc);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    if (vec_a) {
      const int kk = k0 + (tid & 3) * 16;
      const int tap = kk / g.cin, ci = kk - tap * g.cin;
      const int dy = tap / g.kw, dx = tap - dy * g.kw;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ih = own[i].ih0 + dy, iw = own[i].iw0 + dx;
        int4 v = make_int4(0, 0, 0, 0);
        if (own[i].valid && kk < k && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
          v = *reinterpret_cast<const int4*>(own[i].img + ((size_t)ih * g.w + iw) * g.cin + ci);
        *reinterpret_cast<int4*>(a_s + ((tid >> 2) + i * 64) * kLd + (tid & 3) * 16) = v;
      }
    } else {
      // byte gather: this thread owns contraction byte (tid & 63) of rows
      // tid / 64 + 4 j
      const int kk = k0 + (tid & 63);
      const int tap = kk / g.cin, ci = kk - tap * g.cin;
      const int dy = tap / g.kw, dx = tap - dy * g.kw;
      for (int r = tid >> 6; r < kBM; r += kThreads / 64) {
        const RowOrigin o = row_origin(x, g, m0 + r, m);
        const int ih = o.ih0 + dy, iw = o.iw0 + dx;
        int8_t v = 0;
        if (o.valid && kk < k && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
          v = o.img[((size_t)ih * g.w + iw) * g.cin + ci];
        a_s[r * kLd + (tid & 63)] = v;
      }
    }
    stage_rows<BN>(b_s, w, k, n0, n, k0, k, vec_b, tid);
    __syncthreads();
    const int kfrags = (k - k0) > 32 ? 2 : 1;
    warp_mma<NF>(a_s + warp_m * 32 * kLd, kLd, b_s + warp_n * (BN / 2) * kLd, kLd, kfrags,
                 acc, lane);
    __syncthreads();
  }

  const float inv = out_f32 ? 0.0f : *inv_ptr;
  const bool pair_ok = (n % 2) == 0;
  for_each_pair<NF>(acc, warp_m, warp_n, lane, [&](int r, int c, int s0, int s1) {
    const int row = m0 + r, col = n0 + c;
    if (row >= m || col >= n) return;
    conv_epilogue_pair(out, (size_t)row * n + col, col + 1 < n, pair_ok, s0, s1, scale + col,
                       bias + col, leaky_on, out_f32, inv);
  });
}

template <int NF>
int launch(const void* x, const void* w, const void* scale, const void* bias, const void* inv,
           void* out, const Geom& g, int m, int k, int n, int flags, cudaStream_t stream) {
  dim3 grid((m + kBM - 1) / kBM, (n + NF * 16 - 1) / (NF * 16));
  conv_int8_kernel<NF><<<grid, kThreads, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)scale, (const float*)bias,
      (const float*)inv, out, g, m, k, n, flags & 1, (flags >> 1) & 1);
  return (int)cudaGetLastError();
}

}  // namespace

// flags: bit 0 = leaky, bit 1 = f32 output. Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int conv_int8_launch(const void* x, const void* w, const void* scale,
                                const void* bias, const void* inv, void* out, int batch, int h,
                                int wd, int cin, int cout, int kh, int kw, int stride, int top,
                                int left, int ho, int wo, int flags, void* stream) {
  const int m = batch * ho * wo, k = kh * kw * cin;
  if (m == 0 || cout == 0) return 0;
  const Geom g{h, wd, cin, kw, stride, top, left, ho, wo};
  cudaStream_t s = (cudaStream_t)stream;
  if (cout > 64) return launch<8>(x, w, scale, bias, inv, out, g, m, k, cout, flags, s);
  if (cout > 32) return launch<4>(x, w, scale, bias, inv, out, g, m, k, cout, flags, s);
  return launch<2>(x, w, scale, bias, inv, out, g, m, k, cout, flags, s);
}
