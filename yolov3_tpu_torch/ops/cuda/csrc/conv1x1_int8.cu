// K3 — fused int8 1x1 conv: matrix product + requant epilogue in one launch.
//
// Replaces the Pallas TPU kernel yolov3_tpu/ops/pallas/conv1x1.py
// (conv1x1_int8_requant / _kernel). Contract:
//   acc = x (M, K) s8  .  w (N, K) s8 ^T          s32, exact
//   y   = f32(acc) * scale[n] + bias[n];  y = leaky(y) if asked
//   out = s8(requant_clip(y, *inv))   or   out = y (f32)
// x is the NHWC activation as a matrix (M = B*H*W rows, K = Cin), w the
// packed weight with one row per output channel.
//
// What bounds it on an H100: bytes for the Darknet squeeze convs at high
// resolution (M = 692,224, 64 -> 32: 66 MB moved for 2.8 GOP), operations
// for the deep ones (M = 2,704, 1024 -> 512). The design keeps the s32
// sums in registers from the first product to the int8 store, so device
// memory sees each activation byte once in and once out, which is all the
// TPU kernel was written to achieve. The products run on the tensor cores
// (mma.sync m16n8k32) from tiles staged in shared memory; there is no
// asynchronous copy or pipelining yet, two blocks per SM overlap each
// other's loads. M, K and N may be ragged: tiles are zero-filled on load
// and masked on store. The TPU kernel's VMEM tile picking and its lane
// gates (MIN_CIN / MIN_COUT) have no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"
#include "requant.cuh"

namespace {

using namespace yolo_int8;

template <int NF>
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const float* __restrict__ inv_ptr, void* __restrict__ out, int m, int k,
                    int n, int leaky_on, int out_f32) {
  constexpr int BN = NF * 16;
  __shared__ __align__(16) int8_t a_s[kBM * kLd];
  __shared__ __align__(16) int8_t b_s[BN * kLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const bool vec = (k % 16) == 0;

  int acc[2][NF][4];
  zero_acc<NF>(acc);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    stage_rows<kBM>(a_s, x, k, m0, m, k0, k, vec, tid);
    stage_rows<BN>(b_s, w, k, n0, n, k0, k, vec, tid);
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
           void* out, int m, int k, int n, int leaky_on, int out_f32, cudaStream_t stream) {
  dim3 grid((m + kBM - 1) / kBM, (n + NF * 16 - 1) / (NF * 16));
  conv1x1_int8_kernel<NF><<<grid, kThreads, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)scale, (const float*)bias,
      (const float*)inv, out, m, k, n, leaky_on, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int conv1x1_int8_launch(const void* x, const void* w, const void* scale,
                                   const void* bias, const void* inv, void* out, int m, int k,
                                   int n, int leaky_on, int out_f32, void* stream) {
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 64) return launch<8>(x, w, scale, bias, inv, out, m, k, n, leaky_on, out_f32, s);
  if (n > 32) return launch<4>(x, w, scale, bias, inv, out, m, k, n, leaky_on, out_f32, s);
  return launch<2>(x, w, scale, bias, inv, out, m, k, n, leaky_on, out_f32, s);
}
