// K0 — the shared int8 epilogue of the int8 kernels (K3 conv1x1_int8.cu,
// K4 resblock_int8.cu, K6 conv_int8.cu). K4 takes the integer forms
// requant_int and small_int_float, bit-identical to requant_clip and (float).
//
// Counterpart of yolov3_tpu/ops/pallas/common.py (leaky, requant_clip): one
// definition of the requant contract — LeakyReLU slope 0.1, round half to
// even, clip to the symmetric int8 range [-127, 127] — so the kernels stay
// bit-compatible with the unfused path (models/layers.py: requantize,
// add_requant) and with their plain PyTorch versions. Every product and sum
// is a separate IEEE round-to-nearest operation (__fmul_rn / __fadd_rn are
// never contracted into an fma), as element-wise PyTorch ops are.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace yolo_int8 {

// f32(acc) * scale + bias: the s32 sum is converted once (round to nearest
// even, exact below 2^24), then two roundings.
__device__ __forceinline__ float scale_bias(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

// LeakyReLU(0.1) on an f32 value.
__device__ __forceinline__ float leaky(float y) {
  return y >= 0.0f ? y : __fmul_rn(y, 0.1f);
}

// f32 -> the symmetric int8 lattice (rint = round half to even, clip +-127),
// kept as f32; callers cast to int8 where the value leaves the kernel.
__device__ __forceinline__ float requant_clip(float y, float inv_scale) {
  return fminf(fmaxf(rintf(__fmul_rn(y, inv_scale)), -127.0f), 127.0f);
}

// The same requant as an int in [-127, 127], bit-identical to
// (int)requant_clip(y, inv_scale) for every f32 y, NaN and +-inf included,
// but with no conversion instruction (those run at a quarter of the f32
// rate). y * inv_scale is first clamped to [-128, 128], which changes no
// result: 127.5 still rounds to 128 and clips to 127, and NaN becomes -128
// and then -127, as requant_clip's fmaxf makes it. The rounding half to even
// is the f32 addition of 1.5 * 2^23, whose ulp is 1; the sum's low bits are
// the integer. tests/test_torch_kernel_plans.py replays it in numpy.
__device__ __forceinline__ int requant_int(float y, float inv_scale) {
  const float t = fminf(fmaxf(__fmul_rn(y, inv_scale), -128.0f), 128.0f);
  const int r = __float_as_int(__fadd_rn(t, 12582912.0f)) - 0x4B400000;
  return max(-127, min(127, r));
}

// The f32 value of an integer |v| <= 2^22, exactly, without a conversion
// instruction: the bits of 1.5 * 2^23 + v, less 1.5 * 2^23.
__device__ __forceinline__ float small_int_float(int v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.0f);
}

// The whole conv epilogue (K3, K6) for one pair of adjacent output channels
// whose s32 sums are s0, s1: scale, bias, optional leaky, then either the f32
// values or their int8 requantization, stored at out[at], out[at + 1].
// `scale` and `bias` point at the first channel of the pair; `two` says the
// second channel exists, `vec2` that the pair may go out as one store.
__device__ __forceinline__ void conv_epilogue_pair(void* out, size_t at, bool two, bool vec2,
                                                   int s0, int s1, const float* scale,
                                                   const float* bias, int leaky_on,
                                                   int out_f32, float inv) {
  float y0 = scale_bias(s0, scale[0], bias[0]);
  float y1 = two ? scale_bias(s1, scale[1], bias[1]) : 0.0f;
  if (leaky_on) {
    y0 = leaky(y0);
    y1 = leaky(y1);
  }
  if (out_f32) {
    float* o = reinterpret_cast<float*>(out) + at;
    if (two && vec2) {
      *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
    } else {
      o[0] = y0;
      if (two) o[1] = y1;
    }
  } else {
    int8_t* o = reinterpret_cast<int8_t*>(out) + at;
    const int8_t q0 = (int8_t)(int)requant_clip(y0, inv);
    const int8_t q1 = (int8_t)(int)requant_clip(y1, inv);
    if (two && vec2) {
      *reinterpret_cast<char2*>(o) = make_char2(q0, q1);
    } else {
      o[0] = q0;
      if (two) o[1] = q1;
    }
  }
}

}  // namespace yolo_int8
