// Device helpers of the element-wise kernels, K7 (bn_leaky.cu) and K8
// (bias_act.cu): the rounding of an f32 value to x's dtype T (f32 or bf16,
// round to nearest even, as PyTorch's casts), the conversions, and loads and
// stores of V elements, one 16-byte access when V > 1.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace elementwise {

template <typename T> __device__ __forceinline__ float rn(float v);
template <> __device__ __forceinline__ float rn<float>(float v) { return v; }
template <> __device__ __forceinline__ float rn<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements at p: one 16-byte access when V > 1 (the caller checked the
// alignment), else one element.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, T (&v)[V]) {
  if constexpr (V > 1) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
  } else {
    v[0] = *p;
  }
}
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const T (&v)[V]) {
  if constexpr (V > 1) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  } else {
    *p = v[0];
  }
}

}  // namespace elementwise
