// K5 — training-mode BatchNorm statistics: per-channel sum and sum of squares
// in one read of the activation, and the backward of (mean, biased variance).
//
// Replaces the Pallas TPU kernel yolov3_tpu/ops/pallas/bn_stats.py (bn_sums /
// _kernel, and the custom VJP of bn_moments). Contract:
//   forward   sum[c]   = sum over every non-channel position of f32(x)
//             sumsq[c] = sum of f32(x)^2                       f32 accumulation
//   backward  a[c] = dvar[c] * (2/n);  b[c] = dmean[c] * (1/n) - a[c] * mean[c]
//             dx = T(a[c] * f32(x) + b[c])                     two roundings + cast
// x is f32 or bf16, a dense 4-D activation that is logically (B, C, H, W) and
// lies in memory either channels-last (rows of C, `rows` = B*H*W of them) or
// as NCHW planes (B*C runs of `hw` = H*W elements).
//
// What bounds it on an H100: bytes. The forward reads x once (354 MB in f32 at
// B=16, 416^2, C=32) for two flops an element, the backward reads x and writes
// dx. So the design is about the read: every warp load covers neighbouring
// addresses in both layouts, each block keeps its sums in registers over many
// rows, and x is never copied or converted beforehand.
//
// The TPU kernel carried its sums from grid step to grid step in a revisited
// output block; blocks here run in no order, so each writes its partial sums
// to scratch and a second launch folds them. Every order is fixed by the
// shape (thread-serial, then a shared-memory or shuffle tree, then the fold):
// no atomics, and two launches on one input give the same bits. The TPU
// kernel's 128-lane folding of narrow channels has no counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerPass = 8;   // channels-last block: 32 channels x 8 rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Channels-last: block (32, 8) takes 32 channels and rows [r0, r1); thread
// (tx, ty) walks rows r0+ty, r0+ty+8, ... of channel tx. A warp reads 32
// neighbouring channels of one row. partial is [P][2][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_sums_cl_kernel(const T* __restrict__ x, float* __restrict__ partial, long long rows, int c,
                  int rows_per_block) {
  __shared__ float sh_s[kRowsPerPass][32];
  __shared__ float sh_q[kRowsPerPass][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.y * 32 + tx;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  long long r1 = r0 + rows_per_block;
  if (r1 > rows) r1 = rows;
  float s = 0.0f, q = 0.0f;
  if (ch < c) {
    const T* p = x + ch;
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += kRowsPerPass) {
      const float v = to_f32(p[r * c]);
      s = __fadd_rn(s, v);
      q = __fadd_rn(q, __fmul_rn(v, v));
    }
  }
  sh_s[ty][tx] = s;
  sh_q[ty][tx] = q;
  __syncthreads();
  if (ty == 0 && ch < c) {
    float ts = sh_s[0][tx], tq = sh_q[0][tx];
#pragma unroll
    for (int j = 1; j < kRowsPerPass; ++j) {
      ts = __fadd_rn(ts, sh_s[j][tx]);
      tq = __fadd_rn(tq, sh_q[j][tx]);
    }
    float* out = partial + (size_t)blockIdx.x * 2 * c;
    out[ch] = ts;
    out[c + ch] = tq;
  }
}

// NCHW planes: block (channel, split) reads elements [i0, i1) of that
// channel's plane in every image. partial is [S][2][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_sums_planes_kernel(const T* __restrict__ x, float* __restrict__ partial, int b, int c, int hw,
                      int chunk) {
  __shared__ float sh_s[kThreads / 32];
  __shared__ float sh_q[kThreads / 32];
  const int ch = blockIdx.x, tid = threadIdx.x;
  const int i0 = blockIdx.y * chunk;
  int i1 = i0 + chunk;
  if (i1 > hw) i1 = hw;
  float s = 0.0f, q = 0.0f;
  for (int n = 0; n < b; ++n) {
    const T* p = x + ((size_t)n * c + ch) * hw;
#pragma unroll 4
    for (int i = i0 + tid; i < i1; i += kThreads) {
      const float v = to_f32(p[i]);
      s = __fadd_rn(s, v);
      q = __fadd_rn(q, __fmul_rn(v, v));
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, d));
    q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, d));
  }
  if ((tid & 31) == 0) {
    sh_s[tid >> 5] = s;
    sh_q[tid >> 5] = q;
  }
  __syncthreads();
  if (tid == 0) {
    float ts = sh_s[0], tq = sh_q[0];
#pragma unroll
    for (int j = 1; j < kThreads / 32; ++j) {
      ts = __fadd_rn(ts, sh_s[j]);
      tq = __fadd_rn(tq, sh_q[j]);
    }
    float* out = partial + (size_t)blockIdx.y * 2 * c;
    out[ch] = ts;
    out[c + ch] = tq;
  }
}

// Fold the P partial rows: one warp per output column (2*C of them), lanes
// stride over P, then a shuffle tree. out is [2][C].
__global__ void __launch_bounds__(kThreads)
bn_fold_kernel(const float* __restrict__ partial, float* __restrict__ out, int p, int cols) {
  const int col = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (col >= cols) return;
  float t = 0.0f;
  for (int i = lane; i < p; i += 32) t = __fadd_rn(t, partial[(size_t)i * cols + col]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, d));
  if (lane == 0) out[col] = t;
}

// ab is [2][C]: a = dvar * (2/n), b = dmean * (1/n) - a * mean.
__global__ void bn_coef_kernel(const float* __restrict__ dmean, const float* __restrict__ dvar,
                               const float* __restrict__ mean, float* __restrict__ ab, int c,
                               float inv_n, float two_inv_n) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const float a = __fmul_rn(dvar[ch], two_inv_n);
  ab[ch] = a;
  ab[c + ch] = __fsub_rn(__fmul_rn(dmean[ch], inv_n), __fmul_rn(a, mean[ch]));
}

// dx = a[c] * x + b[c], V elements (16 bytes when V > 1) a thread.
// channels-last: the channel of element i is i % c; planes: (i / hw) % c.
template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ x, const float* __restrict__ ab, T* __restrict__ dx,
             unsigned total, unsigned c, unsigned hw) {
  const unsigned stride = gridDim.x * kThreads * V;
  for (unsigned i = (blockIdx.x * kThreads + threadIdx.x) * V; i < total; i += stride) {
    __align__(16) T in[V];
    __align__(16) T out[V];
    if constexpr (V > 1) {
      *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(x + i);
    } else {
      in[0] = x[i];
    }
    const unsigned ch0 = CL ? i % c : (i / hw) % c;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const unsigned ch = CL ? ch0 + j : ch0;
      store(out + j, __fadd_rn(__fmul_rn(ab[ch], to_f32(in[j])), ab[c + ch]));
    }
    if constexpr (V > 1) {
      *reinterpret_cast<uint4*>(dx + i) = *reinterpret_cast<const uint4*>(out);
    } else {
      dx[i] = out[0];
    }
  }
}

template <typename T>
int sums(const void* x, void* partial, void* out, int channels_last, int b, int c, int hw, int p,
         int per_block, cudaStream_t stream) {
  if (channels_last) {
    dim3 grid(p, (c + 31) / 32), block(32, kRowsPerPass);
    bn_sums_cl_kernel<T><<<grid, block, 0, stream>>>((const T*)x, (float*)partial,
                                                     (long long)b * hw, c, per_block);
  } else {
    dim3 grid(c, p);
    bn_sums_planes_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)x, (float*)partial, b, c,
                                                            hw, per_block);
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int cols = 2 * c, warps = kThreads / 32;
  bn_fold_kernel<<<(cols + warps - 1) / warps, kThreads, 0, stream>>>((const float*)partial,
                                                                      (float*)out, p, cols);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int dx_launch(const void* x, const void* ab, void* dx, int channels_last, int vec,
              unsigned total, unsigned c, unsigned hw, cudaStream_t stream) {
  const unsigned per = vec ? V : 1;
  unsigned blocks = (total / per + kThreads - 1) / kThreads;
  if (blocks > 132u * 16u) blocks = 132u * 16u;   // grid-stride beyond 16 blocks an SM
  if (blocks == 0) blocks = 1;
  const T* xi = (const T*)x;
  const float* abf = (const float*)ab;
  T* out = (T*)dx;
  if (vec && channels_last)
    bn_dx_kernel<T, V, true><<<blocks, kThreads, 0, stream>>>(xi, abf, out, total, c, hw);
  else if (vec)
    bn_dx_kernel<T, V, false><<<blocks, kThreads, 0, stream>>>(xi, abf, out, total, c, hw);
  else if (channels_last)
    bn_dx_kernel<T, 1, true><<<blocks, kThreads, 0, stream>>>(xi, abf, out, total, c, hw);
  else
    bn_dx_kernel<T, 1, false><<<blocks, kThreads, 0, stream>>>(xi, abf, out, total, c, hw);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward. x: b*c*hw elements (bf16 when is_bf16, else f32), channels-last or
// NCHW planes. partial: p*2*c f32 of scratch. out: 2*c f32 (sum, then sumsq).
// p blocks along the reduced axis, each taking per_block rows (channels-last)
// or per_block elements of a plane (planes); the wrapper picks both. Launches
// on `stream`; returns the cudaError_t of the launches (0 = success).
extern "C" int bn_sums_launch(const void* x, void* partial, void* out, int is_bf16,
                              int channels_last, int b, int c, int hw, int p, int per_block,
                              void* stream) {
  if (b == 0 || c == 0 || hw == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return sums<__nv_bfloat16>(x, partial, out, channels_last, b, c, hw, p, per_block, s);
  return sums<float>(x, partial, out, channels_last, b, c, hw, p, per_block, s);
}

// Backward. dmean, dvar, mean: c f32. ab: 2*c f32 of scratch. dx like x.
// vec: 16-byte accesses are allowed (the wrapper checked alignment and that a
// vector never straddles a channel boundary it may not). total = b*c*hw < 2^31.
extern "C" int bn_moments_dx_launch(const void* x, const void* dmean, const void* dvar,
                                    const void* mean, void* ab, void* dx, int is_bf16,
                                    int channels_last, int vec, int b, int c, int hw, float inv_n,
                                    float two_inv_n, void* stream) {
  if (b == 0 || c == 0 || hw == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  bn_coef_kernel<<<(c + 127) / 128, 128, 0, s>>>((const float*)dmean, (const float*)dvar,
                                                 (const float*)mean, (float*)ab, c, inv_n,
                                                 two_inv_n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const unsigned total = (unsigned)b * (unsigned)c * (unsigned)hw;
  if (is_bf16)
    return dx_launch<__nv_bfloat16, 8>(x, ab, dx, channels_last, vec, total, c, hw, s);
  return dx_launch<float, 4>(x, ab, dx, channels_last, vec, total, c, hw, s);
}
