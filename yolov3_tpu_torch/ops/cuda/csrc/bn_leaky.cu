// K7 — training BatchNorm's tail: normalize, scale, shift and LeakyReLU in one
// launch forward, and its backward in one launch.
//
// No Pallas kernel: K7 stands for XLA's fusion of the JAX package's
// yolov3_tpu/models/layers.py:342 batch_norm and :407 leaky_relu in its train
// step. It follows K5 (bn_stats.cu), whose batch mean and var it consumes.
// Contract (T = x's dtype, f32 or bf16; P = the parameters' dtype, f32 or
// bf16; rn_T rounds to T; every operation rounds once, where the element-wise
// PyTorch ops of the plain expression round):
//   per channel  r = rsqrt(var + eps);  s = P(gamma) * r                 f32
//                m_T = rn_T(mean);  s_T = rn_T(s);  b_T = rn_T(beta)
//   forward      d = rn_T(x - m_T);  v = rn_T(rn_T(d * s_T) + b_T)
//                y = v >= 0 ? v : rn_T(v * slope)
//   backward     g = v >= 0 ? dy : dy * slope                            f32
//                dx = rn_T(g * s_T)             (the direct part of x's gradient)
//                S0 = sum of g, S1 = sum of g * d over every non-channel position
//                dbeta = rn_P(S0);  dgamma = rn_P(S1 * r)
//                dmean = -(s_T * S0);  dvar = (-0.5 * (S1 * gamma)) * ((r * r) * r)
// dmean and dvar go on to K5's backward, which adds the part of x's gradient
// that flows through the statistics. x is a dense 4-D activation, logically
// (B, C, H, W), lying in memory either channels-last (rows of C, `rows` =
// B*H*W of them) or as NCHW planes (B*C runs of `hw` = H*W elements); dy and
// the outputs lie as x does.
//
// The forward is bit-equal to the plain expression evaluated by PyTorch on the
// card: rsqrtf is the function ATen's rsqrt kernel calls, the build has
// --fmad=false, and the parameters' casts are the round-to-nearest-even casts
// PyTorch makes. The backward's sums are taken in an order fixed by the shape,
// so two launches on one input give the same bits (no float atomics).
//
// What bounds it on an H100: bytes. The forward reads x and writes y, the
// backward reads x and dy and writes dx, a few operations an element. The
// eager tail it replaces made about a dozen passes over the activation forward
// and backward, each its own launch. So:
//   * one launch each way; every thread keeps the per-channel constants of the
//     channels it reads in registers, computed once from the (C,) vectors, so
//     nothing but the activations streams through memory, and nothing is
//     saved for the backward but x and the vectors (v and the LeakyReLU mask
//     are recomputed, bit for bit);
//   * both layouts are read where they lie, 16 bytes a thread where the shape
//     allows: channels-last as a (rows, C) matrix whose tiles of 8 vectors (128
//     bytes) a row are walked down the rows by the block's other threads, so a
//     thread's channels never change; planes by blocks of one channel each;
//   * the backward's per-channel sums follow K5's design: every block writes
//     its partial sums to a workspace and draws a ticket, and the block that
//     draws the last one (per channel tile in channels-last memory) folds the
//     partial rows in a fixed order and writes the four (C,) gradients. Where
//     a channel has one block, that block finishes it and draws no ticket.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elementwise.cuh"

namespace {

using elementwise::from_f32;
using elementwise::load;
using elementwise::rn;
using elementwise::store;
using elementwise::to_f32;

constexpr int kThreads = 256;
constexpr int kCounters = 256;   // ticket counters at the head of the workspace
constexpr int kTileChannels = 64;   // channels-last: a tile is 128 bytes of a row

struct Params {
  const float* mean;
  const float* var;
  const void* gamma;   // P
  const void* beta;    // P
  int param_bf16;
  float eps;
  float slope;
};

// Constants of one channel, each the f32 value of a T number.
struct Channel {
  float m, s, b;
};

__device__ __forceinline__ float param(const void* p, int bf16, int ch) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[ch])
              : reinterpret_cast<const float*>(p)[ch];
}

__device__ __forceinline__ float inv_std(const Params& q, int ch) {
  return rsqrtf(__fadd_rn(q.var[ch], q.eps));
}

template <typename T>
__device__ __forceinline__ Channel channel(const Params& q, int ch) {
  const float s = __fmul_rn(param(q.gamma, q.param_bf16, ch), inv_std(q, ch));
  return {rn<T>(q.mean[ch]), rn<T>(s), rn<T>(param(q.beta, q.param_bf16, ch))};
}

// The pre-activation v of one element, and d = rn_T(x - m_T) beside it.
template <typename T>
__device__ __forceinline__ float pre(float x, const Channel& k, float& d) {
  d = rn<T>(__fsub_rn(x, k.m));
  return rn<T>(__fadd_rn(rn<T>(__fmul_rn(d, k.s)), k.b));
}

template <typename T>
__device__ __forceinline__ T fwd_element(float x, const Channel& k, float slope) {
  float d;
  const float v = pre<T>(x, k, d);
  return from_f32<T>(v >= 0.0f ? v : rn<T>(__fmul_rn(v, slope)));
}

// dx of one element; adds g and g * d to the channel's running sums.
template <typename T>
__device__ __forceinline__ T bwd_element(float x, float dy, const Channel& k, float slope,
                                      float& s0, float& s1) {
  float d;
  const float v = pre<T>(x, k, d);
  const float g = v >= 0.0f ? dy : __fmul_rn(dy, slope);
  s0 = __fadd_rn(s0, g);
  s1 = __fadd_rn(s1, __fmul_rn(g, d));
  return from_f32<T>(__fmul_rn(g, k.s));
}

// One channel's four gradients from its folded sums: dstats is [2][C] f32
// (dmean, dvar), dparams [2][C] in P (dgamma, dbeta).
template <typename T>
__device__ __forceinline__ void finish(const Params& q, int ch, int c, float s0, float s1,
                                       float* dstats, void* dparams) {
  const float r = inv_std(q, ch);
  const float gamma = param(q.gamma, q.param_bf16, ch);
  const float s = rn<T>(__fmul_rn(gamma, r));
  dstats[ch] = -__fmul_rn(s, s0);
  dstats[c + ch] = __fmul_rn(__fmul_rn(-0.5f, __fmul_rn(s1, gamma)),
                             __fmul_rn(__fmul_rn(r, r), r));
  const float dgamma = __fmul_rn(s1, r);
  if (q.param_bf16) {
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(dparams);
    o[ch] = __float2bfloat16_rn(dgamma);
    o[c + ch] = __float2bfloat16_rn(s0);
  } else {
    float* o = reinterpret_cast<float*>(dparams);
    o[ch] = dgamma;
    o[c + ch] = s0;
  }
}

// After this block's partial row is written: true in every thread of the one
// block that arrives last. `writer`: this thread wrote part of the row;
// `tid0`: it is the block's first thread.
__device__ __forceinline__ bool last_block(unsigned* counter, unsigned total, bool writer,
                                           bool tid0) {
  __shared__ bool last;
  if (writer) __threadfence();   // this thread's partial sums, before the ticket
  __syncthreads();
  if (tid0) last = atomicAdd(counter, 1u) == total - 1u;
  __syncthreads();
  if (last) __threadfence();   // the other blocks' partial sums, after it
  return last;
}

// The last block's work on channels [ch0, ch1) of partial ([p][2][C]), by its
// `threads` threads: `lanes` threads a channel (all of them when the block
// has more threads than channels), lane l summing rows l, l + lanes, ...;
// the lanes' sums then add in lane order. Loads of one pass cover
// neighbouring channels of a partial row.
template <typename T>
__device__ void fold_and_finish(const Params& q, const float* partial, unsigned* counter, int p,
                                int c, int ch0, int ch1, float* dstats, void* dparams, int tid,
                                int threads) {
  __shared__ float sh0[kThreads];
  __shared__ float sh1[kThreads];
  const int w = ch1 - ch0;
  const int lanes = w >= threads ? 1 : threads / w;
  const int per = threads / lanes;   // channels a pass
  const int l = tid / per;
  for (int base = ch0; base < ch1; base += per) {
    const int ch = base + tid % per;
    float a = 0.0f, b = 0.0f;
    if (l < lanes && ch < ch1) {
#pragma unroll 4
      for (int i = l; i < p; i += lanes) {
        a = __fadd_rn(a, __ldcg(partial + (size_t)i * 2 * c + ch));
        b = __fadd_rn(b, __ldcg(partial + (size_t)i * 2 * c + c + ch));
      }
    }
    sh0[tid] = a;
    sh1[tid] = b;
    __syncthreads();
    if (l == 0 && ch < ch1) {
      for (int j = 1; j < lanes; ++j) {
        a = __fadd_rn(a, sh0[j * per + tid]);
        b = __fadd_rn(b, sh1[j * per + tid]);
      }
      finish<T>(q, ch, c, a, b, dstats, dparams);
    }
    __syncthreads();
  }
  if (tid == 0) *counter = 0u;
}

// Channels-last, forward. Block (tx, ty) takes the vector columns blockIdx.y *
// tx + [0, tx) of the (rows, C) matrix, V channels each, and rows [r0, r1);
// thread (x, y) walks rows r0 + y, r0 + y + ty, ... of its column.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_leaky_fwd_cl_kernel(const T* __restrict__ x, T* __restrict__ y, Params q, long long rows,
                       int c, int rows_per_block) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col * V >= c) return;
  Channel k[V];
#pragma unroll
  for (int j = 0; j < V; ++j) k[j] = channel<T>(q, col * V + j);
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
#pragma unroll 4
  for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const size_t i = (size_t)r * c + (size_t)col * V;
    __align__(16) T in[V];
    __align__(16) T out[V];
    load<T, V>(x + i, in);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = fwd_element<T>(to_f32(in[j]), k[j], q.slope);
    store<T, V>(y + i, out);
  }
}

// Channels-last, backward: the forward's walk, then the block's sums over its
// rows (a tree over the thread rows, in a fixed order) into a partial row of
// [p][2][C]; each tile of channels has a ticket counter of its own, and the
// last of its p blocks folds that tile while other tiles are still reading.
// The tile's channel constants sit in shared memory (a thread's 2V running
// sums take the registers), so four blocks fit an SM and the plan's grid is
// one wave.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 4)
bn_leaky_bwd_cl_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                       Params q, long long rows, int c, int rows_per_block, float* partial,
                       unsigned* counters, float* __restrict__ dstats, void* __restrict__ dparams) {
  __shared__ float red[kThreads * 2 * V];
  __shared__ __align__(16) float tile_m[kTileChannels];
  __shared__ __align__(16) float tile_s[kTileChannels];
  __shared__ __align__(16) float tile_b[kTileChannels];
  const int tx = threadIdx.x, ty = threadIdx.y, bx = blockDim.x, by = blockDim.y;
  const int tid = ty * bx + tx;
  const int col = blockIdx.y * bx + tx;
  const bool valid = col * V < c;
  const int ch0 = blockIdx.y * bx * V;
  const int ch1 = ch0 + bx * V < c ? ch0 + bx * V : c;
  for (int i = tid; i < ch1 - ch0; i += bx * by) {
    const Channel k = channel<T>(q, ch0 + i);
    tile_m[i] = k.m;
    tile_s[i] = k.s;
    tile_b[i] = k.b;
  }
  __syncthreads();
  float s0[V], s1[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s0[j] = s1[j] = 0.0f;
  if (valid) {
    const int lc = tx * V;   // this thread's first channel within the tile
    const long long r0 = (long long)blockIdx.x * rows_per_block;
    const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
#pragma unroll 2
    for (long long r = r0 + ty; r < r1; r += by) {
      const size_t i = (size_t)r * c + (size_t)col * V;
      __align__(16) T in[V];
      __align__(16) T grad[V];
      __align__(16) T out[V];
      load<T, V>(x + i, in);
      load<T, V>(dy + i, grad);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const Channel k{tile_m[lc + j], tile_s[lc + j], tile_b[lc + j]};
        out[j] = bwd_element<T>(to_f32(in[j]), to_f32(grad[j]), k, q.slope, s0[j], s1[j]);
      }
      store<T, V>(dx + i, out);
    }
  }
  float* mine = red + (size_t)tid * 2 * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mine[j] = s0[j];
    mine[V + j] = s1[j];
  }
  __syncthreads();
  int h = 1;
  while (h < by) h <<= 1;
  for (h >>= 1; h >= 1; h >>= 1) {
    if (ty < h && ty + h < by) {
      const float* other = red + (size_t)((ty + h) * bx + tx) * 2 * V;
#pragma unroll
      for (int j = 0; j < 2 * V; ++j) mine[j] = __fadd_rn(mine[j], other[j]);
    }
    __syncthreads();
  }
  const bool writer = ty == 0 && valid;
  if (gridDim.x == 1) {   // the only block of these channels: nothing to fold
    if (writer)
      for (int j = 0; j < V; ++j)
        finish<T>(q, col * V + j, c, mine[j], mine[V + j], dstats, dparams);
    return;
  }
  if (writer) {
    float* row = partial + (size_t)blockIdx.x * 2 * c;
    for (int j = 0; j < V; ++j) {
      row[col * V + j] = mine[j];
      row[c + col * V + j] = mine[V + j];
    }
  }
  if (last_block(counters + blockIdx.y, gridDim.x, writer, tid == 0))
    fold_and_finish<T>(q, partial, counters + blockIdx.y, gridDim.x, c, ch0, ch1, dstats,
                       dparams, tid, bx * by);
}

// NCHW planes, forward. Block (channel, split) takes elements [i0, i1) of that
// channel's plane in every image; its kThreads threads form kThreads / LANES
// groups of LANES; group g takes images g, g + groups, ... and its threads
// stride over the slice, V elements a load.
template <typename T, int V, int LANES>
__global__ void __launch_bounds__(kThreads)
bn_leaky_fwd_planes_kernel(const T* __restrict__ x, T* __restrict__ y, Params q, int b, int c,
                           int hw, int chunk) {
  constexpr int kGroups = kThreads / LANES;
  const int ch = blockIdx.x, group = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const Channel k = channel<T>(q, ch);
  const int i0 = blockIdx.y * chunk;
  const int i1 = i0 + chunk < hw ? i0 + chunk : hw;
  for (int n = group; n < b; n += kGroups) {
    const size_t base = ((size_t)n * c + ch) * hw;
#pragma unroll 4
    for (int i = i0 + lane * V; i < i1; i += LANES * V) {
      __align__(16) T in[V];
      __align__(16) T out[V];
      load<T, V>(x + base + i, in);
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = fwd_element<T>(to_f32(in[j]), k, q.slope);
      store<T, V>(y + base + i, out);
    }
  }
}

// NCHW planes, backward: the forward's walk, then the block's sums (warp
// shuffles, then the warps in order) into a partial row of [p][2][C]; one
// ticket counter, and the last block folds every channel.
template <typename T, int V, int LANES>
__global__ void __launch_bounds__(kThreads)
bn_leaky_bwd_planes_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           T* __restrict__ dx, Params q, int b, int c, int hw, int chunk,
                           float* partial, unsigned* counter, float* __restrict__ dstats,
                           void* __restrict__ dparams) {
  constexpr int kGroups = kThreads / LANES;
  __shared__ float w0[kThreads / 32];
  __shared__ float w1[kThreads / 32];
  const int ch = blockIdx.x, tid = threadIdx.x;
  const int group = tid / LANES, lane = tid % LANES;
  const Channel k = channel<T>(q, ch);
  const int i0 = blockIdx.y * chunk;
  const int i1 = i0 + chunk < hw ? i0 + chunk : hw;
  float s0 = 0.0f, s1 = 0.0f;
  for (int n = group; n < b; n += kGroups) {
    const size_t base = ((size_t)n * c + ch) * hw;
#pragma unroll 2
    for (int i = i0 + lane * V; i < i1; i += LANES * V) {
      __align__(16) T in[V];
      __align__(16) T grad[V];
      __align__(16) T out[V];
      load<T, V>(x + base + i, in);
      load<T, V>(dy + base + i, grad);
#pragma unroll
      for (int j = 0; j < V; ++j)
        out[j] = bwd_element<T>(to_f32(in[j]), to_f32(grad[j]), k, q.slope, s0, s1);
      store<T, V>(dx + base + i, out);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, d));
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, d));
  }
  if ((tid & 31) == 0) {
    w0[tid >> 5] = s0;
    w1[tid >> 5] = s1;
  }
  __syncthreads();
  if (tid == 0) {
    float t0 = w0[0], t1 = w1[0];
#pragma unroll
    for (int j = 1; j < kThreads / 32; ++j) {
      t0 = __fadd_rn(t0, w0[j]);
      t1 = __fadd_rn(t1, w1[j]);
    }
    if (gridDim.y == 1) {   // the only block of this channel: nothing to fold
      finish<T>(q, ch, c, t0, t1, dstats, dparams);
    } else {
      float* row = partial + (size_t)blockIdx.y * 2 * c;
      row[ch] = t0;
      row[c + ch] = t1;
    }
  }
  if (gridDim.y == 1) return;
  if (last_block(counter, gridDim.x * gridDim.y, tid == 0, tid == 0))
    fold_and_finish<T>(q, partial, counter, gridDim.y, c, 0, c, dstats, dparams, tid, kThreads);
}

struct Shape {
  int channels_last, b, c, hw, p, per_block, tx, ty;
};

template <typename T, int V>
int fwd(const void* x, void* y, const Params& q, const Shape& s, cudaStream_t stream) {
  const T* xi = (const T*)x;
  T* yo = (T*)y;
  if (s.channels_last) {
    dim3 grid(s.p, (s.c / V + s.tx - 1) / s.tx), block(s.tx, s.ty);
    bn_leaky_fwd_cl_kernel<T, V><<<grid, block, 0, stream>>>(xi, yo, q, (long long)s.b * s.hw,
                                                             s.c, s.per_block);
  } else {
    dim3 grid(s.c, s.p);
    if (s.tx == 256)
      bn_leaky_fwd_planes_kernel<T, V, 256><<<grid, kThreads, 0, stream>>>(xi, yo, q, s.b, s.c,
                                                                           s.hw, s.per_block);
    else
      bn_leaky_fwd_planes_kernel<T, V, 32><<<grid, kThreads, 0, stream>>>(xi, yo, q, s.b, s.c,
                                                                          s.hw, s.per_block);
  }
  return (int)cudaGetLastError();
}

template <typename T, int V>
int bwd(const void* x, const void* dy, void* dx, const Params& q, const Shape& s, float* partial,
        unsigned* counters, float* dstats, void* dparams, cudaStream_t stream) {
  const T* xi = (const T*)x;
  const T* gi = (const T*)dy;
  T* o = (T*)dx;
  if (s.channels_last) {
    dim3 grid(s.p, (s.c / V + s.tx - 1) / s.tx), block(s.tx, s.ty);
    bn_leaky_bwd_cl_kernel<T, V><<<grid, block, 0, stream>>>(
        xi, gi, o, q, (long long)s.b * s.hw, s.c, s.per_block, partial, counters, dstats, dparams);
  } else {
    dim3 grid(s.c, s.p);
    if (s.tx == 256)
      bn_leaky_bwd_planes_kernel<T, V, 256><<<grid, kThreads, 0, stream>>>(
          xi, gi, o, q, s.b, s.c, s.hw, s.per_block, partial, counters, dstats, dparams);
    else
      bn_leaky_bwd_planes_kernel<T, V, 32><<<grid, kThreads, 0, stream>>>(
          xi, gi, o, q, s.b, s.c, s.hw, s.per_block, partial, counters, dstats, dparams);
  }
  return (int)cudaGetLastError();
}

// The plan's shape, or false: channels-last blocks of tx * ty <= kThreads
// threads and at most kCounters channel tiles; planes blocks with lanes
// (`tx`) of 32 or 256.
bool plan_ok(const Shape& s, int vec_width) {
  if (s.b <= 0 || s.c <= 0 || s.hw <= 0 || s.p <= 0 || s.per_block <= 0) return false;
  if (s.channels_last) {
    if (s.c % vec_width != 0 || s.tx <= 0 || s.ty <= 0 || s.tx * s.ty > kThreads ||
        s.tx * vec_width > kTileChannels)
      return false;
    return (s.c / vec_width + s.tx - 1) / s.tx <= kCounters;
  }
  return (s.tx == 32 || s.tx == 256) && s.hw % vec_width == 0 &&
         (s.p == 1 || s.per_block % vec_width == 0);
}

}  // namespace

// Forward, one launch. x and y: b*c*hw elements (bf16 when is_bf16, else
// f32), channels-last or NCHW planes, y laid out as x. mean, var: c f32;
// gamma, beta: c elements (bf16 when param_bf16, else f32). vec: 16-byte
// accesses are allowed (the wrapper checked alignment and that a vector never
// straddles a channel boundary it may not). p, per_block, tx, ty: the
// wrapper's plan (channels-last: p blocks along the rows, per_block rows each,
// blocks of tx x ty threads; planes: p slices of per_block elements a plane,
// tx lanes a group). Launches on `stream`; returns the launch's cudaError_t.
extern "C" int bn_leaky_launch(const void* x, void* y, const void* mean, const void* var,
                               const void* gamma, const void* beta, int is_bf16, int param_bf16,
                               int channels_last, int vec, int b, int c, int hw, int p,
                               int per_block, int tx, int ty, float eps, float slope,
                               void* stream) {
  const Shape s{channels_last, b, c, hw, p, per_block, tx, ty};
  const int width = vec ? 16 / (is_bf16 ? 2 : 4) : 1;
  if (!plan_ok(s, width)) return (int)cudaErrorInvalidValue;
  const Params q{(const float*)mean, (const float*)var, gamma, beta, param_bf16, eps, slope};
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return vec ? fwd<__nv_bfloat16, 8>(x, y, q, s, st) : fwd<__nv_bfloat16, 1>(x, y, q, s, st);
  return vec ? fwd<float, 4>(x, y, q, s, st) : fwd<float, 1>(x, y, q, s, st);
}

// Backward, one launch. x, dy, dx: as the forward's x and y. workspace:
// kCounters 32-bit ticket counters (0 before every launch; the kernel leaves
// them 0; planes use the first, channels-last one a channel tile), then
// p*2*c f32 of partial sums; one workspace serves one stream at a time (K5's
// workspace: the two never run at once on a stream). dstats: 2*c f32 (dmean,
// dvar); dparams: 2*c elements in the parameters' dtype (dgamma, dbeta).
extern "C" int bn_leaky_dx_launch(const void* x, const void* dy, void* dx, const void* mean,
                                  const void* var, const void* gamma, const void* beta,
                                  void* workspace, void* dstats, void* dparams, int is_bf16,
                                  int param_bf16, int channels_last, int vec, int b, int c,
                                  int hw, int p, int per_block, int tx, int ty, float eps,
                                  float slope, void* stream) {
  const Shape s{channels_last, b, c, hw, p, per_block, tx, ty};
  const int width = vec ? 16 / (is_bf16 ? 2 : 4) : 1;
  if (!plan_ok(s, width)) return (int)cudaErrorInvalidValue;
  const Params q{(const float*)mean, (const float*)var, gamma, beta, param_bf16, eps, slope};
  unsigned* counters = (unsigned*)workspace;
  float* partial = (float*)workspace + kCounters;
  float* ds = (float*)dstats;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return vec ? bwd<__nv_bfloat16, 8>(x, dy, dx, q, s, partial, counters, ds, dparams, st)
               : bwd<__nv_bfloat16, 1>(x, dy, dx, q, s, partial, counters, ds, dparams, st);
  return vec ? bwd<float, 4>(x, dy, dx, q, s, partial, counters, ds, dparams, st)
             : bwd<float, 1>(x, dy, dx, q, s, partial, counters, ds, dparams, st);
}
