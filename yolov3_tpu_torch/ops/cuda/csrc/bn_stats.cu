// K5 — training-mode BatchNorm statistics: per-channel sum, sum of squares,
// mean and biased variance in one launch and one read of the activation, and
// the backward of (mean, variance) in one launch.
//
// Replaces the Pallas TPU kernel yolov3_tpu/ops/pallas/bn_stats.py (bn_sums /
// _kernel, and bn_moments with its custom VJP). Contract:
//   forward   sum[c]   = sum over every non-channel position of f32(x)
//             sumsq[c] = sum of f32(x)^2                       f32 accumulation
//             mean[c]  = sum[c] * inv_n
//             var[c]   = max(sumsq[c] * inv_n - mean[c] * mean[c], 0)
//   backward  a[c] = dvar[c] * (2/n);  b[c] = dmean[c] * (1/n) - a[c] * mean[c]
//             dx = T(a[c] * f32(x) + b[c])                     two roundings + cast
// x is f32 or bf16, a dense 4-D activation that is logically (B, C, H, W) and
// lies in memory either channels-last (rows of C, `rows` = B*H*W of them) or
// as NCHW planes (B*C runs of `hw` = H*W elements).
//
// mean and var repeat, bit for bit, what the element-wise PyTorch expression
//   mean = sum / n;  var = clamp(sumsq / n - mean * mean, min=0)
// gives on the card: PyTorch's CUDA division of a tensor by a Python scalar
// multiplies by the f32 reciprocal of the scalar (ATen's div_true kernel: "if
// the second operand is a CPU scalar, compute a * reciprocal(b)"), so inv_n is
// 1.0f / f32(n) from the wrapper and the kernel uses __fmul_rn, not __fdiv_rn;
// clamp keeps a NaN, as torch.clamp does.
//
// What bounds it on an H100: bytes at the large shapes (the forward reads x
// once, 354 MB in f32 at B=16, 416^2, C=32, for two flops an element; the
// backward reads x and writes dx), and the cost of a launch at the small ones
// (C=1024 at 13^2 is 11 MB, a few microseconds of reading). So the design is
// about the read and about being one launch:
//   * every warp load covers neighbouring addresses in both layouts (16 bytes
//     a thread in the planes layout where the plane's size allows), each
//     block keeps its sums in registers over many elements, x is never copied
//     or converted beforehand, and the wrapper's plan sizes the grid and the
//     block from the bytes, so small shapes get short blocks that all run at
//     once and large ones about two waves;
//   * the TPU kernel carried its sums from grid step to grid step in a
//     revisited output block. Blocks here run in no order, so each writes its
//     partial sums to a workspace, issues __threadfence() and draws a ticket
//     from a counter in device memory; the block that draws the last ticket
//     folds all partial rows (per channel: 32 interleaved running sums over
//     the rows, then a pairwise tree; its loads cover neighbouring channels
//     of a row, since one SM alone reads all the rows), writes sum, sumsq,
//     mean and var, and sets the counter back to 0 for the next launch on
//     that workspace. Channels-last memory has a counter for every 32
//     channels, so groups of channels fold side by side. Where the plan
//     gives a channel one block (the small shapes), that block finishes its
//     channels itself and no ticket is drawn. No float atomics: every order
//     is fixed by the shape, so two launches on one input give the same bits;
//   * the backward computes a and b of a vector's channel(s) in the thread
//     that needs them, with the rounding sequence above, so it needs no
//     scratch. The TPU kernel's 128-lane folding of narrow
//     channels has no counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDxThreads = 256;
constexpr int kRowsPerPass = 8;   // channels-last block: 32 channels x 8 rows
constexpr int kCounters = 256;    // ticket counters at the head of the workspace

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

// One channel's four results from its folded sums: out is [4][C] = sum,
// sumsq, mean, var.
__device__ __forceinline__ void finish(float s, float q, float* out, int ch, int c,
                                       float inv_n) {
  const float mean = __fmul_rn(s, inv_n);
  const float v = __fsub_rn(__fmul_rn(q, inv_n), __fmul_rn(mean, mean));
  out[ch] = s;
  out[c + ch] = q;
  out[2 * c + ch] = mean;
  out[3 * c + ch] = v != v ? v : fmaxf(v, 0.0f);
}

// The fold of one column of partial ([p][stride]) is defined as: 32 running
// sums, sum l over rows l, l + 32, ..., then the pairwise tree a warp's xor
// shuffles make, ((t0+t16)+(t8+t24)) + ... . tree32 is that tree over
// sum(0) ... sum(31), a quarter (8 values in flight) at a time.
template <class Sum>
__device__ __forceinline__ float tree32(Sum sum) {
  auto pair = [&](int i) { return __fadd_rn(sum(i), sum(i + 16)); };
  float w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = __fadd_rn(__fadd_rn(pair(j), pair(j + 8)), __fadd_rn(pair(j + 4), pair(j + 12)));
  return __fadd_rn(__fadd_rn(w[0], w[2]), __fadd_rn(w[1], w[3]));
}

// The last block's work on channels [ch0, ch1), by its WARPS warps. Either
// way a warp's loads cover neighbouring channels of one partial row.
//   p <= 32 (a running sum is one row): a thread folds a channel by itself.
//   p > 32: 32 channels at a time; warp w keeps the running sums l = w,
//   w + WARPS, ... of the warp's 32 channels, shared memory gathers the 32
//   sums of every channel, and the first warp runs the tree.
template <int WARPS>
__device__ __forceinline__ void fold_and_finish(const float* partial, float* out,
                                                unsigned* counter, int p, int c, int ch0,
                                                int ch1, float inv_n, int tid) {
  const int cols = 2 * c;
  if (p <= 32) {
    for (int ch = ch0 + tid; ch < ch1; ch += WARPS * 32) {
      auto row = [&](const float* col, int i) {
        return i < p ? __ldcg(col + (size_t)i * cols) : 0.0f;
      };
      finish(tree32([&](int i) { return row(partial + ch, i); }),
             tree32([&](int i) { return row(partial + c + ch, i); }), out, ch, c, inv_n);
    }
  } else {
    constexpr int kMine = 32 / WARPS;   // running sums a warp keeps for each channel
    __shared__ float sum_s[32][33];
    __shared__ float sum_q[32][33];
    const int tx = tid & 31, warp = tid >> 5;
    for (int tile = ch0; tile < ch1; tile += 32) {
      const int ch = tile + tx;
      float s[kMine], q[kMine];
#pragma unroll
      for (int k = 0; k < kMine; ++k) s[k] = q[k] = 0.0f;
      if (ch < ch1) {
#pragma unroll 4
        for (int base = 0; base < p; base += 32) {
#pragma unroll
          for (int k = 0; k < kMine; ++k) {
            const int i = base + warp + WARPS * k;
            if (i < p) {
              s[k] = __fadd_rn(s[k], __ldcg(partial + (size_t)i * cols + ch));
              q[k] = __fadd_rn(q[k], __ldcg(partial + (size_t)i * cols + c + ch));
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMine; ++k) {
        sum_s[warp + WARPS * k][tx] = s[k];
        sum_q[warp + WARPS * k][tx] = q[k];
      }
      __syncthreads();
      if (warp == 0 && ch < ch1)
        finish(tree32([&](int l) { return sum_s[l][tx]; }),
               tree32([&](int l) { return sum_q[l][tx]; }), out, ch, c, inv_n);
      __syncthreads();
    }
  }
  if (tid == 0) *counter = 0u;
}

// Channels-last: block (32, 8) takes 32 channels and rows [r0, r1); thread
// (tx, ty) walks rows r0+ty, r0+ty+8, ... of channel tx. A warp reads 32
// neighbouring channels of one row. partial is [P][2][C]. Each group of 32
// channels has a ticket counter of its own, and the last of its P blocks
// folds those 32 channels while other groups are still reading.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerPass, 8)
bn_moments_cl_kernel(const T* __restrict__ x, float* partial, float* __restrict__ out,
                     unsigned* counter, long long rows, int c, int rows_per_block, float inv_n) {
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
    if (gridDim.x == 1) {   // the only block of these channels: nothing to fold
      finish(ts, tq, out, ch, c, inv_n);
    } else {
      float* row = partial + (size_t)blockIdx.x * 2 * c;
      row[ch] = ts;
      row[c + ch] = tq;
    }
  }
  if (gridDim.x == 1) return;
  const int tid = ty * 32 + tx;
  const int ch0 = blockIdx.y * 32;
  if (last_block(counter + blockIdx.y, gridDim.x, ty == 0 && ch < c, tid == 0))
    fold_and_finish<kRowsPerPass>(partial, out, counter + blockIdx.y, gridDim.x, c, ch0,
                                  ch0 + 32 < c ? ch0 + 32 : c, inv_n, tid);
}

// NCHW planes: block (channel, split) reads elements [i0, i1) of that
// channel's plane in every image. Its THREADS threads form THREADS / LANES
// groups of LANES threads; group g takes images g, g + groups, ... and its
// threads stride over the slice, V elements (16 bytes when V > 1) a load.
// partial is [S][2][C].
template <typename T, int THREADS, int LANES, int V>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS)
bn_moments_planes_kernel(const T* __restrict__ x, float* partial, float* __restrict__ out,
                         unsigned* counter, int b, int c, int hw, int chunk, float inv_n) {
  constexpr int kGroups = THREADS / LANES;
  __shared__ float sh_s[THREADS / 32];
  __shared__ float sh_q[THREADS / 32];
  const int ch = blockIdx.x, tid = threadIdx.x;
  const int group = tid / LANES, lane = tid % LANES;
  const int i0 = blockIdx.y * chunk;
  int i1 = i0 + chunk;
  if (i1 > hw) i1 = hw;
  float s = 0.0f, q = 0.0f;
  for (int n = group; n < b; n += kGroups) {
    const T* p = x + ((size_t)n * c + ch) * hw;
#pragma unroll 4
    for (int i = i0 + lane * V; i < i1; i += LANES * V) {
      __align__(16) T in[V];
      if constexpr (V > 1) {
        *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(p + i);
      } else {
        in[0] = p[i];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = to_f32(in[j]);
        s = __fadd_rn(s, v);
        q = __fadd_rn(q, __fmul_rn(v, v));
      }
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
    for (int j = 1; j < THREADS / 32; ++j) {
      ts = __fadd_rn(ts, sh_s[j]);
      tq = __fadd_rn(tq, sh_q[j]);
    }
    if (gridDim.y == 1) {   // the only block of this channel: nothing to fold
      finish(ts, tq, out, ch, c, inv_n);
    } else {
      float* row = partial + (size_t)blockIdx.y * 2 * c;
      row[ch] = ts;
      row[c + ch] = tq;
    }
  }
  if (gridDim.y == 1) return;
  if (last_block(counter, gridDim.x * gridDim.y, tid == 0, tid == 0))
    fold_and_finish<THREADS / 32>(partial, out, counter, gridDim.y, c, 0, c, inv_n, tid);
}

// dx = a[c] * x + b[c] with a = dvar * (2/n), b = dmean * (1/n) - a * mean
// computed where it is used; V elements (16 bytes when V > 1) a thread.
// channels-last: the channel of element i is i % c (a vector holds V
// channels); planes: (i / hw) % c (a vector holds one).
template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kDxThreads)
bn_dx_kernel(const T* __restrict__ x, const float* __restrict__ dmean,
             const float* __restrict__ dvar, const float* __restrict__ mean, T* __restrict__ dx,
             unsigned total, unsigned c, unsigned hw, float inv_n, float two_inv_n) {
  const unsigned stride = gridDim.x * kDxThreads * V;
  for (unsigned i = (blockIdx.x * kDxThreads + threadIdx.x) * V; i < total; i += stride) {
    __align__(16) T in[V];
    __align__(16) T res[V];
    if constexpr (V > 1) {
      *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(x + i);
    } else {
      in[0] = x[i];
    }
    const unsigned ch0 = CL ? i % c : (i / hw) % c;
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (CL || j == 0) {
        const unsigned ch = ch0 + j;
        a = __fmul_rn(__ldg(dvar + ch), two_inv_n);
        b = __fsub_rn(__fmul_rn(__ldg(dmean + ch), inv_n), __fmul_rn(a, __ldg(mean + ch)));
      }
      store(res + j, __fadd_rn(__fmul_rn(a, to_f32(in[j])), b));
    }
    if constexpr (V > 1) {
      *reinterpret_cast<uint4*>(dx + i) = *reinterpret_cast<const uint4*>(res);
    } else {
      dx[i] = res[0];
    }
  }
}

template <typename T, int THREADS, int LANES>
void planes(const void* x, float* partial, float* out, unsigned* counter, int b, int c, int hw,
            int p, int per_block, float inv_n, cudaStream_t stream) {
  // 16-byte loads when no load can straddle the end of a slice or start off
  // a 16-byte boundary
  constexpr int kVec = 16 / (int)sizeof(T);
  const bool vec = hw % kVec == 0 && (p == 1 || per_block % kVec == 0) && (uintptr_t)x % 16 == 0;
  dim3 grid(c, p);
  if (vec)
    bn_moments_planes_kernel<T, THREADS, LANES, kVec><<<grid, THREADS, 0, stream>>>(
        (const T*)x, partial, out, counter, b, c, hw, per_block, inv_n);
  else
    bn_moments_planes_kernel<T, THREADS, LANES, 1><<<grid, THREADS, 0, stream>>>(
        (const T*)x, partial, out, counter, b, c, hw, per_block, inv_n);
}

template <typename T>
int moments(const void* x, float* partial, float* out, unsigned* counter, int channels_last,
            int b, int c, int hw, int p, int per_block, int threads, int lanes, float inv_n,
            cudaStream_t stream) {
  if (channels_last) {
    dim3 grid(p, (c + 31) / 32), block(32, kRowsPerPass);
    bn_moments_cl_kernel<T><<<grid, block, 0, stream>>>((const T*)x, partial, out, counter,
                                                        (long long)b * hw, c, per_block, inv_n);
  } else if (threads == 256 && lanes == 256) {
    planes<T, 256, 256>(x, partial, out, counter, b, c, hw, p, per_block, inv_n, stream);
  } else if (threads == 256 && lanes == 32) {
    planes<T, 256, 32>(x, partial, out, counter, b, c, hw, p, per_block, inv_n, stream);
  } else if (threads == 128 && lanes == 32) {
    planes<T, 128, 32>(x, partial, out, counter, b, c, hw, p, per_block, inv_n, stream);
  } else {
    return (int)cudaErrorInvalidValue;   // not a block shape the plan makes
  }
  return (int)cudaGetLastError();
}

template <typename T, int V>
int dx_launch(const void* x, const float* dmean, const float* dvar, const float* mean, void* dx,
              int channels_last, int vec, unsigned total, unsigned c, unsigned hw, float inv_n,
              float two_inv_n, cudaStream_t stream) {
  const unsigned per = vec ? V : 1;
  unsigned blocks = (total / per + kDxThreads - 1) / kDxThreads;
  if (blocks > 132u * 16u) blocks = 132u * 16u;   // grid-stride beyond 16 blocks an SM
  if (blocks == 0) blocks = 1;
  const T* xi = (const T*)x;
  T* o = (T*)dx;
  if (vec && channels_last)
    bn_dx_kernel<T, V, true><<<blocks, kDxThreads, 0, stream>>>(xi, dmean, dvar, mean, o, total,
                                                                c, hw, inv_n, two_inv_n);
  else if (vec)
    bn_dx_kernel<T, V, false><<<blocks, kDxThreads, 0, stream>>>(xi, dmean, dvar, mean, o, total,
                                                                 c, hw, inv_n, two_inv_n);
  else if (channels_last)
    bn_dx_kernel<T, 1, true><<<blocks, kDxThreads, 0, stream>>>(xi, dmean, dvar, mean, o, total,
                                                                c, hw, inv_n, two_inv_n);
  else
    bn_dx_kernel<T, 1, false><<<blocks, kDxThreads, 0, stream>>>(xi, dmean, dvar, mean, o, total,
                                                                 c, hw, inv_n, two_inv_n);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward, one launch. x: b*c*hw elements (bf16 when is_bf16, else f32),
// channels-last or NCHW planes. workspace: kCounters 32-bit ticket counters
// (0 before every launch; the kernel leaves them 0; planes use the first,
// channels-last one per 32 channels), then p*2*c f32 of partial sums; one
// workspace serves one stream at a time. out: 4*c
// f32 (sum, sumsq, mean, var). p blocks along the reduced axis, each taking
// per_block rows (channels-last) or per_block elements of a plane (planes,
// with `threads` = 128 or 256 threads a block in groups of `lanes` = 32 or
// 256); the wrapper's plan picks them. inv_n = 1.0f / f32(b*hw).
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int bn_moments_launch(const void* x, void* workspace, void* out, int is_bf16,
                                 int channels_last, int b, int c, int hw, int p, int per_block,
                                 int threads, int lanes, float inv_n, void* stream) {
  if (b <= 0 || c <= 0 || hw <= 0 || p <= 0 || per_block <= 0) return (int)cudaErrorInvalidValue;
  if (channels_last && (c + 31) / 32 > kCounters) return (int)cudaErrorInvalidValue;
  unsigned* counter = (unsigned*)workspace;
  float* partial = (float*)workspace + kCounters;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return moments<__nv_bfloat16>(x, partial, (float*)out, counter, channels_last, b, c, hw, p,
                                  per_block, threads, lanes, inv_n, s);
  return moments<float>(x, partial, (float*)out, counter, channels_last, b, c, hw, p, per_block,
                        threads, lanes, inv_n, s);
}

// Backward, one launch. dmean, dvar, mean: c f32. dx like x. vec: 16-byte
// accesses are allowed (the wrapper checked alignment and that a vector never
// straddles a channel boundary it may not). total = b*c*hw < 2^31.
extern "C" int bn_moments_dx_launch(const void* x, const void* dmean, const void* dvar,
                                    const void* mean, void* dx, int is_bf16, int channels_last,
                                    int vec, int b, int c, int hw, float inv_n, float two_inv_n,
                                    void* stream) {
  if (b <= 0 || c <= 0 || hw <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned total = (unsigned)b * (unsigned)c * (unsigned)hw;
  const float *dm = (const float*)dmean, *dv = (const float*)dvar, *mu = (const float*)mean;
  if (is_bf16)
    return dx_launch<__nv_bfloat16, 8>(x, dm, dv, mu, dx, channels_last, vec, total, c, hw,
                                       inv_n, two_inv_n, s);
  return dx_launch<float, 4>(x, dm, dv, mu, dx, channels_last, vec, total, c, hw, inv_n,
                             two_inv_n, s);
}
