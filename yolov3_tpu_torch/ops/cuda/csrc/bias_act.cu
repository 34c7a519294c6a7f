// K8 — the tail of a folded fp conv: the bias add and the activation after it
// in one pass, y = act(x + bias), act one of linear, leaky (slope 0.1), Mish.
//
// No Pallas kernel: K8 stands for XLA's fusion of the folded conv's bias add
// and yolov3_tpu/models/layers.py's leaky_relu on the JAX package's serving
// path. Contract (T = x's dtype, f32 or bf16; rn_T rounds to T, nearest even;
// every operation rounds once, where the element-wise PyTorch ops of the plain
// expression round):
//   per channel  b_T = rn_T(bias[c])              (the bias cast to x's dtype)
//   every element  v = rn_T(x + b_T)              (the add in f32)
//   linear  y = v
//   leaky   y = v >= 0 ? v : rn_T(v * 0.1f)
//   mish    y = rn_T(v * tanhf(log1pf(expf(v))))  (ATen's Mish: f32 math)
// x is a dense activation, logically (B, C, H, W), lying channels-last
// (element i has channel i mod C) or as NCHW planes (channel (i / HW) mod C);
// y lies as x. The build has --fmad=false and the math is libdevice's expf,
// log1pf and tanhf, which ATen's Mish kernel calls, so y is bit-equal to the
// plain expression evaluated by PyTorch on the card.
//
// What bounds it on an H100: bytes, 2 * sizeof(T) an element, for linear and
// leaky. Mish's f32 math is some fifty instructions and three MUFU operations
// an element, more time than the element's bytes take, so in bf16 Mish reads
// most of its results from a table: v is a bf16 number, and the 4,096 with
// |v| in [2^-8, 2^8) (kTableLow, kTableSpan) have their rn_T(mish(v)) in a
// table that bias_act_mish_table_kernel computes once a device with the same
// function; every other v evaluates it. So:
//   * one launch, one 16-byte vector a thread, the grid covering the flat
//     tensor once (on the H100 that ran 5-14% faster than a resident wave of
//     blocks walking it with a grid stride, two vectors a thread in flight),
//     the elements past the last whole vector one a thread;
//   * each block stages the C rounded biases (and Mish's table, 8 KB) in
//     shared memory; a vector's first channel comes from one fast division
//     (multiply-high and shift) in channels-last memory, two in NCHW, and the
//     channels of its other elements follow by increments; a vector that lies
//     in one row (channels-last, read as float4 biases) or one plane (NCHW,
//     one bias) takes the short path;
//   * each activation is a kernel of its own name (bias_act_linear_kernel,
//     bias_act_leaky_kernel, bias_act_mish_kernel), so a profile tells them
//     apart.

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
constexpr float kSlope = 0.1f;
// Mish's bf16 table: the bf16 numbers whose magnitude's bits lie in
// [kTableLow, kTableLow + kTableSpan), 16 exponents of 128 mantissas each,
// both signs: entry (sign << 11) | (bits & 0x7fff) - kTableLow.
constexpr unsigned kTableLow = (127u - 8u) << 7;
constexpr unsigned kTableSpan = 16u << 7;
constexpr int kTableSize = 2 * kTableSpan;
constexpr int kTableBytes = kTableSize * 2;

// n / d as __umulhi(n, m) >> s for 0 <= n < 2^31 (m = 0: d = 1).
struct Div {
  unsigned m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return m ? __umulhi(n, m) >> s : n;
  }
};

Div make_div(unsigned d) {
  if (d == 1) return {0u, 0u};
  unsigned l = 0;
  while ((1ull << l) < d) ++l;   // ceil(log2 d)
  return {(unsigned)(((1ull << (31 + l)) + d - 1) / d), l - 1};
}

struct Args {
  const void* x;
  void* y;
  const void* bias;   // f32 or bf16
  const uint16_t* table;   // Mish in bf16: kTableSize bf16 results
  int bias_bf16;
  int n;   // elements
  int c;
  int hw;
  Div dc, dhw;
};

__device__ __forceinline__ float mish_f32(float v) {
  return __fmul_rn(v, tanhf(log1pf(expf(v))));
}

struct Linear {
  template <typename T> __device__ __forceinline__ T operator()(float v) const {
    return from_f32<T>(v);
  }
};

struct Leaky {
  template <typename T> __device__ __forceinline__ T operator()(float v) const {
    return from_f32<T>(v >= 0.0f ? v : __fmul_rn(v, kSlope));
  }
};

struct Mish {
  const uint16_t* table;   // shared memory; bf16 only
  template <typename T> __device__ __forceinline__ T operator()(float v) const {
    if constexpr (sizeof(T) == 2) {
      const unsigned bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));   // exact
      const unsigned rel = (bits & 0x7fffu) - kTableLow;
      if (rel < kTableSpan) return __ushort_as_bfloat16(table[((bits >> 15) << 11) | rel]);
    }
    return from_f32<T>(mish_f32(v));
  }
};

template <typename T, typename Act>
__device__ __forceinline__ T element(T x, float b, const Act& act) {
  return act.template operator()<T>(rn<T>(__fadd_rn(to_f32(x), b)));
}

// The channel of element i, and in NCHW memory its offset r in its plane.
template <bool CL>
__device__ __forceinline__ void position(unsigned i, const Args& a, int& ch, int& r) {
  if (CL) {
    ch = (int)(i - a.dc.div(i) * a.c);
    r = 0;
  } else {
    const unsigned q = a.dhw.div(i);
    r = (int)(i - q * a.hw);
    ch = (int)(q - a.dc.div(q) * a.c);
  }
}

// V elements from flat index i.
template <typename T, int V, bool CL, typename Act>
__device__ __forceinline__ void vector(const T (&in)[V], T (&out)[V], unsigned i, const Args& a,
                                       const float* sb, const Act& act) {
  int ch, r;
  position<CL>(i, a, ch, r);
  if constexpr (CL && V % 4 == 0) {
    if (ch + V <= a.c && (ch & 3) == 0) {   // one row, biases 16-byte aligned
      __align__(16) float b[V];
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(b + j) = *reinterpret_cast<const float4*>(sb + ch + j);
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = element(in[j], b[j], act);
      return;
    }
  }
  if constexpr (!CL) {
    if (r + V <= a.hw) {   // one plane
      const float b = sb[ch];
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = element(in[j], b, act);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    out[j] = element(in[j], sb[ch], act);
    if (CL) {
      if (++ch == a.c) ch = 0;
    } else if (++r == a.hw) {
      r = 0;
      if (++ch == a.c) ch = 0;
    }
  }
}

// Shared memory: Mish's table (kTableBytes) when `table`, then C f32 biases,
// each rounded to T. Returns the biases.
template <typename T>
__device__ __forceinline__ const float* stage(const Args& a, unsigned char* smem, bool table) {
  float* sb = reinterpret_cast<float*>(smem + (table ? kTableBytes : 0));
  if (table)
    for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(a.table)[i];
  for (int ch = threadIdx.x; ch < a.c; ch += blockDim.x) {
    const float b = a.bias_bf16
                        ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.bias)[ch])
                        : reinterpret_cast<const float*>(a.bias)[ch];
    sb[ch] = rn<T>(b);
  }
  __syncthreads();
  return sb;
}

// One vector of V elements a thread, the grid covering the flat tensor once;
// the threads past the last whole vector take the last n % V elements, one
// each.
template <typename T, int V, bool CL, typename Act>
__device__ __forceinline__ void run(const Args& a, const float* sb, const Act& act) {
  const T* x = reinterpret_cast<const T*>(a.x);
  T* y = reinterpret_cast<T*>(a.y);
  const unsigned nvec = (unsigned)a.n / V;
  const unsigned k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < nvec) {
    __align__(16) T in[V], out[V];
    load<T, V>(x + (size_t)k * V, in);
    vector<T, V, CL>(in, out, k * V, a, sb, act);
    store<T, V>(y + (size_t)k * V, out);
  } else if (k - nvec < (unsigned)a.n - nvec * V) {
    const unsigned i = nvec * V + (k - nvec);
    int ch, r;
    position<CL>(i, a, ch, r);
    y[i] = element(x[i], sb[ch], act);
  }
}

template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads) bias_act_linear_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  run<T, V, CL>(a, stage<T>(a, smem, false), Linear{});
}

template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads) bias_act_leaky_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  run<T, V, CL>(a, stage<T>(a, smem, false), Leaky{});
}

template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads) bias_act_mish_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool table = sizeof(T) == 2;
  const float* sb = stage<T>(a, smem, table);
  run<T, V, CL>(a, sb, Mish{reinterpret_cast<const uint16_t*>(smem)});
}

// The table's entries, one a thread: entry e is the bf16 number of sign e >> 11
// and magnitude bits kTableLow + (e & (kTableSpan - 1)).
__global__ void bias_act_mish_table_kernel(uint16_t* table) {
  const unsigned e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (unsigned)kTableSize) return;
  const unsigned bits = ((e >> 11) << 15) | (kTableLow + (e & (kTableSpan - 1)));
  const float v = __bfloat162float(__ushort_as_bfloat16((unsigned short)bits));
  table[e] = __bfloat16_as_ushort(__float2bfloat16_rn(mish_f32(v)));
}

template <typename T, int V, bool CL>
int launch(int activation, const Args& a, int blocks, cudaStream_t stream) {
  const bool table = activation == 2 && sizeof(T) == 2;
  const size_t smem = (table ? kTableBytes : 0) + (size_t)a.c * sizeof(float);
  void (*kernel)(Args) = activation == 0   ? bias_act_linear_kernel<T, V, CL>
                         : activation == 1 ? bias_act_leaky_kernel<T, V, CL>
                                           : bias_act_mish_kernel<T, V, CL>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(int activation, int channels_last, int vec, const Args& a, int blocks,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (channels_last)
    return vec ? launch<T, kVec, true>(activation, a, blocks, stream)
               : launch<T, 1, true>(activation, a, blocks, stream);
  return vec ? launch<T, kVec, false>(activation, a, blocks, stream)
             : launch<T, 1, false>(activation, a, blocks, stream);
}

}  // namespace

// One launch: y = act(x + bias) over n elements (0 < n < 2^31) of a dense
// activation with c channels and hw = H * W, channels-last or NCHW planes.
// x and y: bf16 when is_bf16, else f32, y laid out as x; bias: c elements,
// bf16 when bias_bf16, else f32. activation: 0 linear, 1 leaky, 2 Mish.
// table: Mish's bf16 table (bias_act_mish_table_launch), read when activation
// is 2 and is_bf16. vec: 16-byte accesses are allowed (the wrapper checked
// that x and y are 16-byte aligned). blocks: the wrapper's grid, kThreads
// threads a block and one a vector or a last element. Launches on `stream`;
// returns the launch's cudaError_t.
extern "C" int bias_act_launch(const void* x, const void* bias, void* y, const void* table,
                               int is_bf16, int bias_bf16, int channels_last, int activation,
                               int vec, int n, int c, int hw, int blocks, void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0 || blocks <= 0 || activation < 0 || activation > 2 ||
      (activation == 2 && is_bf16 && table == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{x, y, bias, (const uint16_t*)table, bias_bf16, n, c, hw, make_div((unsigned)c),
               make_div((unsigned)hw)};
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_dtype<__nv_bfloat16>(activation, channels_last, vec, a, blocks, st)
                 : launch_dtype<float>(activation, channels_last, vec, a, blocks, st);
}

// Mish's bf16 table: kTableSize (4,096) bf16 results into `table`, 16-byte
// aligned. Launches on `stream`; returns the launch's cudaError_t.
extern "C" int bias_act_mish_table_launch(void* table, void* stream) {
  bias_act_mish_table_kernel<<<kTableSize / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (uint16_t*)table);
  return (int)cudaGetLastError();
}
