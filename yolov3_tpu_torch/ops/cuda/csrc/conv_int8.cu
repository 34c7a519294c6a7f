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
// bytes per output channel, tap-major), out (B,Ho,Wo,N). Any kh = kw, stride,
// asymmetric padding and ragged M / N work; the im2col matrix is never built
// in device memory.
//
// What bounds it on an H100: operations (a 3x3 conv does 9*Cin products per
// output byte), and before the tensor cores' rate the rate at which a block
// can pull its operands out of the L2 cache: a 128 x 128 tile needs 32 KB for
// every 2 M products. Two paths, chosen from the shape in conv_int8_launch:
//
//   * Cin % 16 == 0 (every conv but the image's): the Hopper path. A 16-byte
//     chunk of the contraction lies inside one tap, so a block gathers its
//     (128 rows x 128 contraction bytes) A-tile and the (BN x 128) weight tile
//     with 16-byte cp.async copies, zero-filled for the halo, for rows past M
//     or N and for the ragged end of the contraction, into a three-stage ring
//     in shared memory, and two warpgroups multiply the stage that has
//     arrived with wgmma (int8_wgmma.cuh) while the next two are in flight.
//     A thread owns one chunk column of four rows: their (image, ih0, iw0)
//     are computed once, and its position in the contraction (tap dy, dx and
//     channel) moves from k-tile to k-tile by additions only. The epilogue
//     (requant.cuh, unchanged) writes the tile into the ring's memory and the
//     block stores it 16 bytes a thread along N. Where a shape gives fewer
//     tiles than the card has room for (batch 1 and 4 at 13^2 and 26^2), the
//     contraction is split over the blocks of a thread-block cluster: each
//     sums its share of the k-tiles, the others hand their s32 sums to the
//     first through distributed shared memory, and that one runs the
//     epilogue once on the full sum. s32 sums are exact in any order, so the
//     output does not depend on the split. The staged epilogue is
//     int8_wgmma.cuh's, shared with K3.
//   * otherwise (Cin = 3, the image): the gather goes byte by byte and the
//     contraction is padded to the tile with zeros in shared memory, never
//     in the activations; the product is the mma.sync loop shared with K3
//     (int8_mma.cuh).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"
#include "int8_wgmma.cuh"
#include "requant.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace yolo_int8;

struct Geom {
  int h, w, cin, kw, stride, top, left, ho, wo;
};

// ---------------------------------------------------------------- wgmma path

constexpr int kMaxSplit = 8;  // portable cluster size

template <int BN>
__global__ void __launch_bounds__(wg::kThreads, 2)
conv_int8_wgmma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       const float* __restrict__ inv_ptr, void* __restrict__ out, Geom g, int m,
                       int k, int n, int leaky_on, int out_f32, int vec_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring - raw);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * wg::kBM, n0 = blockIdx.y * BN;
  const int split = gridDim.z, kt_all = (k + wg::kBK - 1) / wg::kBK;
  const int kt0 = (int)((long long)kt_all * blockIdx.z / split);
  const int kt1 = (int)((long long)kt_all * (blockIdx.z + 1) / split);

  // this thread copies 16-byte chunk `chunk` of tile rows row0 + 32 j
  const int chunk = tid & 7, row0 = tid >> 3;
  int a_off[4], a_ih[4], a_iw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = m0 + row0 + 32 * j;
    if (row < m) {
      const int ow = row % g.wo, t = row / g.wo;
      const int oh = t % g.ho, b = t / g.ho;
      a_off[j] = b * g.h * g.w * g.cin;
      a_ih[j] = oh * g.stride - g.top;
      a_iw[j] = ow * g.stride - g.left;
    } else {   // a row past M: never inside the image
      a_off[j] = 0;
      a_ih[j] = -(1 << 24);
      a_iw[j] = 0;
    }
  }
  // where this thread's chunk of the next k-tile lies in the contraction
  int kk = kt0 * wg::kBK + chunk * 16;
  int ci, dy, dx;
  {
    const int tap = kk / g.cin;
    ci = kk - tap * g.cin;
    dy = tap / g.kw;
    dx = tap - dy * g.kw;
  }
  auto load = [&](uint32_t stage) {
    const bool k_in = kk < k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ih = a_ih[j] + dy, iw = a_iw[j] + dx;
      const bool ok = k_in && (unsigned)ih < (unsigned)g.h && (unsigned)iw < (unsigned)g.w;
      const int8_t* src = ok ? x + a_off[j] + (ih * g.w + iw) * g.cin + ci : x;
      wg::cp_async_16_ca(wg::swizzled(stage, row0 + 32 * j, chunk), src, ok);
    }
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int r = row0 + 32 * j;
      const bool ok = k_in && n0 + r < n;
      const int8_t* src = ok ? w + (size_t)(n0 + r) * k + kk : w;
      wg::cp_async_16_cg(wg::swizzled(stage + wg::kBM * wg::kBK, r, chunk), src, ok);
    }
    kk += wg::kBK;
    ci += wg::kBK;
    while (ci >= g.cin) {
      ci -= g.cin;
      if (++dx == g.kw) {
        dx = 0;
        ++dy;
      }
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  wg::mainloop<BN>(ring, kt0, kt1, load, acc);
  __syncthreads();   // the ring is free: it now carries sums or the output tile

  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    int* red = reinterpret_cast<int*>(ring_ptr);
    const unsigned rank = cluster.block_rank();
    if (rank != 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) red[i * wg::kThreads + tid] = acc[i];
    }
    cluster.sync();
    if (rank == 0) {
      for (int z = 1; z < split; ++z) {
        const int* theirs = cluster.map_shared_rank(red, z);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += theirs[i * wg::kThreads + tid];
      }
    }
    cluster.sync();   // no block leaves while its sums may still be read
    if (rank != 0) return;
  }

  const float inv = out_f32 ? 0.0f : *inv_ptr;
  wg::store_tile<BN>(ring_ptr, acc, m0, n0, m, n, scale, bias, leaky_on, out_f32, inv, vec_out,
                     out);
}

// Blocks of the contraction's split for a grid of `tiles` output tiles and
// `kt` k-tiles: doubled while the grid still fits the card at two blocks an SM
// and every block keeps at least two k-tiles. ops/cuda/conv_int8.py::plan
// mirrors this.
int pick_split(int tiles, int kt) {
  int split = 1;
  while (split < kMaxSplit && tiles * split * 2 <= wg::kBlockSlots && kt >= split * 4) split *= 2;
  return split;
}

template <int BN>
int launch_wgmma(const void* x, const void* w, const void* scale, const void* bias,
                 const void* inv, void* out, const Geom& g, int m, int k, int n, int flags,
                 cudaStream_t stream) {
  auto kernel = conv_int8_wgmma_kernel<BN>;
  constexpr uint32_t smem = wg::ring_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int mt = (m + wg::kBM - 1) / wg::kBM, nt = (n + BN - 1) / BN;
  const int split = pick_split(mt * nt, (k + wg::kBK - 1) / wg::kBK);
  const int out_f32 = (flags >> 1) & 1;
  const int vec_out = wg::vec_out_ok(out, n, out_f32);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mt, nt, split);
  cfg.blockDim = dim3(wg::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const int8_t*)x, (const int8_t*)w, (const float*)scale,
                           (const float*)bias, (const float*)inv, out, g, m, k, n, flags & 1,
                           out_f32, vec_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- byte path

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
conv_int8_bytes_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       const float* __restrict__ inv_ptr, void* __restrict__ out, Geom g, int m,
                       int k, int n, int leaky_on, int out_f32) {
  constexpr int BN = NF * 16;
  __shared__ __align__(16) int8_t a_s[kBM * kLd];
  __shared__ __align__(16) int8_t b_s[BN * kLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const bool vec_b = (k % 16) == 0 && ((uintptr_t)w % 16) == 0;

  int acc[2][NF][4];
  zero_acc<NF>(acc);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    // this thread owns contraction byte (tid & 63) of rows tid / 64 + 4 j
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
int launch_bytes(const void* x, const void* w, const void* scale, const void* bias,
                 const void* inv, void* out, const Geom& g, int m, int k, int n, int flags,
                 cudaStream_t stream) {
  dim3 grid((m + kBM - 1) / kBM, (n + NF * 16 - 1) / (NF * 16));
  conv_int8_bytes_kernel<NF><<<grid, kThreads, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)scale, (const float*)bias,
      (const float*)inv, out, g, m, k, n, flags & 1, (flags >> 1) & 1);
  return (int)cudaGetLastError();
}

}  // namespace

// flags: bit 0 = leaky, bit 1 = f32 output. x and w must be 16-byte aligned
// when cin % 16 == 0 (the wrapper checks). Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int conv_int8_launch(const void* x, const void* w, const void* scale,
                                const void* bias, const void* inv, void* out, int batch, int h,
                                int wd, int cin, int cout, int kh, int kw, int stride, int top,
                                int left, int ho, int wo, int flags, void* stream) {
  const int m = batch * ho * wo, k = kh * kw * cin;
  if (m == 0 || cout == 0) return 0;
  const Geom g{h, wd, cin, kw, stride, top, left, ho, wo};
  cudaStream_t s = (cudaStream_t)stream;
  if (cin % 16 == 0) {
    if (((uintptr_t)x | (uintptr_t)w) % 16) return (int)cudaErrorMisalignedAddress;
    if (cout > 64) return launch_wgmma<128>(x, w, scale, bias, inv, out, g, m, k, cout, flags, s);
    return launch_wgmma<64>(x, w, scale, bias, inv, out, g, m, k, cout, flags, s);
  }
  if (cout > 64) return launch_bytes<8>(x, w, scale, bias, inv, out, g, m, k, cout, flags, s);
  if (cout > 32) return launch_bytes<4>(x, w, scale, bias, inv, out, g, m, k, cout, flags, s);
  return launch_bytes<2>(x, w, scale, bias, inv, out, g, m, k, cout, flags, s);
}
