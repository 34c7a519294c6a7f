// K3 — fused int8 1x1 conv: matrix product + requant epilogue in one launch.
//
// Replaces the Pallas TPU kernel yolov3_tpu/ops/pallas/conv1x1.py
// (conv1x1_int8_requant / _kernel). Contract:
//   acc = x (M, K) s8  .  w (N, K) s8 ^T          s32, exact
//   y   = f32(acc) * scale[n] + bias[n];  y = leaky(y) if asked
//   out = s8(requant_clip(y, *inv))   or   out = y (f32)
// x is the NHWC activation as a matrix (M = B*H*W rows, K = Cin), w the
// packed weight with one row per output channel. M, K and N may be ragged:
// copies are zero-filled and stores masked. The TPU kernel's VMEM tile
// picking and its lane gates (MIN_CIN / MIN_COUT) have no counterpart.
//
// What bounds it on an H100, and the three paths conv1x1_int8_launch picks
// from the shape (ops/cuda/conv1x1.py::plan mirrors the choice):
//
//   * K % 16 == 0, K <= 128 and N <= 128 (the Darknet squeeze convs at high
//     resolution, 208^2 64->32 and 104^2 128->64): bytes. At M = 692,224,
//     64 -> 32 the launch moves 66 MB (int8 out) for 2.8 GOP, and a tile has
//     one k-tile, so a ring over the contraction has nothing to overlap. A
//     persistent grid walks the M-tiles: the (BN x K) weight tile is copied
//     once and stays in shared memory, the next M-tiles' activations are in
//     flight (16-byte cp.async into a ring) under the current tile's wgmma
//     and its epilogue, and the tile leaves through shared memory as 16-byte
//     stores. What a block waits on is the chain from a tile's products
//     through its epilogue, so the launch takes as many blocks an SM as
//     registers and shared memory allow (four at BN = 32) before ring depth.
//     BN = 32, 64 or 128 follows N, so 64 -> 32 multiplies no empty columns
//     (m64n32k32).
//   * K % 16 == 0 otherwise (every deeper 1x1 conv of YOLOv3, YOLOv3-SPP and
//     YOLOv3-tiny): operations and the rate at which a block pulls operands
//     out of L2. Tiles of 128 x 64 on the Hopper main loop of int8_wgmma.cuh
//     (a three-stage cp.async ring, two warpgroups of wgmma) with a plain row
//     loader, or 128 x 32 where 128 x 64 tiles would not fill the card's
//     block slots (13^2, 26^2 256->128 and the serving buckets): there too
//     a block waits on the chain from its loads through its epilogue, and
//     more, narrower tiles overlap more chains. The contraction is not split
//     over a cluster as K6's is: measured at every 13^2 shape (B = 1, 4, 16,
//     Cin up to 2048), the split's extra synchronisation cost more than the
//     shorter k-loop saved. The staged epilogue is the header's, shared with
//     K6.
//   * K % 16 != 0 (no 16-byte copies of a row): mma.sync m16n8k32 from one
//     shared-memory stage (int8_mma.cuh), byte loads.
//
// On every path the s32 sums stay in registers from the first product to the
// epilogue (requant.cuh, unchanged), which rounds where the plain version's
// element-wise ops do, so the output is bit-equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"
#include "int8_wgmma.cuh"
#include "requant.cuh"

namespace {

using namespace yolo_int8;

// ---------------------------------------------------------- persistent path

constexpr uint32_t kATile = wg::kBM * wg::kBK;   // one M-tile of activations, 16 KB
constexpr int kSmemPerSm = 233472;               // shared memory of an SM for its blocks
constexpr int kBlockReserve = 2048;              // the system's 1 KB a block, and 1 KB spare

// Most blocks an SM holds by registers (BN = 32, 64, 128 take 56, 84 and 117).
__host__ __device__ constexpr int max_blocks(int bn) { return bn == 32 ? 4 : bn == 64 ? 3 : 2; }

// Dynamic shared memory of a persistent launch: the resident weight tile, the
// ring of `stages` activation tiles, the output stage, and room to align.
constexpr uint32_t persistent_smem(int bn, int stages, bool out_f32) {
  return bn * wg::kBK + stages * kATile + wg::kBM * (bn + 16) * (out_f32 ? 4 : 1) + 1024;
}

template <int BN>
__global__ void __launch_bounds__(wg::kThreads, max_blocks(BN))
conv1x1_int8_persistent_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                               const float* __restrict__ scale, const float* __restrict__ bias,
                               const float* __restrict__ inv_ptr, void* __restrict__ out, int m,
                               int k, int n, int leaky_on, int out_f32, int vec_out,
                               int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t b_tile = (raw + 1023u) & ~1023u;
  const uint32_t ring = b_tile + BN * wg::kBK;
  uint8_t* const out_stage = smem_raw + (ring + stages * kATile - raw);

  const int tid = threadIdx.x;
  const int mt = (m + wg::kBM - 1) / wg::kBM;
  const int kmma = (k + 31) / 32;        // k32 products a tile needs (K <= 128: at most 4)
  const int chunk = tid & 7, row0 = tid >> 3;
  // this thread copies 16-byte chunk `chunk` of rows row0 + 32 j; chunks past
  // K but inside the last product are zero-filled, later ones never read
  const bool copies = chunk < 2 * kmma, k_in = chunk * 16 < k;

  if (copies) {
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int r = row0 + 32 * j;
      const bool ok = k_in && r < n;
      wg::cp_async_16_ca(wg::swizzled(b_tile, r, chunk), ok ? w + (size_t)r * k + chunk * 16 : w,
                         ok);
    }
  }
  wg::cp_async_commit();   // the weight tile: the oldest group, so complete with the first A
  auto load_a = [&](uint32_t slot, int tile) {
    if (!copies) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = tile * wg::kBM + row0 + 32 * j;
      const bool ok = k_in && row < m;
      wg::cp_async_16_cg(wg::swizzled(slot, row0 + 32 * j, chunk),
                         ok ? x + (size_t)row * k + chunk * 16 : x, ok);
    }
  };

  int issued = blockIdx.x;
  for (int s = 0; s < stages - 1; ++s) {
    if (issued < mt) load_a(ring + s * kATile, issued);
    issued += gridDim.x;
    wg::cp_async_commit();
  }
  const float inv = out_f32 ? 0.0f : *inv_ptr;
  const uint32_t a_rows = (tid >> 7) * 64 * wg::kBK;
  int slot = 0, fill = stages - 1;
  for (int tile = blockIdx.x; tile < mt; tile += gridDim.x) {
    if (stages == 4) wg::cp_async_wait<2>();
    else if (stages == 3) wg::cp_async_wait<1>();
    else wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    // this tile's copies have landed everywhere, and every thread is done
    // with the slot refilled below and with the output stage
    __syncthreads();
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const uint32_t a = ring + slot * kATile + a_rows;
    wg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < kmma)
        wg::mma_k32<BN>(acc, wg::tile_desc(a + 32 * j), wg::tile_desc(b_tile + 32 * j));
    }
    wg::wgmma_commit();
    if (issued < mt) load_a(ring + fill * kATile, issued);
    issued += gridDim.x;
    wg::cp_async_commit();
    wg::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
    wg::store_tile<BN>(out_stage, acc, tile * wg::kBM, 0, m, n, scale, bias, leaky_on, out_f32,
                       inv, vec_out, out);
    slot = slot + 1 == stages ? 0 : slot + 1;
    fill = fill + 1 == stages ? 0 : fill + 1;
  }
  wg::cp_async_wait<0>();
}

// Blocks an SM and ring depth of a persistent launch: the most blocks the
// registers allow that fit the SM's shared memory with at least two stages,
// each with the deepest ring that still fits; else one block of four stages.
// The chain from a tile's products through its epilogue to its stores is
// what a block waits on, so blocks come before stages.
// ops/cuda/conv1x1.py::plan mirrors this.
void persistent_shape(int bn, bool out_f32, int* stages, int* per_sm) {
  for (int p = max_blocks(bn); p >= 2; --p) {
    for (int s = 4; s >= 2; --s) {
      if (p * ((int)persistent_smem(bn, s, out_f32) + kBlockReserve) <= kSmemPerSm) {
        *stages = s;
        *per_sm = p;
        return;
      }
    }
  }
  *stages = 4;
  *per_sm = 1;
}

template <int BN>
int launch_persistent(const void* x, const void* w, const void* scale, const void* bias,
                      const void* inv, void* out, int m, int k, int n, int leaky_on, int out_f32,
                      cudaStream_t stream) {
  auto kernel = conv1x1_int8_persistent_kernel<BN>;
  int stages, per_sm;
  persistent_shape(BN, out_f32, &stages, &per_sm);
  const uint32_t smem = persistent_smem(BN, stages, out_f32);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int mt = (m + wg::kBM - 1) / wg::kBM;
  const int grid = mt < per_sm * wg::kSms ? mt : per_sm * wg::kSms;
  kernel<<<grid, wg::kThreads, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)scale, (const float*)bias,
      (const float*)inv, out, m, k, n, leaky_on, out_f32, wg::vec_out_ok(out, n, out_f32),
      stages);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- tiled path

template <int BN>
__global__ void __launch_bounds__(wg::kThreads, 2)
conv1x1_int8_wgmma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          const float* __restrict__ inv_ptr, void* __restrict__ out, int m, int k,
                          int n, int leaky_on, int out_f32, int vec_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring - raw);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * wg::kBM, n0 = blockIdx.y * BN;

  // this thread copies 16-byte chunk `chunk` of tile rows row0 + 32 j
  const int chunk = tid & 7, row0 = tid >> 3;
  int kk = chunk * 16;
  auto load = [&](uint32_t stage) {
    const bool k_in = kk < k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + row0 + 32 * j;
      const bool ok = k_in && row < m;
      wg::cp_async_16_cg(wg::swizzled(stage, row0 + 32 * j, chunk),
                         ok ? x + (size_t)row * k + kk : x, ok);
    }
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int r = row0 + 32 * j;
      const bool ok = k_in && n0 + r < n;
      wg::cp_async_16_cg(wg::swizzled(stage + wg::kBM * wg::kBK, r, chunk),
                         ok ? w + (size_t)(n0 + r) * k + kk : w, ok);
    }
    kk += wg::kBK;
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  wg::mainloop<BN>(ring, 0, (k + wg::kBK - 1) / wg::kBK, load, acc);
  __syncthreads();   // the ring is free: it now carries the output tile
  const float inv = out_f32 ? 0.0f : *inv_ptr;
  wg::store_tile<BN>(ring_ptr, acc, m0, n0, m, n, scale, bias, leaky_on, out_f32, inv, vec_out,
                     out);
}

template <int BN>
int launch_tiled(const void* x, const void* w, const void* scale, const void* bias,
                 const void* inv, void* out, int m, int k, int n, int leaky_on, int out_f32,
                 cudaStream_t stream) {
  auto kernel = conv1x1_int8_wgmma_kernel<BN>;
  constexpr uint32_t smem = wg::ring_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + wg::kBM - 1) / wg::kBM, (n + BN - 1) / BN);
  kernel<<<grid, wg::kThreads, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)scale, (const float*)bias,
      (const float*)inv, out, m, k, n, leaky_on, out_f32, wg::vec_out_ok(out, n, out_f32));
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- byte path

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
int launch_bytes(const void* x, const void* w, const void* scale, const void* bias,
                 const void* inv, void* out, int m, int k, int n, int leaky_on, int out_f32,
                 cudaStream_t stream) {
  dim3 grid((m + kBM - 1) / kBM, (n + NF * 16 - 1) / (NF * 16));
  conv1x1_int8_kernel<NF><<<grid, kThreads, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)scale, (const float*)bias,
      (const float*)inv, out, m, k, n, leaky_on, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// x and w must be 16-byte aligned when k % 16 == 0 (the wrapper checks).
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int conv1x1_int8_launch(const void* x, const void* w, const void* scale,
                                   const void* bias, const void* inv, void* out, int m, int k,
                                   int n, int leaky_on, int out_f32, void* stream) {
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (k % 16 == 0) {
    if (((uintptr_t)x | (uintptr_t)w) % 16) return (int)cudaErrorMisalignedAddress;
    if (k <= wg::kBK && n <= 128) {
      if (n > 64) return launch_persistent<128>(x, w, scale, bias, inv, out, m, k, n, leaky_on,
                                                out_f32, s);
      if (n > 32) return launch_persistent<64>(x, w, scale, bias, inv, out, m, k, n, leaky_on,
                                               out_f32, s);
      return launch_persistent<32>(x, w, scale, bias, inv, out, m, k, n, leaky_on, out_f32, s);
    }
    // 128 x 64 tiles where they fill the card's block slots, else 128 x 32
    const int mt = (m + wg::kBM - 1) / wg::kBM;
    if ((long long)mt * ((n + 63) / 64) >= wg::kBlockSlots)
      return launch_tiled<64>(x, w, scale, bias, inv, out, m, k, n, leaky_on, out_f32, s);
    return launch_tiled<32>(x, w, scale, bias, inv, out, m, k, n, leaky_on, out_f32, s);
  }
  if (n > 64) return launch_bytes<8>(x, w, scale, bias, inv, out, m, k, n, leaky_on, out_f32, s);
  if (n > 32) return launch_bytes<4>(x, w, scale, bias, inv, out, m, k, n, leaky_on, out_f32, s);
  return launch_bytes<2>(x, w, scale, bias, inv, out, m, k, n, leaky_on, out_f32, s);
}
