// K1 — greedy NMS suppression sweep over a precomputed IoU>thr matrix.
//
// Replaces the Pallas TPU kernel yolov3_tpu/ops/pallas/nms_kernel.py
// (pallas_suppression_sweep / _suppress_kernel). Contract:
//   keep[i] = valid[i] && !sup[i];  sup[j] |= keep[i] && M[i, j]  for j > i
// for each image b of M (B, K, K) uint8 (nonzero = true) and valid (B, K)
// uint8; writes keep (B, K) uint8 {0,1}. Any K >= 1, ragged.
//
// What bounds it on an H100: not bytes (the matrix at B=16, K=512 is 4 MB,
// about 1.3 us of HBM at 3.35 TB/s) but the chain of dependent steps: step i
// needs the final state of sup[i], which every earlier kept row may have
// written. The design shortens that chain to K/32 steps on registers:
//
//   * Pack. The matrix is turned into bits: word w of row i holds M[i, 32w+b]
//     in bit b, for j > i only (the rest are zero or never read), from
//     16-byte loads turned into bits (K % 16 == 0) or from a warp's ballots of
//     byte loads. Rows of invalid candidates are never kept and not packed.
//     The packed image (K x ceil(K/32) words, 213 KB at K = 1300) lives in
//     shared memory and the sweeping block packs it with all its warps: one
//     launch.
//   * Sweep. One warp per image, with no block barrier. "Dead" (invalid or
//     suppressed) is a bit mask, lane l holding words l, l + 32, ... For each
//     word w of 32 candidates, all lanes resolve its candidates in order from
//     the 32 x 32 diagonal bit block (row 32w+b's word w, one word a lane,
//     handed round by shuffles; only live rows that suppress something in
//     the word take a step); then each lane ORs the kept rows into its own
//     later words, read from the resident image. Only __syncwarp and shuffles
//     order the steps.
//
// The TPU kernel's K % 128 limit was a VMEM layout limit and is gone; its
// K <= 1024 becomes K <= kSmemMaxK = 1300, what one block's shared memory
// holds (ops/nms.py sends K above 512 to the round sweep).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemMaxK = 1300;    // largest K whose packed image stays in shared memory
constexpr int kBlockThreads = 1024;  // the one-launch kernel: all warps pack, one sweeps
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int words_of(int k) { return (k + 31) >> 5; }

// bit c (c < 4) set where byte c of x is nonzero
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  const uint32_t t = ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u);
  return (t * 0x00204081u) >> 28;
}

// bits of word w that stand for columns j > i
__device__ __forceinline__ uint32_t above(int i, int w) {
  const int wi = i >> 5;
  return w > wi ? kAll : w < wi ? 0u : ~((2u << (i & 31)) - 1u);
}

__device__ __forceinline__ bool bit(const uint32_t* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// One warp packs rows r0, r0 + step, ... (< r1) of one image whose bit is
// set in `valid` (shared memory, bit i - vbase = candidate i; vbase a multiple
// of 32) into dst + i * pitch: words [i / 32, ceil(K / 32)), bit b of word w =
// (M[i, 32w+b] != 0 && 32w+b > i). A warp step makes kWords words of a row:
// VEC (K % 16 == 0, rows 16-byte aligned): a lane loads 16 bytes and a lane
// pair makes a word, 16 words; otherwise a lane loads 4 bytes 32 apart and
// four ballots make 4 words. kU steps are loaded before any is used.
template <bool VEC>
__device__ __forceinline__ void pack_rows(const uint8_t* __restrict__ mat, const uint32_t* valid,
                                          int vbase, int k, int r0, int r1, int step,
                                          uint32_t* dst, int pitch, int lane) {
  constexpr int kU = 4;
  constexpr int kWords = VEC ? 16 : 4;
  const int nw = words_of(k);
  auto next_row = [&](int i) {
    do i += step; while (i < r1 && !bit(valid, i - vbase));
    return i;
  };
  int i = next_row(r0 - step), w0 = i >> 5;
  while (i < r1) {
    uint4 v[kU];
    int ri[kU], wi[kU];
#pragma unroll
    for (int s = 0; s < kU; ++s) {
      ri[s] = i;
      wi[s] = w0;
      v[s] = make_uint4(0, 0, 0, 0);
      if (i < r1) {
        const uint8_t* row = mat + (size_t)i * k;
        if (VEC) {
          const int h = 2 * w0 + lane;   // half-word: 16 columns
          if (16 * h < k) v[s] = *reinterpret_cast<const uint4*>(row + 16 * h);
        } else {
          const int c = 32 * w0 + lane;
          if (c < k) v[s].x = row[c];
          if (c + 32 < k) v[s].y = row[c + 32];
          if (c + 64 < k) v[s].z = row[c + 64];
          if (c + 96 < k) v[s].w = row[c + 96];
        }
        w0 += kWords;
        if (w0 >= nw) {
          i = next_row(i);
          w0 = i >> 5;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kU; ++s) {
      if (ri[s] >= r1) break;   // uniform
      uint32_t* out = dst + (size_t)ri[s] * pitch;
      if (VEC) {
        const uint32_t bits = nonzero4(v[s].x) | nonzero4(v[s].y) << 4 |
                              nonzero4(v[s].z) << 8 | nonzero4(v[s].w) << 12;
        const uint32_t hi = __shfl_down_sync(kAll, bits, 1);
        const int w = wi[s] + (lane >> 1);
        if (!(lane & 1) && w < nw) out[w] = (bits | hi << 16) & above(ri[s], w);
      } else {
        const uint32_t q0 = __ballot_sync(kAll, v[s].x != 0), q1 = __ballot_sync(kAll, v[s].y != 0);
        const uint32_t q2 = __ballot_sync(kAll, v[s].z != 0), q3 = __ballot_sync(kAll, v[s].w != 0);
        const int w = wi[s] + lane;
        const uint32_t word = lane == 0 ? q0 : lane == 1 ? q1 : lane == 2 ? q2 : q3;
        if (lane < 4 && w < nw) out[w] = word & above(ri[s], w);
      }
    }
  }
}

// Valid bytes of one image -> bits in `words` (shared memory); warp `warp` of
// `warps` does words warp, warp + warps, ...
__device__ __forceinline__ void pack_valid(const uint8_t* __restrict__ v, int k, uint32_t* words,
                                           int warp, int warps, int lane) {
  for (int w = warp; w < words_of(k); w += warps) {
    const int c = 32 * w + lane;
    const uint32_t word = __ballot_sync(kAll, c < k && v[c] != 0);
    if (lane == 0) words[w] = word;
  }
}

// The sweep of one image by one warp. WPL: words a lane holds (ceil(nw / 32)).
// `block(w)` returns the 32 rows of word-block w (rows 32w .. 32w+31) in
// shared memory, row 32w + b at block(w) + b * pitch, words indexed as in the
// packed row; a row's words below its own are never read.
template <int WPL, class Block>
__device__ __forceinline__ void sweep(const uint32_t* valid, int k, int pitch, uint8_t* keep,
                                      int lane, Block block) {
  const int nw = words_of(k);
  uint32_t dead[WPL];
#pragma unroll
  for (int r = 0; r < WPL; ++r) {
    const int w = lane + 32 * r;
    dead[r] = w < nw ? ~valid[w] : kAll;   // bits past K are never kept
  }
#pragma unroll
  for (int r = 0; r < WPL; ++r) {
    for (int wl = 0; wl < 32; ++wl) {
      const int w = 32 * r + wl;
      if (w >= nw) break;   // uniform
      const uint32_t* blk = block(w);
      // the diagonal block: lane b holds row 32w+b's word w (bits j > i only)
      const uint32_t d = 32 * w + lane < k ? blk[lane * pitch + w] : 0u;
      // candidates in increasing order: the lowest live one whose row
      // suppresses anything here is kept, and its row applied; rows that
      // suppress nothing in this word need no step
      uint32_t dw = __shfl_sync(kAll, dead[r], wl);
      for (uint32_t todo = __ballot_sync(kAll, d != 0) & ~dw; todo; todo &= ~dw) {
        const int b = __ffs(todo) - 1;
        todo &= todo - 1;
        dw |= __shfl_sync(kAll, d, b);
      }
      if (lane == wl) dead[r] = dw;
      // the kept rows suppress in every later word: 32 independent
      // predicated loads a word a lane
      const uint32_t kept = ~dw;
#pragma unroll
      for (int r2 = 0; r2 < WPL; ++r2) {
        const int w2 = lane + 32 * r2;
        if (w2 > w && w2 < nw) {
          uint32_t sup = 0;
#pragma unroll
          for (int b = 0; b < 32; ++b)
            if ((kept >> b) & 1u) sup |= blk[b * pitch + w2];
          dead[r2] |= sup;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < WPL; ++r) {
    for (int src = 0; src < 32; ++src) {
      const int w = 32 * r + src;
      if (w >= nw) break;
      const uint32_t dw = __shfl_sync(kAll, dead[r], src);
      const int j = 32 * w + lane;
      if (j < k) keep[j] = ((dw >> lane) & 1u) ? 0 : 1;
    }
  }
}

// K <= kSmemMaxK: one block an image packs into shared memory, then warp 0 sweeps.
template <int WPL, bool VEC>
__global__ void __launch_bounds__(kBlockThreads, 1)
nms_sweep_smem_kernel(const uint8_t* __restrict__ mat, const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ keep, int k) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nw = words_of(k), pitch = nw | 1;   // odd: the diagonal reads hit 32 banks
  uint32_t* valid_s = smem;
  uint32_t* rows = smem + ((nw + 3) & ~3);
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  pack_valid(valid + b * k, k, valid_s, warp, warps, lane);
  __syncthreads();
  pack_rows<VEC>(mat + b * k * (size_t)k, valid_s, 0, k, warp, k, warps, rows, pitch, lane);
  __syncthreads();
  if (warp != 0) return;
  sweep<WPL>(valid_s, k, pitch, keep + b * k, lane,
             [&](int w) { return rows + (size_t)32 * w * pitch; });
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int WPL>
int launch_smem(const uint8_t* mat, const uint8_t* valid, uint8_t* keep, int batch, int k,
                bool vec, cudaStream_t stream) {
  const int nw = words_of(k);
  const size_t smem = 4 * (size_t)(((nw + 3) & ~3) + k * (nw | 1));
  auto kernel = vec ? nms_sweep_smem_kernel<WPL, true> : nms_sweep_smem_kernel<WPL, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kBlockThreads, smem, stream>>>(mat, valid, keep, k);
  return (int)cudaGetLastError();
}

}  // namespace

// K <= 1300 (kSmemMaxK), one launch on `stream`; returns the cudaError_t of
// the launch (0 = success).
extern "C" int nms_sweep_launch(const void* mat, const void* valid, void* keep, int batch, int k,
                                void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (k > kSmemMaxK) return (int)cudaErrorInvalidValue;
  const uint8_t* m = (const uint8_t*)mat;
  const uint8_t* v = (const uint8_t*)valid;
  uint8_t* out = (uint8_t*)keep;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = k % 16 == 0 && (uintptr_t)mat % 16 == 0;
  if (words_of(k) <= 32) return launch_smem<1>(m, v, out, batch, k, vec, s);
  return launch_smem<2>(m, v, out, batch, k, vec, s);
}
