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
//     Up to kSmemMaxK the packed image (K x ceil(K/32) words, 213 KB at
//     K = 1300) lives in shared memory and the sweeping block packs it with
//     all its warps: one launch. Above, it goes to a scratch bit matrix in
//     device memory (2 MB an image at K = 4096) that a first launch packs
//     over the whole card (a block per 32 rows of an image), because one SM
//     per image would read its 8 MB of rows j > i alone.
//   * Sweep. One warp per image, with no block barrier. "Dead" (invalid or
//     suppressed) is a bit mask, lane l holding words l, l + 32, ... For each
//     word w of 32 candidates, all lanes resolve its candidates in order from
//     the 32 x 32 diagonal bit block (row 32w+b's word w, one word a lane,
//     handed round by shuffles; only live rows that suppress something in
//     the word take a step); then each lane ORs the kept rows into its own
//     later words. Rows come from shared memory: the resident image,
//     or at large K a ring of 32-row blocks copied from the scratch matrix by
//     cp.async, three blocks ahead of the sweep. Only __syncwarp and shuffles
//     order the steps.
//
// The TPU kernel's K % 128 and K <= 1024 limits were VMEM limits and are
// gone; ops/cuda/nms_kernel.py holds K <= 4096 (the matrix branch's bound).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemMaxK = 1300;    // largest K whose packed image stays in shared memory
constexpr int kBlockThreads = 1024;  // the one-launch kernel: all warps pack, one sweeps
constexpr int kPackThreads = 256;    // the pack launch: eight warps, 32 rows a block
constexpr int kRingBlocks = 4;       // 32-row blocks in the sweep's ring (large K)
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int words_of(int k) { return (k + 31) >> 5; }
// words of a scratch row: a whole number of 16-byte chunks
__host__ __device__ constexpr int scratch_pitch(int k) { return (words_of(k) + 3) & ~3; }
// words of a row in the sweep's ring: 16-byte aligned, off the bank of the row above
__host__ __device__ constexpr int ring_pitch(int k) { return scratch_pitch(k) + 4; }

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

// K > kSmemMaxK, first launch: block (x, b) packs rows [32x, 32x + 32) of image b.
template <bool VEC>
__global__ void __launch_bounds__(kPackThreads)
nms_pack_kernel(const uint8_t* __restrict__ mat, const uint8_t* __restrict__ valid,
                uint32_t* __restrict__ scratch, int k) {
  __shared__ uint32_t valid_s[1];
  const size_t b = blockIdx.y;
  const int r0 = 32 * blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    const int c = r0 + lane;
    const uint32_t word = __ballot_sync(kAll, c < k && valid[b * k + c] != 0);
    if (lane == 0) valid_s[0] = word;
  }
  __syncthreads();
  const int r1 = r0 + 32 < k ? r0 + 32 : k;
  const int pitch = scratch_pitch(k);
  pack_rows<VEC>(mat + b * k * (size_t)k, valid_s, r0, k, r0 + warp, r1, kPackThreads / 32,
                 scratch + b * k * (size_t)pitch, pitch, lane);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async_16(uint32_t* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// K > kSmemMaxK, second launch: one warp an image sweeps the scratch matrix
// through a ring of 32-row blocks in shared memory.
template <int WPL>
__global__ void __launch_bounds__(32)
nms_sweep_ring_kernel(const uint32_t* __restrict__ scratch, const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ keep, int k) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nw = words_of(k), gp = scratch_pitch(k), rp = ring_pitch(k);
  uint32_t* valid_s = smem;
  uint32_t* ring = smem + ((nw + 3) & ~3);
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t* img = scratch + b * k * (size_t)gp;
  pack_valid(valid + b * k, k, valid_s, 0, 1, lane);

  // block q: rows 32q + r, words from q's chunk on (words below q are never read)
  auto copy_block = [&](int q) {
    if (q < nw) {
      uint32_t* dst = ring + (q % kRingBlocks) * 32 * rp;
      const int c0 = q >> 2, chunks = gp / 4;
      for (int r = 0; r < 32; ++r) {
        const int i = 32 * q + r;
        for (int c = c0 + lane; c < chunks; c += 32) {
          const bool ok = i < k;
          cp_async_16(dst + r * rp + 4 * c, ok ? img + (size_t)i * gp + 4 * c : img, ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int q = 0; q < kRingBlocks - 1; ++q) copy_block(q);
  __syncwarp();   // valid_s
  sweep<WPL>(valid_s, k, rp, keep + b * k, lane, [&](int w) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRingBlocks - 2) : "memory");
    // block w has landed for every lane, and every lane is done with the
    // slot that the next copy refills (read in step w - 1)
    __syncwarp();
    copy_block(w + kRingBlocks - 1);
    return static_cast<const uint32_t*>(ring + (w % kRingBlocks) * 32 * rp);
  });
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

template <int WPL>
int launch_ring(const uint8_t* mat, const uint8_t* valid, uint8_t* keep, uint32_t* scratch,
                int batch, int k, bool vec, cudaStream_t stream) {
  dim3 grid(words_of(k), batch);
  if (vec) nms_pack_kernel<true><<<grid, kPackThreads, 0, stream>>>(mat, valid, scratch, k);
  else nms_pack_kernel<false><<<grid, kPackThreads, 0, stream>>>(mat, valid, scratch, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 4 * (size_t)(((words_of(k) + 3) & ~3) + kRingBlocks * 32 * ring_pitch(k));
  err = set_smem(nms_sweep_ring_kernel<WPL>, smem);
  if (err != cudaSuccess) return (int)err;
  nms_sweep_ring_kernel<WPL><<<batch, 32, smem, stream>>>(scratch, valid, keep, k);
  return (int)cudaGetLastError();
}

}  // namespace

// K <= 1300: one launch, `scratch` unused (may be null). K in (1300, 4096]:
// two launches, `scratch` a (batch, K, scratch_pitch(K)) int32 buffer. Launches
// on `stream`; returns the cudaError_t of the launches (0 = success).
extern "C" int nms_sweep_launch(const void* mat, const void* valid, void* keep, void* scratch,
                                int batch, int k, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (k > 4096) return (int)cudaErrorInvalidValue;
  const uint8_t* m = (const uint8_t*)mat;
  const uint8_t* v = (const uint8_t*)valid;
  uint8_t* out = (uint8_t*)keep;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = k % 16 == 0 && (uintptr_t)mat % 16 == 0;
  if (k <= kSmemMaxK) {
    if (words_of(k) <= 32) return launch_smem<1>(m, v, out, batch, k, vec, s);
    return launch_smem<2>(m, v, out, batch, k, vec, s);
  }
  uint32_t* sc = (uint32_t*)scratch;
  switch ((words_of(k) + 31) / 32) {
    case 2: return launch_ring<2>(m, v, out, sc, batch, k, vec, s);
    case 3: return launch_ring<3>(m, v, out, sc, batch, k, vec, s);
    default: return launch_ring<4>(m, v, out, sc, batch, k, vec, s);
  }
}
