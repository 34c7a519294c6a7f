// K1 — greedy NMS suppression sweep over a precomputed IoU>thr matrix.
//
// Replaces the Pallas TPU kernel yolov3_tpu/ops/pallas/nms_kernel.py
// (pallas_suppression_sweep / _suppress_kernel). Contract:
//   keep[i] = valid[i] && !sup[i];  sup[j] |= keep[i] && M[i, j]  for j > i
// for each image b of M (B, K, K) uint8 {0,1} and valid (B, K) uint8 {0,1};
// writes keep (B, K) uint8 {0,1}.
//
// What bounds it on an H100: not bytes (the matrix at B=16, K=4096 is
// 268 MB, about 80 us of HBM at 3.35 TB/s) but the K dependent steps of the
// recurrence: step i needs the final state of sup[i], which every earlier
// kept row may have written. So the design is latency-first:
//   * one thread block per image; the images run in parallel on the SMs;
//   * the state lives in shared memory as one byte per candidate, and is
//     seeded with !valid, so "dead" = invalid or suppressed and
//     keep = !dead at the end (dead[i] is final once step i starts);
//   * a step whose box is dead reads nothing and needs no barrier: the
//     branch is uniform across the block (all threads read dead[i] after
//     the last barrier), and no thread wrote since that barrier;
//   * a kept box reads its row once, j > i only, coalesced across the
//     block, then one __syncthreads publishes the new suppressions.
// So only the rows of kept boxes cross the memory bus, and the step count
// that pays a barrier plus a row-load latency is the number of kept boxes.
// The TPU kernel's K % 128 and K <= 1024 limits were VMEM limits and are
// gone: any K up to the shared-memory size works, with a ragged edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nms_sweep_kernel(const uint8_t* __restrict__ mat, const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep, int k) {
  extern __shared__ uint8_t dead[];
  const size_t b = blockIdx.x;
  const uint8_t* m = mat + b * (size_t)k * (size_t)k;
  const uint8_t* v = valid + b * (size_t)k;
  uint8_t* out = keep + b * (size_t)k;

  for (int j = threadIdx.x; j < k; j += blockDim.x) dead[j] = v[j] ? 0 : 1;
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    if (dead[i]) continue;  // uniform: no write since the last barrier
    const uint8_t* row = m + (size_t)i * (size_t)k;
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
      if (row[j]) dead[j] = 1;
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < k; j += blockDim.x) out[j] = dead[j] ? 0 : 1;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int nms_sweep_launch(const void* mat, const void* valid, void* keep,
                                int batch, int k, void* stream) {
  if (batch == 0 || k == 0) return 0;
  nms_sweep_kernel<<<batch, kThreads, (size_t)k, (cudaStream_t)stream>>>(
      (const uint8_t*)mat, (const uint8_t*)valid, (uint8_t*)keep, k);
  return (int)cudaGetLastError();
}
