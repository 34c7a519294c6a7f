// K2 — full greedy NMS at K = N as max_boxes rounds of argmax + IoU kill.
//
// Replaces the Pallas TPU kernel yolov3_tpu/ops/pallas/round_sweep.py
// (pallas_round_sweep / _kernel), whose oracle is
// yolov3_tpu/ops/nms.py::_round_sweep_direct. Contract, per image b of
// boxes (B, N, 4) xyxy f32 and scores (B, N) f32:
//   live = score > score_thr
//   round r: j = argmax(live scores), first index among ties;
//            if none is live: sel[r] = 0 (and every later round too);
//            else sel[r] = j, nv += 1, kill j and every live box with
//            IoU(box j, box) > iou_thr.
// Writes sel (B, max_boxes) int32 and nv (B,) int32.
//
// What bounds it on an H100: the max_boxes dependent rounds, each a
// block-wide reduction followed by a pass over the live boxes; the bytes
// (20 B per candidate, read once) are a few microseconds of HBM. Design:
//   * one thread block of 1024 threads per image;
//   * the live scores sit in shared memory (dead = -inf), N floats: 42 KB
//     at N = 10,647 (416²) and 91 KB at 22,743 (608²), under the 227 KB a
//     block may take once cudaFuncAttributeMaxDynamicSharedMemorySize is
//     raised; the argmax pass never leaves the SM;
//   * the boxes stay in global memory and L2 serves the rounds after the
//     first; the kill pass loads a box only while it is still live, so the
//     traffic shrinks as boxes die;
//   * argmax on (score desc, index asc): each thread scans its strided
//     indices in ascending order keeping the first maximum, then warp
//     shuffles and one warp over the 32 warp results break ties to the
//     lower index, which is TF's stable-sort order;
//   * the loop stops at the first round that finds nothing live, since
//     every later round would find nothing too.
// The IoU is computed with explicitly rounded intrinsics in the plain
// version's operation order (and the file is built with --fmad=false), so
// no multiply-add is contracted and a near-threshold IoU rounds exactly as
// the element-wise PyTorch ops of round_sweep_ref do on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 q) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, q.z), fmaxf(a.x, q.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, q.w), fmaxf(a.y, q.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float area_q = __fmul_rn(fmaxf(__fsub_rn(q.z, q.x), 0.0f),
                                 fmaxf(__fsub_rn(q.w, q.y), 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_q), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
round_sweep_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                   int* __restrict__ sel, int* __restrict__ nv, int n, int max_boxes,
                   float iou_thr, float score_thr) {
  extern __shared__ float live[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int pick;

  const size_t b = blockIdx.x;
  const float4* bx = boxes + b * (size_t)n;
  const float* sc = scores + b * (size_t)n;
  int* out = sel + b * (size_t)max_boxes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < n; j += kThreads) {
    const float s = sc[j];
    live[j] = s > score_thr ? s : -INFINITY;
  }
  for (int r = tid; r < max_boxes; r += kThreads) out[r] = 0;
  __syncthreads();

  int count = 0;
  for (int r = 0; r < max_boxes; ++r) {
    float bv = -INFINITY;
    int bi = n;
    for (int j = tid; j < n; j += kThreads) {
      const float s = live[j];
      if (s > bv) {
        bv = s;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
             __shfl_down_sync(0xffffffffu, bi, off));
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
      for (int off = 16; off > 0; off >>= 1) {
        better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
               __shfl_down_sync(0xffffffffu, bi, off));
      }
      if (lane == 0) pick = bv > -INFINITY ? bi : -1;
    }
    __syncthreads();
    const int j = pick;
    if (j < 0) break;  // uniform: nothing live, every later round is empty
    if (tid == 0) out[r] = j;
    ++count;

    const float4 a = bx[j];
    const float area_a = __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.0f),
                                   fmaxf(__fsub_rn(a.w, a.y), 0.0f));
    for (int q = tid; q < n; q += kThreads) {
      if (live[q] == -INFINITY) continue;
      if (q == j || iou(a, area_a, bx[q]) > iou_thr) live[q] = -INFINITY;
    }
    __syncthreads();
  }
  if (tid == 0) nv[b] = count;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int round_sweep_launch(const void* boxes, const void* scores, void* sel,
                                  void* nv, int batch, int n, int max_boxes,
                                  float iou_thr, float score_thr, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      round_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  round_sweep_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)scores, (int*)sel, (int*)nv, n, max_boxes,
      iou_thr, score_thr);
  return (int)cudaGetLastError();
}
