// K2 — full greedy NMS at K = N as max_boxes rounds of argmax + IoU kill,
// one thread-block cluster an image.
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
// What bounds it on an H100: the max_boxes dependent rounds. The bytes (20 B
// a candidate, read once) are microseconds of HBM and the IoU operations a
// few more; what a round costs is its chain of reductions and barriers.
// One block an image (the first port) used 16 of the 132 SMs at B = 16 and
// took ~6.9 us a round: a block-wide argmax over all N scores and a kill pass
// that reloaded every live box from L2. Design:
//   * a cluster of `cs` blocks (ops/cuda/round_sweep.py::plan: the largest
//     power of two up to 16 that keeps B * cs within the card's SMs, and at
//     least what shared memory needs) shares an image; block `rank` holds the
//     boxes [rank * share, rank * share + share) in its own shared memory, as
//     float4 with their areas and live scores (dead = -inf): 24 bytes a box,
//     32 KB a block at N = 10,647 and cs = 8. Nothing is read from device
//     memory after the first pass;
//   * a thread owns the boxes tid, tid + T, ... of its block; each warp keeps
//     the best (score desc, index asc) of its boxes in shared memory and
//     rescans only in a round where it lost a box;
//   * a round: one warp folds the warp maxima into the block's winner, writes
//     it with its box into a slot of its shared memory (two slots, by round
//     parity, so one cluster barrier a round suffices), one cluster barrier
//     (barrier.cluster.arrive.release / wait.acquire), then every warp reads
//     the cs slots over distributed shared memory and folds them with the
//     same tie-break to the lower index: every block of the cluster knows the
//     winner and its box without another exchange, and kills from its own
//     shared memory;
//   * the loop stops at the first round that finds nothing live (uniform
//     over the cluster), and a last cluster barrier keeps every block's
//     slots alive until the others have read them.
// The IoU is computed with explicitly rounded intrinsics in the plain
// version's operation order (the file is built with --fmad=false), so no
// multiply-add is contracted and a near-threshold IoU rounds exactly as the
// element-wise PyTorch ops of round_sweep_ref do on the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;
constexpr int kNone = 0x7fffffff;   // index of "no box": loses every tie

struct __align__(16) Slot {
  float4 box;
  float score;
  int idx;
};

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// (v, i) folded over the warp with `better`; every lane gets the result.
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    better(v, i, __shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, i, off));
}

__device__ __forceinline__ float box_area(float4 q) {
  return __fmul_rn(fmaxf(__fsub_rn(q.z, q.x), 0.0f), fmaxf(__fsub_rn(q.w, q.y), 0.0f));
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 q, float area_q) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, q.z), fmaxf(a.x, q.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, q.w), fmaxf(a.y, q.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_q), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// The best live box of this warp's share (boxes lane + 32 w + k T of the
// block, ascending), written to the warp's cache.
__device__ __forceinline__ void rescan(const float* live, int cnt, int lo, float* wv, int* wi) {
  const int tid = threadIdx.x, lane = tid & 31;
  float v = -INFINITY;
  int i = kNone;
  for (int e = tid; e < cnt; e += blockDim.x) {
    const float s = live[e];
    if (s > v) {
      v = s;
      i = lo + e;
    }
  }
  warp_best(v, i);
  if (lane == 0) {
    wv[tid >> 5] = v;
    wi[tid >> 5] = i;
  }
}

__global__ void __launch_bounds__(1024)
round_sweep_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                   int* __restrict__ sel, int* __restrict__ nv, int n, int share,
                   int max_boxes, float iou_thr, float score_thr) {
  extern __shared__ float4 smem4[];
  __shared__ Slot slots[2];
  __shared__ float wv[32];
  __shared__ int wi[32];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int lo = rank * share, cnt = max(0, min(n - lo, share));
  float4* box = smem4;
  float* area = reinterpret_cast<float*>(box + share);
  float* live = area + share;
  const int tid = threadIdx.x, lane = tid & 31, nw = blockDim.x >> 5;
  const float4* bx = boxes + (size_t)b * n;
  const float* sc = scores + (size_t)b * n;
  int* out = sel + (size_t)b * max_boxes;

  for (int e = tid; e < cnt; e += blockDim.x) {
    const float4 q = bx[lo + e];
    const float s = sc[lo + e];
    box[e] = q;
    area[e] = box_area(q);
    live[e] = s > score_thr ? s : -INFINITY;
  }
  __syncthreads();
  rescan(live, cnt, lo, wv, wi);

  int count = 0;
  for (int r = 0; r < max_boxes; ++r) {
    __syncthreads();   // the warp maxima are written
    Slot* mine = &slots[r & 1];
    if (tid < 32) {
      float v = lane < nw ? wv[lane] : -INFINITY;
      int i = lane < nw ? wi[lane] : kNone;
      warp_best(v, i);
      if (lane == 0) {
        mine->score = v;
        mine->idx = i;
        mine->box = v > -INFINITY ? box[i - lo] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    cluster.sync();    // every block's winner is in its slot
    float v = -INFINITY;
    int i = kNone;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (lane < cs) {
      const Slot* theirs = cluster.map_shared_rank(mine, lane);
      v = theirs->score;
      i = theirs->idx;
      a = theirs->box;
    }
    const float my_v = v;
    const int my_i = i;
    warp_best(v, i);
    if (v == -INFINITY) break;   // uniform over the cluster: nothing is live
    const int src = __ffs(__ballot_sync(0xffffffffu, my_v == v && my_i == i)) - 1;
    a.x = __shfl_sync(0xffffffffu, a.x, src);
    a.y = __shfl_sync(0xffffffffu, a.y, src);
    a.z = __shfl_sync(0xffffffffu, a.z, src);
    a.w = __shfl_sync(0xffffffffu, a.w, src);
    if (rank == 0 && tid == 0) out[r] = i;
    ++count;

    const float area_a = box_area(a);
    bool lost = false;
    for (int e = tid; e < cnt; e += blockDim.x) {
      if (live[e] == -INFINITY) continue;
      if (lo + e == i || iou(a, area_a, box[e], area[e]) > iou_thr) {
        live[e] = -INFINITY;
        lost = true;
      }
    }
    if (__any_sync(0xffffffffu, lost)) rescan(live, cnt, lo, wv, wi);
  }
  cluster.sync();      // no block leaves while its slots may still be read
  if (rank == 0 && tid == 0) {
    for (int r = count; r < max_boxes; ++r) out[r] = 0;
    nv[b] = count;
  }
}

int launch_cluster(const void* kernel_fn, dim3 grid, int threads, int cs, size_t smem,
                   cudaStream_t stream, void** args) {
  cudaError_t err = cudaFuncSetAttribute(kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(kernel_fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, kernel_fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// cluster: blocks an image (a power of two up to 16); share: boxes a block,
// with cluster * share >= n; threads: a multiple of 32 up to 1024. The
// wrapper's plan picks all three. Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int round_sweep_launch(const void* boxes, const void* scores, void* sel, void* nv,
                                  int batch, int n, int max_boxes, int cluster, int share,
                                  int threads, float iou_thr, float score_thr, void* stream) {
  if (batch == 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || share < 1 ||
      (long long)cluster * share < n || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const float4* bx = (const float4*)boxes;
  const float* sc = (const float*)scores;
  int* s = (int*)sel;
  int* v = (int*)nv;
  void* args[] = {&bx, &sc, &s, &v, &n, &share, &max_boxes, &iou_thr, &score_thr};
  // a block's boxes, areas and live scores: 24 bytes a box (the wrapper's
  // MAX_N and plan count the same)
  return launch_cluster((const void*)round_sweep_kernel, dim3(batch * cluster), threads, cluster,
                        (size_t)share * 24, (cudaStream_t)stream, args);
}
