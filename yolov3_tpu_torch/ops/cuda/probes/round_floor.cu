// The latency floor of K2's design (csrc/round_sweep.cu), measured apart
// from the kernel: ops/cuda/kernel_times.py builds this file into a library
// of its own (the shipped kernels do not include it) and chip_smoke.py and
// kernel_times.py k2 report its time beside K2's. It reuses round_sweep.cu's
// slot, warp fold and cluster launch, so it times the very exchange a round
// of the kernel makes.

#include "../csrc/round_sweep.cu"

namespace {

// The same rounds with no boxes: one warp's write of a slot, one cluster
// barrier, every warp's read of the cs slots over distributed shared memory
// and their fold. What `rounds` of them take is the latency floor of K2's
// design at a cluster shape.
__global__ void __launch_bounds__(1024) round_floor_kernel(int rounds, int* __restrict__ sink) {
  __shared__ Slot slots[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31;
  int acc = 0;
  for (int r = 0; r < rounds; ++r) {
    __syncthreads();
    Slot* mine = &slots[r & 1];
    if (tid == 0) {
      mine->score = (float)((rank * 7 + r) % 13);
      mine->idx = rank;
      mine->box = make_float4(0.0f, 0.0f, 1.0f, 1.0f);
    }
    cluster.sync();
    float v = -INFINITY;
    int i = kNone;
    if (lane < cs) {
      const Slot* theirs = cluster.map_shared_rank(mine, lane);
      v = theirs->score;
      i = theirs->idx;
    }
    warp_best(v, i);
    acc += i;
  }
  cluster.sync();
  if (tid == 0) sink[blockIdx.x] = acc;
}

}  // namespace

// The latency floor's probe at a plan's shape: `rounds` rounds on `batch`
// clusters of `cluster` blocks of `threads` threads; sink (batch * cluster,)
// int32 takes a checksum so the rounds cannot be optimised away.
extern "C" int round_floor_launch(void* sink, int batch, int cluster, int threads, int rounds,
                                  void* stream) {
  if (batch == 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || threads < 32 ||
      threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  int* s = (int*)sink;
  void* args[] = {&rounds, &s};
  return launch_cluster((const void*)round_floor_kernel, dim3(batch * cluster), threads, cluster,
                        0, (cudaStream_t)stream, args);
}
