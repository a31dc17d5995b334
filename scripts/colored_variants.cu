// Measurement variants of kernel D, the colored sweep, built by
// scripts/colored_variants.py from src/repro_torch/kernels/csrc with -I on
// that directory. Never part of the solve.
//
// -DCOLORED_PR17    include colored_sweep.cu (the earlier kernel) in place
//                   of colored_sweep_hopper.cu.
// -DCOLORED_STAMPS  threads 0 and 32 of each block of replica 0 add the SM
//                   clocks of each phase of their steps into g_stamp (read
//                   back by colored_read_stamps).
// Without COLORED_PR17 the build also exports snowball_colored_floor, the
// latency floor of a step of colored_sweep_hopper.cu: its one exchange (every
// accept warp's partial into every rank's mailbox on the step's mbarrier)
// and its block barrier, with no accept pass, row or apply; and
// snowball_colored_max_clusters, the card's occupancy at a width.
#include <cstdint>

#ifdef COLORED_STAMPS
// Clocks accumulate in shared memory (a few cycles a stamp) and reach
// g_stamp once, after the last step: [rank][who][phase] for phases 1..6,
// [..][10] the loop's nanoseconds on
// %globaltimer and [..][11] its SM clocks (their ratio the SM clock rate
// the loop ran at).
__device__ unsigned long long g_stamp[16][2][12];
__shared__ long long s_acc[2][12];
__shared__ long long s_prev[2];
__shared__ long long s_start[2][2];
__device__ __forceinline__ long long global_ns() {
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}
__device__ __forceinline__ int stamp_who() {
  return threadIdx.x == 0 ? 0 : threadIdx.x == 32 ? 1 : -1;
}
#define COLORED_STAMP(k)                                                \
  do {                                                                  \
    const int who_ = stamp_who();                                       \
    if (blockIdx.x < (unsigned)p.C && who_ >= 0) {                      \
      const long long now = clock64();                                  \
      if ((k) == 0 && t == 0) {                                         \
        for (int i_ = 0; i_ < 12; ++i_) s_acc[who_][i_] = 0;            \
        s_start[who_][0] = global_ns();                                 \
        s_start[who_][1] = now;                                         \
      }                                                                 \
      if ((k) > 0) s_acc[who_][(k)] += now - s_prev[who_];              \
      s_prev[who_] = now;                                               \
      if ((k) == 6 && t == p.T - 1) {                                   \
        for (int i_ = 1; i_ < 7; ++i_)                                  \
          g_stamp[blockIdx.x][who_][i_] += s_acc[who_][i_];             \
        g_stamp[blockIdx.x][who_][10] += global_ns() - s_start[who_][0]; \
        g_stamp[blockIdx.x][who_][11] += now - s_start[who_][1];        \
      }                                                                 \
    }                                                                   \
  } while (0)
#endif

#ifdef COLORED_PR17
#include "colored_sweep.cu"
#else
#include "colored_sweep_hopper.cu"

namespace {

__global__ void __launch_bounds__(kThreads, 1)
    floor_kernel(const ColoredParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C;
  const int q = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ uint2 part[2][kMaxCluster][kWarps];
  __shared__ __align__(8) uint64_t bar_mail[2];
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) mbar_init(&bar_mail[k], 1);
    fence_barrier_init();
  }
  if (C > 1) cluster.sync(); else __syncthreads();
  unsigned sum = 0;
  for (int t = 0; t < p.T; ++t) {
    const int par = t & 1;
    if (tid == 0) mbar_arrive_expect_tx(&bar_mail[par], 8u * C * kWarps);
    if (lane < C)
      st_async_v2(cluster_addr(&part[par][q][warp], lane), (unsigned)t,
                  (unsigned)warp, cluster_addr(&bar_mail[par], lane));
    mbar_wait_cluster(&bar_mail[par], (t >> 1) & 1);
    sum += part[par][C - 1][kWarps - 1].x;
    __syncthreads();
  }
  if (tid == 0) p.nf_out[blockIdx.x] = (int)sum;
  if (C > 1) cluster.sync();
}

}  // namespace

extern "C" {

// The floor of T steps for R replicas at C blocks a replica; nf_out
// (R * C) int32 receives a checksum.
int snowball_colored_floor(int R, int T, int C, int* nf_out, void* stream) {
  ColoredParams p{};
  p.nf_out = nf_out;
  p.R = R;
  p.T = T;
  p.C = C;
  auto kernel = floor_kernel;
  if (C > 8) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * C);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of C blocks of the PWL kernel on a dense J (B == 0) or on B
// planes that the card holds at once, with the launch's shared memory
// (cudaOccupancyMaxActiveClusters); a negative CUDA error.
int snowball_colored_max_clusters(int N, int S, int segs, int C, int B,
                                  int R) {
  const int K = ring_slots(N, S, segs, C, B);
  if (K < kMinRing) return -(int)cudaErrorInvalidValue;
  const size_t smem = layout(N, S, segs, C, B, K).total;
  auto kernel = B == 0 ? colored_hopper_kernel<true, false>
                       : colored_hopper_kernel<true, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // extern "C"
#endif

extern "C" int colored_read_stamps(unsigned long long* out, int clear) {
#ifdef COLORED_STAMPS
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
  if (err == cudaSuccess && clear) {
    static const unsigned long long zero[16][2][12] = {};
    err = cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
  }
  return (int)err;
#else
  (void)out;
  (void)clear;
  return -1;
#endif
}
