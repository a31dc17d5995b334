// Measurement variants of kernel A's RSA step, built by
// scripts/rsa_variants.py from src/repro_torch/kernels/csrc/sweep_rsa.cu
// with -I on that directory. Never part of the solve.
//
// -DRSA_STAMPS     threads 0 (the decider's warp) and 32 (an applier's) of
//                  each block of replica 0 add the SM clocks of each phase
//                  of their steps into g_stamp (read back by
//                  rsa_read_stamps).
// -DRSA_BULK_FILL  the ring's slots are filled by cp.async.bulk (one a row
//                  part or plane run, thread 32) in place of the warps'
//                  copies (sweep_rsa.cu's hook).
// Every build also exports snowball_rsa_floor: the latency floor of a step,
// the kernel's one exchange (the 16-byte decision from warp 0 of the rank
// holding the step's site into every rank), its block barrier and the
// window's flow, with no probability, row or apply; and
// snowball_rsa_max_clusters, the card's occupancy at a width.
#include <cstdint>

#ifdef RSA_STAMPS
// Clocks accumulate in shared memory (a few cycles a stamp) and reach
// g_stamp once, after the last step: [rank][0][phase] thread 0 (warp 0,
// the decider), [rank][1][phase] thread 32 (warp 1, an applier); [..][6]
// the loop's nanoseconds on %globaltimer and [..][7] its SM clocks, so
// that their ratio is the SM clock rate the loop ran at.
__device__ unsigned long long g_stamp[16][2][8];
__shared__ long long s_acc[2][8];
__shared__ long long s_prev[2];
__shared__ long long s_start[2][2];
__device__ __forceinline__ long long global_ns() {
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}
#define RSA_STAMP(k)                                                   \
  do {                                                                 \
    const int who_ = threadIdx.x == 0 ? 0 : threadIdx.x == 32 ? 1 : -1; \
    if (blockIdx.x < (unsigned)p.width && who_ >= 0) {                 \
      const long long now = clock64();                                 \
      if ((k) == 0 && t == 0) {                                        \
        for (int i_ = 0; i_ < 8; ++i_) s_acc[who_][i_] = 0;            \
        s_start[who_][0] = global_ns();                                \
        s_start[who_][1] = now;                                        \
      }                                                                \
      if ((k) > 0) s_acc[who_][(k)] += now - s_prev[who_];             \
      s_prev[who_] = now;                                              \
      if ((k) == 5 && t == p.T - 1) {                                  \
        for (int i_ = 1; i_ < 6; ++i_)                                 \
          g_stamp[blockIdx.x][who_][i_] += s_acc[who_][i_];            \
        g_stamp[blockIdx.x][who_][6] += global_ns() - s_start[who_][0]; \
        g_stamp[blockIdx.x][who_][7] += now - s_start[who_][1];        \
      }                                                                \
    }                                                                  \
  } while (0)
#endif

#include "sweep_rsa.cu"

namespace {

__global__ void __launch_bounds__(kThreads, 1)
    floor_kernel(const RsaParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = p.width;
  const int q = (int)cluster.block_rank();
  const int r = blockIdx.x / c;
  const int S = p.slice, N = p.N, T = p.T, lo = q * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ Decision dec[kDecSlots];
  __shared__ __align__(8) uint64_t bar_dec[kDecSlots];
  __shared__ __align__(8) uint64_t bar_free[2];
  auto site = [&](int t) {
    return (int)(((long long)t * 7919 + (long long)r * 104729) % N) - lo;
  };
  auto send = [&](int t) {
    const int slot = t % kDecSlots;
    if (lane < c)
      st_async_v4(cluster_addr(&dec[slot], lane),
                  make_int4(site(t), 1, 0, 0),
                  cluster_addr(&bar_dec[slot], lane));
  };
  if (tid == 0) {
    for (int k = 0; k < kDecSlots; ++k) mbar_init(&bar_dec[k], 1);
    for (int k = 0; k < 2; ++k) mbar_init(&bar_free[k], c);
    for (int k = 0; k < kDecSlots && k < T; ++k)
      mbar_arrive_expect_tx(&bar_dec[k], (uint32_t)sizeof(Decision));
    fence_barrier_init();
  }
  if (c > 1) cluster.sync(); else __syncthreads();
  if (warp == 0 && T > 0 && site(0) >= 0 && site(0) < S) send(0);
  int sum = 0;
  for (int t = 0; t < T; ++t) {
    const int w = t % kWindow, slot = t % kDecSlots;
    mbar_wait_cluster(&bar_dec[slot], (t / kDecSlots) & 1);
    sum += dec[slot].j;
    __syncthreads();
    if (tid == 32 && t + kDecSlots < T)
      mbar_arrive_expect_tx(&bar_dec[slot], (uint32_t)sizeof(Decision));
    if (warp == 0) {
      if (w == kWindow - 1 && (t / kWindow + 2) * kWindow < T && lane < c)
        mbar_arrive_remote(cluster_addr(&bar_free[(t / kWindow) & 1], lane));
      if (t + 1 < T) {
        const int win = (t + 1) / kWindow;
        if ((t + 1) % kWindow == 0 && win >= 2)
          mbar_wait_cluster(&bar_free[win & 1], ((win - 2) >> 1) & 1);
        if (site(t + 1) >= 0 && site(t + 1) < S) send(t + 1);
      }
    }
  }
  if (tid == 0) p.nf_out[blockIdx.x] = sum;
  if (c > 1) cluster.sync();
}

}  // namespace

extern "C" {

// The floor of T steps for R replicas at `width` blocks a replica over N
// sites; nf_out (R * width) int32 receives a checksum.
int snowball_rsa_floor(int R, int N, int T, int width, int* nf_out,
                       void* stream) {
  RsaParams p{};
  p.nf_out = nf_out;
  p.R = R;
  p.N = N;
  p.T = T;
  p.width = width;
  p.slice = slice_sites(N, width);
  auto kernel = floor_kernel;
  if (width > 8) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * width);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = width;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `width` blocks of the keyed PWL kernel on a dense J (B ==
// 0) or on B planes that the card holds at once, with the launch's shared
// memory (cudaOccupancyMaxActiveClusters); a negative CUDA error.
int snowball_rsa_max_clusters(int N, int B, int segs, int width, int R) {
  const int S = slice_sites(N, width);
  const int K = ring_slots(S, B, segs);
  if (K == 0) return -(int)cudaErrorInvalidValue;
  const size_t smem = layout(S, B, segs, K).total;
  auto kernel = B == 0 ? rsa_kernel<true, kDense, true>
                       : rsa_kernel<true, kPlanes, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && width > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * width);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = width;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

int rsa_read_stamps(unsigned long long* out, int clear) {
#ifdef RSA_STAMPS
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
  if (err == cudaSuccess && clear) {
    static const unsigned long long zero[16][2][8] = {};
    err = cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
  }
  return (int)err;
#else
  (void)out;
  (void)clear;
  return -1;
#endif
}

}  // extern "C"
