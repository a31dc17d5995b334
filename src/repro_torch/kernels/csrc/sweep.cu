// Dual-mode MCMC sweep for Hopper (sm_90a), on a dense J or packed planes.
//
// Replaces the TPU kernel repro/kernels/sweep.py: mcmc_sweep (body _kernel)
// with coupling="dense", "bitplane" and "bitplane_hbm". It runs T
// asynchronous single-spin steps for each of R replicas: RSA (random-scan
// site, Metropolis-Glauber accept) or RWA (the two-level roulette over every
// site's flip probability, with the RSA fallback on a degenerate total, or
// the uniformized null transition), then e += accept*dE,
// u <- u - 2*accept*s_old*J[j,:], the spin flip and the copy of s into
// best_s when e improves.
//
// What bounds it on this card: the T steps of one replica form a serial
// chain, and each step reads one J row that it needs before the next step
// can select. At R=8 that is 8 blocks of a 132-SM card, so the pace is set
// by the latency of one step (a row read from L2 or HBM plus the
// block-wide barriers), not by the bytes: R*N*4 bytes a step is 64 KB at
// K2000, a few ns at 3.35 TB/s; a B=1 plane row is 16x smaller still.
//
// What the design does about it: one thread block per replica keeps the
// replica's u, s and best_s in shared memory for the whole chunk (the
// analogue of the Pallas kernel's VMEM-resident state), so a step touches
// device memory only for its uniforms, its temperature and the accepted
// row. A rejected step reads no row at all: its coefficient is 0, so u is
// unchanged. The RWA block sums are computed by all warps; the two prefix
// scans and <=-counts of the roulette run in one warp.
//
// Plane tiers: row j is decoded where it is used. A warp covers the 1024
// spins of 32 packed words: it reads those words with one coalesced load
// per plane and sign, a shuffle broadcasts each word to the warp, and lane
// L takes bit L for spin 32*word + L, so the u update stays conflict-free
// in shared memory. The decoded coupling
// sum_b 2^b (bit_pos - bit_neg) is a small integer and coef is 0 or +-2, so
// u - coef*row is the same exact operation as on the dense tier and the
// trajectories of the three tiers are bitwise equal. The TPU kernel's
// double buffer (replica r+1's row DMA overlapping replica r's decode
// inside one grid step) has no counterpart here: the replicas are separate
// blocks that run concurrently.
//
// rows_fetched on the coalesced tier (bitplane_hbm with coalesce): the JAX
// kernel fetches each step's unique rows once per block of br replicas and
// charges each to the lowest replica selecting it. Here the br replicas of
// a group form one thread-block cluster. Each block logs its sites in
// shared memory; every kLogSteps steps (and after the last) the cluster
// meets at a barrier, each block reads the lower-ranked blocks' logs
// through distributed shared memory and counts the steps whose site none
// of them chose, and a second barrier lets the logs be reused. A barrier
// per step would make the replicas walk in lockstep, so each step would
// last as long as the group's slowest (an accepted RSA flip against a
// rejected one); a barrier per window costs that only once per window.
//
// Arithmetic: build with -fmad=false, so no multiply-add is contracted
// except the explicit __fmaf_rn of the PWL table, which the JAX reference
// also rounds once (XLA's CPU compiler contracts it). Division is the
// IEEE-rounded __fdiv_rn. The roulette adds block and lane sums in another
// order than the reference's cumsum, so RWA picks agree except near ties.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "snowball_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLane = 128;
// Steps between the coalesced tier's cluster barriers (its site log).
constexpr int kLogSteps = 64;

// Where the couplings live (the Store of snowball_device.cuh): a dense
// (N, N) f32 J, (B, N, W) uint32 pos/neg planes, or the planes with the
// coalesced rows_fetched count.
enum StoreKind { kDense = 0, kPlanes = 1, kPlanesCoalesced = 2 };

__device__ __forceinline__ int site_from_uniform(float u, int n) {
  return min((int)__fmul_rn(u, (float)n), n - 1);
}

// Warp-level prefix machinery over x[0, m): lane k owns the contiguous chunk
// [k*c, min(m, (k+1)*c)), c = ceil(m/32), summed in order; chunk sums are
// combined by a shuffle scan. Returns this lane's exclusive prefix and
// broadcasts the total.
__device__ __forceinline__ float warp_exclusive_prefix(const float* x, int m,
                                                       float* total) {
  const int lane = threadIdx.x & 31;
  const int c = (m + 31) / 32;
  const int lo = min(m, lane * c), hi = min(m, lo + c);
  float local = 0.f;
  for (int k = lo; k < hi; ++k) local = __fadd_rn(local, x[k]);
  float incl = local;
  for (int off = 1; off < 32; off <<= 1) {
    float v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, v);
  }
  *total = __shfl_sync(kFull, incl, 31);
  float excl = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.f : excl;
}

// Number of cumulative sums <= thr (the reference's <=-count pick), and
// the cumulative sum just before index `at` (0 for at == 0).
__device__ __forceinline__ int warp_count_le(const float* x, int m,
                                             float excl, float thr) {
  const int lane = threadIdx.x & 31;
  const int c = (m + 31) / 32;
  const int lo = min(m, lane * c), hi = min(m, lo + c);
  float run = excl;
  int cnt = 0;
  for (int k = lo; k < hi; ++k) {
    run = __fadd_rn(run, x[k]);
    cnt += run <= thr;
  }
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(kFull, cnt, off);
  return cnt;
}

__device__ __forceinline__ float warp_prefix_before(const float* x, int m,
                                                    float excl, int at) {
  const int lane = threadIdx.x & 31;
  const int c = (m + 31) / 32;
  const int lo = min(m, lane * c), hi = min(m, lo + c);
  float run = excl;
  for (int k = lo; k < hi && k < at; ++k) run = __fadd_rn(run, x[k]);
  // The lane whose chunk holds index at-1 has the prefix; at == 0 gives 0.
  int owner = at == 0 ? 0 : (at - 1) / c;
  float v = __shfl_sync(kFull, run, owner);
  return at == 0 ? 0.f : v;
}

// Adds to *count the logged steps whose site no lower-ranked block of the
// cluster chose at the same step (the rows this block fetches). All blocks
// of the cluster call it at the same steps; the first barrier publishes
// every log, the second keeps each log until its peers have read it (and
// keeps a block from leaving while its shared memory is read).
__device__ void count_unique_rows(const int* log, int steps, int* count) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  int mine = 0;
  for (int k = threadIdx.x; k < steps; k += kThreads) {
    bool dup = false;
    for (int q = 0; q < rank && !dup; ++q)
      dup = cluster.map_shared_rank(log, q)[k] == log[k];
    mine += !dup;
  }
  for (int off = 16; off > 0; off >>= 1)
    mine += __shfl_xor_sync(kFull, mine, off);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(count, mine);
  cluster.sync();
}

template <bool RWA, bool UNIFORMIZED, bool PWL, int STORE>
__global__ void __launch_bounds__(kThreads) sweep_kernel(
    const Store st, const float* __restrict__ u0,
    const float* __restrict__ s0, const float* __restrict__ e0,
    const float* __restrict__ unif, const float* __restrict__ temps,
    const float* __restrict__ pwl_in, int segs, float* __restrict__ u_out, float* __restrict__ s_out,
    float* __restrict__ e_out, float* __restrict__ be_out,
    float* __restrict__ bs_out, int* __restrict__ nf_out,
    int* __restrict__ rf_out, int R, int N, int T, int lane) {
  extern __shared__ float smem[];
  float* u = smem;
  float* s = u + N;
  float* bs = s + N;
  float* pwl_mem = bs + N;                       // icpt[S], slope[S]
  float* blk = pwl_mem + (PWL ? 2 * segs : 0);   // G block sums
  const int G = N / lane;
  float* lanebuf = blk + (RWA ? G : 0);          // kMaxLane weights

  __shared__ int sh_j, sh_accept, sh_better;
  __shared__ float sh_coef, sh_new_sj;
  __shared__ int sh_log[kLogSteps];  // this window's sites, for the peers
  __shared__ int sh_rf;              // rows this block fetched
  constexpr bool kCoalesce = STORE == kPlanesCoalesced;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)r * N;
  for (int i = tid; i < N; i += kThreads) {
    u[i] = u0[row0 + i];
    float si = s0[row0 + i];
    s[i] = si;
    bs[i] = si;
  }
  Pwl pwl{pwl_mem, pwl_mem + segs, 0.f, 0.f, 0.f, segs};
  if (PWL) {
    for (int k = tid; k < 2 * segs; k += kThreads) pwl_mem[k] = pwl_in[k];
    pwl.z_lo = pwl_in[2 * segs];
    pwl.z_hi = pwl_in[2 * segs + 1];
    pwl.inv_step = pwl_in[2 * segs + 2];
  }
  float e = e0[r], be = e;  // meaningful in thread 0
  int nf = 0;
  if (tid == 0) sh_rf = 0;
  __syncthreads();

  const int warp = tid >> 5, wl = tid & 31;
  for (int t = 0; t < T; ++t) {
    const float temp = temps[(size_t)t * R + r];
    const float* un = unif + ((size_t)t * R + r) * 4;
    if (RWA) {
      // Block sums of the flip probabilities, one warp per block of sites.
      for (int g = warp; g < G; g += kWarps) {
        float acc = 0.f;
        for (int k = wl; k < lane; k += 32) {
          int i = g * lane + k;
          acc = __fadd_rn(acc, flip_probability<PWL>(delta_e(s, u, i), temp,
                                                     pwl));
        }
        for (int off = 16; off > 0; off >>= 1)
          acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
        if (wl == 0) blk[g] = acc;
      }
      __syncthreads();
      if (warp == 0) {
        float total;
        float excl = warp_exclusive_prefix(blk, G, &total);
        bool degenerate = (total <= 0.f) || !isfinite(total);
        float radius = __fmul_rn(un[2], degenerate ? 1.f : total);
        int g = min(warp_count_le(blk, G, excl, radius), G - 1);
        float base = warp_prefix_before(blk, G, excl, g);
        float residual = __fsub_rn(radius, base);
        for (int k = wl; k < lane; k += 32)
          lanebuf[k] = flip_probability<PWL>(delta_e(s, u, g * lane + k),
                                             temp, pwl);
        __syncwarp();
        float lane_total;
        float lexcl = warp_exclusive_prefix(lanebuf, lane, &lane_total);
        int l = min(warp_count_le(lanebuf, lane, lexcl, residual), lane - 1);
        if (wl == 0) {
          int j = g * lane + l;
          bool accept;
          if (UNIFORMIZED) {
            accept = !degenerate && __fmul_rn(un[3], (float)N) < total;
          } else if (degenerate) {
            j = site_from_uniform(un[0], N);
            accept = un[1] < flip_probability<PWL>(delta_e(s, u, j), temp,
                                                   pwl);
          } else {
            accept = true;
          }
          sh_j = j;
          sh_accept = accept;
        }
      }
      __syncthreads();
    }
    if (tid == 0) {
      int j;
      bool accept;
      if (RWA) {
        j = sh_j;
        accept = sh_accept;
      } else {
        j = site_from_uniform(un[0], N);
        accept = un[1] < flip_probability<PWL>(delta_e(s, u, j), temp, pwl);
      }
      float s_old = s[j];
      float de = delta_e(s, u, j);
      float acc = accept ? 1.f : 0.f;
      e = __fadd_rn(e, __fmul_rn(acc, de));
      nf += accept;
      bool better = e < be;
      if (better) be = e;
      sh_j = j;
      sh_accept = accept;
      sh_better = better;
      sh_coef = __fmul_rn(__fmul_rn(2.f, acc), s_old);
      sh_new_sj = __fmul_rn(s_old, __fsub_rn(1.f, __fmul_rn(2.f, acc)));
      if constexpr (kCoalesce) sh_log[t % kLogSteps] = j;
    }
    __syncthreads();
    // A rejected step leaves e, and so best, unchanged: nothing to apply.
    if (sh_accept) {
      const float coef = sh_coef;
      const int j = sh_j;
      const bool better = sh_better;
      if constexpr (STORE == kDense) {
        for (int i = tid; i < N; i += kThreads) {
          const float row = __ldg(st.J + (size_t)j * N + i);
          u[i] = __fsub_rn(u[i], __fmul_rn(coef, row));
          if (i == j) s[i] = sh_new_sj;
          if (better) bs[i] = s[i];
        }
      } else {
        // Warp w takes words w*32 .. w*32+31 (1024 spins), then the next
        // 8192 spins; lane L updates spin 32*word + L.
        for (int w0 = warp * 32; w0 * 32 < N; w0 += kWarps * 32) {
          float row[32];
          plane_couplings(st, j, N, w0, row);
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int i = (w0 + k) * 32 + wl;
            if (i < N) {
              u[i] = __fsub_rn(u[i], __fmul_rn(coef, row[k]));
              if (i == j) s[i] = sh_new_sj;
              if (better) bs[i] = s[i];
            }
          }
        }
      }
    }
    __syncthreads();
    if constexpr (kCoalesce) {
      if ((t + 1) % kLogSteps == 0 || t + 1 == T)
        count_unique_rows(sh_log, t % kLogSteps + 1, &sh_rf);
    }
  }

  for (int i = tid; i < N; i += kThreads) {
    u_out[row0 + i] = u[i];
    s_out[row0 + i] = s[i];
    bs_out[row0 + i] = bs[i];
  }
  if (tid == 0) {
    e_out[r] = e;
    be_out[r] = be;
    nf_out[r] = nf;
    // One row per replica per step, or the cluster's unique rows.
    rf_out[r] = kCoalesce ? sh_rf : T;
  }
}

template <bool RWA, bool UNIFORMIZED, bool PWL, int STORE>
int launch(const Store& st, const float* u0, const float* s0, const float* e0,
           const float* unif, const float* temps, const float* pwl_in,
           int segs, float* u_out, float* s_out, float* e_out, float* be_out,
           float* bs_out, int* nf_out, int* rf_out, int R, int N, int T,
           int lane, int cluster, size_t smem, cudaStream_t stream) {
  auto kernel = sweep_kernel<RWA, UNIFORMIZED, PWL, STORE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if constexpr (STORE == kPlanesCoalesced) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(R);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, st, u0, s0, e0, unif, temps,
                             pwl_in, segs, u_out, s_out, e_out, be_out,
                             bs_out, nf_out, rf_out, R, N, T, lane);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<R, kThreads, smem, stream>>>(
        st, u0, s0, e0, unif, temps, pwl_in, segs, u_out, s_out, e_out,
        be_out, bs_out, nf_out, rf_out, R, N, T, lane);
  }
  return (int)cudaGetLastError();
}

template <int STORE>
int dispatch(const Store& st, const float* u0, const float* s0,
             const float* e0, const float* unif, const float* temps,
             const float* pwl_in, int segs, float* u_out, float* s_out,
             float* e_out, float* be_out, float* bs_out, int* nf_out,
             int* rf_out, int R, int N, int T, int rwa, int uniformized,
             int lane, int cluster, size_t smem, cudaStream_t st_) {
  const bool pwl = pwl_in != nullptr;
#define SNOWBALL_LAUNCH(A, B, C)                                              \
  return launch<A, B, C, STORE>(st, u0, s0, e0, unif, temps, pwl_in, segs,    \
                                u_out, s_out, e_out, be_out, bs_out, nf_out,  \
                                rf_out, R, N, T, lane, cluster, smem, st_)
  if (!rwa) {
    if (pwl) SNOWBALL_LAUNCH(false, false, true);
    SNOWBALL_LAUNCH(false, false, false);
  }
  if (uniformized) {
    if (pwl) SNOWBALL_LAUNCH(true, true, true);
    SNOWBALL_LAUNCH(true, true, false);
  }
  if (pwl) SNOWBALL_LAUNCH(true, false, true);
  SNOWBALL_LAUNCH(true, false, false);
#undef SNOWBALL_LAUNCH
}

bool bad_args(int R, int N, int T, int lane, const float* pwl_in, int segs) {
  return R <= 0 || N <= 0 || T < 0 || lane <= 0 || lane > kMaxLane ||
         N % lane != 0 || (pwl_in != nullptr && segs <= 0);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes (the wrapper's size check).
size_t snowball_sweep_smem_bytes(int N, int lane, int segs, int rwa) {
  size_t floats = 3 * (size_t)N + 2 * (size_t)segs;
  if (rwa) floats += (size_t)(N / lane) + kMaxLane;
  return floats * sizeof(float);
}

// T steps for R replicas on a dense J. pwl_in packs the PWL table as
// icpt[segs], slope[segs], z_lo, z_hi, inv_step; pwl_in == nullptr selects
// the exact sigmoid. Returns the launch's CUDA error (0 on success).
int snowball_sweep_dense(const float* J, const float* u0, const float* s0,
                         const float* e0, const float* unif,
                         const float* temps, const float* pwl_in, int segs,
                         float* u_out, float* s_out,
                         float* e_out, float* be_out, float* bs_out,
                         int* nf_out, int* rf_out, int R, int N, int T,
                         int rwa, int uniformized, int lane, void* stream) {
  if (bad_args(R, N, T, lane, pwl_in, segs)) return (int)cudaErrorInvalidValue;
  const size_t smem =
      snowball_sweep_smem_bytes(N, lane, pwl_in ? segs : 0, rwa);
  const Store st{J, nullptr, nullptr, 0, 0};
  return dispatch<kDense>(st, u0, s0, e0, unif, temps, pwl_in, segs, u_out,
                          s_out, e_out, be_out, bs_out, nf_out, rf_out, R, N,
                          T, rwa, uniformized, lane, 0, smem,
                          (cudaStream_t)stream);
}

// The same on (B, N, W) uint32 pos/neg planes. cluster > 0 groups that many
// consecutive replicas (a divisor of R, at most 8) into one thread-block
// cluster and counts rows_fetched as the group's unique rows per step;
// cluster == 0 counts one row per replica per step.
int snowball_sweep_planes(const unsigned* pos, const unsigned* neg, int B,
                          int W, const float* u0, const float* s0,
                          const float* e0, const float* unif,
                          const float* temps, const float* pwl_in, int segs,
                          float* u_out, float* s_out, float* e_out,
                          float* be_out, float* bs_out, int* nf_out,
                          int* rf_out, int R, int N, int T, int rwa,
                          int uniformized, int lane, int cluster,
                          void* stream) {
  if (bad_args(R, N, T, lane, pwl_in, segs) || B <= 0 || B > 30 ||
      W * 32 < N || cluster < 0 || cluster > 8 ||
      (cluster > 0 && R % cluster != 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      snowball_sweep_smem_bytes(N, lane, pwl_in ? segs : 0, rwa);
  const Store st{nullptr, pos, neg, B, W};
  if (cluster > 0)
    return dispatch<kPlanesCoalesced>(
        st, u0, s0, e0, unif, temps, pwl_in, segs, u_out, s_out, e_out,
        be_out, bs_out, nf_out, rf_out, R, N, T, rwa, uniformized, lane,
        cluster, smem, (cudaStream_t)stream);
  return dispatch<kPlanes>(st, u0, s0, e0, unif, temps, pwl_in, segs, u_out,
                           s_out, e_out, be_out, bs_out, nf_out, rf_out, R, N,
                           T, rwa, uniformized, lane, 0, smem,
                           (cudaStream_t)stream);
}

}  // extern "C"
