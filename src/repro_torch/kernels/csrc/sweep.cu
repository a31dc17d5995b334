// Dual-mode MCMC sweep for Hopper (sm_90a), on a dense J or packed planes.
//
// Replaces the TPU kernel repro/kernels/sweep.py: mcmc_sweep (body _kernel)
// with coupling="dense", "bitplane" and "bitplane_hbm". It runs T
// asynchronous single-spin steps for each of R replicas: RSA (random-scan
// site, Metropolis-Glauber accept) or RWA (the two-level roulette over every
// site's flip probability, with the RSA fallback on a degenerate total, or
// the uniformized null transition), then e += accept*dE,
// u <- u - 2*accept*s_old*J[j,:], the spin flip and the copy of s into
// best_s when e improves. The solves' RWA runs on sweep_rwa.cu (a
// roulette tree that does not depend on the width) and their RSA on
// sweep_rsa.cu (any width, rows fetched ahead, decisions on mbarriers);
// either mode runs here only when the wrapper is asked to
// (sweep.mcmc_sweep_at_width(pr16=True)), to time both designs in one run.
//
// What bounds it on this card: the T steps of one replica form a serial
// chain, and each step reads one J row that it needs before the next step
// can select. So the pace is set by the latency of one step (a row read
// from L2 or HBM, the barriers, and for RWA the evaluation and scan of all
// N flip probabilities), not by the bytes: R*N*4 bytes a step is 64 KB at
// K2000, a few ns at 3.35 TB/s; a B=1 plane row is 16x smaller still.
//
// What the design does about it:
//
// * One thread-block cluster per replica. Its c blocks (c <= 8, chosen by
//   the wrapper from N, the mode and the store) split N into slices of N/c
//   spins, each a whole number of lane blocks; rank q keeps u, s and best_s
//   of its slice in shared memory for the whole chunk (the analogue of the
//   Pallas kernel's VMEM-resident state). At R=8 and c=8 a solve runs on 64
//   SMs instead of 8, and N reaches c times what one block holds.
// * The step's uniforms and temperature come from shared memory: every 64
//   steps the 256 threads of a block stage the next window's 64 x 4
//   uniforms and 64 temperatures. The DRAW variant computes the uniforms
//   in place with threefry2x32 from the chunk key (stream(base, SWEEP,
//   chunk), derived in the kernel from the two base words): element
//   (t, r, k) is uniform01's count (t*R + r)*4 + k, the same words as
//   rng.uniform01(chunk_key, (T, R, 4)). The read variant loads them from
//   a (T, R, 4) tensor (the kernel-level parity tests feed it).
// * RWA, each step: every rank sums its slice's lane blocks and posts its
//   total (all warps, then warp 0); cluster barrier 1; every rank reads the
//   c totals through distributed shared memory, adds them in rank order
//   (so every rank holds the same W, radius and owner bitwise), and the
//   owner rank alone runs the lane-block pick and the lane pick on its own
//   slice, as the single-block kernel's warp 0 did; it posts the decision
//   (j, accept, dE, s_old) into every rank's mailbox; cluster barrier 2;
//   every rank applies it to its slice. The degenerate fallback is decided
//   by the rank holding site(u0), the uniformized null transition by the
//   owner.
// * RSA, each step: the rank holding site(u0) decides the accept from its
//   own u and s and posts the decision; one cluster barrier; every rank
//   applies it.
// * A rejected step reads no row at all: its coefficient is 0, so u is
//   unchanged.
//
// Barriers, and why they are enough. No rank ever reads another rank's u,
// s or best_s: only the posted totals and the mailboxes cross blocks. A
// step's mailbox is mail[t & 1]. A rank reads mail[t & 1] after the step's
// last cluster barrier and before it arrives at the next one; a decider
// writes mail[(t+1) & 1] only after that next barrier (RWA) or before it
// (RSA), and writes mail[t & 1] again only at step t+2, after a barrier
// that every rank reaches only once it has read step t's. A rank's posted
// total is written before barrier 1 and read by its peers between
// barriers 1 and 2; it is written again only after barrier 2. So RSA takes
// one cluster barrier a step and RWA two; each step ends with a block
// barrier, since the next decision reads u and s that other threads of
// the block just updated. With c = 1 the cluster barriers are block
// barriers.
//
// Plane tiers: row j is decoded where it is used. A warp covers the 1024
// spins of 32 packed words: it reads those words with one coalesced load
// per plane and sign, a shuffle broadcasts each word to the warp, and lane
// L takes bit L for spin 32*word + L, so the u update stays conflict-free
// in shared memory; a rank decodes the words of its own slice. The decoded
// coupling sum_b 2^b (bit_pos - bit_neg) is a small integer and coef is 0
// or +-2, so u - coef*row is the same exact operation as on the dense tier
// and the trajectories of the three tiers are bitwise equal.
//
// rows_fetched on the coalesced tier (bitplane_hbm with coalesce): the JAX
// kernel fetches each step's unique rows once per group of br replicas and
// charges each to the lowest replica selecting it. Here rank 0 of each
// replica logs the chunk's sites in a (T, R) int32 scratch tensor; when a
// replica is done it fences its log and bumps its group's counter, and the
// cluster that arrives last counts the group's unique rows per step. No
// cluster waits on another.
//
// Arithmetic: build with -fmad=false, so no multiply-add is contracted
// except the explicit __fmaf_rn of the PWL table, which the JAX reference
// also rounds once (XLA's CPU compiler contracts it). Division is the
// IEEE-rounded __fdiv_rn. The roulette adds block, lane and rank sums in
// another order than the reference's cumsum, so RWA picks agree except
// near ties.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "snowball_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLane = 128;
constexpr int kMaxWidth = 8;
// Steps whose uniforms (kSlots each) and temperatures a block stages at a
// time: one uniform per thread.
constexpr int kWindow = 64;
constexpr int kSlots = 4;
static_assert(kWindow * kSlots == kThreads, "one staged uniform a thread");

// Where the couplings live (the Store of snowball_device.cuh).
enum StoreKind { kDense = 0, kPlanes = 1 };

// One step's outcome, posted by the deciding rank to every rank.
struct __align__(16) Decision {
  int j;         // the selected site (global index)
  int accept;
  float de;      // its dE
  float s_old;   // its spin before the step
};

struct SweepParams {
  Store st;
  const float* u0;
  const float* s0;
  const float* e0;
  const float* unif;   // (T, R, 4), the read variant; nullptr: DRAW
  unsigned key0, key1; // DRAW: the two words of the solve's base key
  int chunk;           // DRAW: the chunk index of stream(base, SWEEP, chunk)
  int fold;            // DRAW: a device fold before the chunk, or -1
  const float* temps;  // (T, R)
  const float* pwl;    // icpt[segs], slope[segs], z_lo, z_hi, inv_step
  int segs;
  float* u_out;
  float* s_out;
  float* e_out;
  float* be_out;
  float* bs_out;
  int* nf_out;
  int* rf_out;
  int* site_log;       // (T, R) coalesced tier's site log; nullptr: T rows
  int* group_done;     // (R / group) arrival counters, zeroed
  int group;           // replicas per coalescing group
  int R, N, T, lane, width;
};

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

// A barrier of the replica's blocks: the cluster's, or the block's alone.
__device__ __forceinline__ void replica_sync(cg::cluster_group& cluster,
                                             int width) {
  if (width > 1)
    cluster.sync();
  else
    __syncthreads();
}

// Lane k < width of the calling warp writes d into rank k's mailbox.
__device__ __forceinline__ void post(cg::cluster_group& cluster,
                                     Decision* mail, const Decision& d,
                                     int width) {
  const int k = threadIdx.x & 31;
  if (k < width) *(width > 1 ? cluster.map_shared_rank(mail, k) : mail) = d;
}

// Stages the uniforms and temperatures of steps [t0, t0 + kWindow):
// thread tid takes slot tid % 4 of step t0 + tid / 4.
template <bool DRAW>
__device__ __forceinline__ void stage_window(const SweepParams& p, int r,
                                             int t0, uint2 key, float* wunif,
                                             float* wtemp) {
  const int tid = threadIdx.x;
  const int t = t0 + tid / kSlots;
  if (t < p.T) {
    const size_t at = ((size_t)t * p.R + r) * kSlots + tid % kSlots;
    wunif[tid] = DRAW ? uniform_at(key, (unsigned)at) : p.unif[at];
  }
  if (tid < kWindow && t0 + tid < p.T)
    wtemp[tid] = p.temps[(size_t)(t0 + tid) * p.R + r];
}

template <bool RWA, bool UNIFORMIZED, bool PWL, int STORE, bool DRAW>
__global__ void __launch_bounds__(kThreads) sweep_kernel(const SweepParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = p.width;
  const int q = (int)cluster.block_rank();   // rank in the replica's cluster
  const int r = blockIdx.x / c;
  const int nc = p.N / c;                     // spins of this rank's slice
  const int lo = q * nc;
  const int lane = p.lane;
  const int gq = nc / lane;                   // lane blocks of the slice

  extern __shared__ float smem[];
  float* u = smem;
  float* s = u + nc;
  float* bs = s + nc;
  float* pwl_mem = bs + nc;                      // icpt[S], slope[S]
  float* wunif = pwl_mem + (PWL ? 2 * p.segs : 0);  // kWindow * kSlots
  float* wtemp = wunif + kWindow * kSlots;       // kWindow
  float* blk = wtemp + kWindow;                  // gq block sums (RWA)
  float* lanebuf = blk + (RWA ? gq : 0);         // kMaxLane weights (RWA)
  __shared__ Decision mail[2];
  __shared__ float part;                         // this slice's total (RWA)
  __shared__ int sh_last;

  const int tid = threadIdx.x;
  const size_t row0 = (size_t)r * p.N + lo;
  for (int i = tid; i < nc; i += kThreads) {
    u[i] = p.u0[row0 + i];
    float si = p.s0[row0 + i];
    s[i] = si;
    bs[i] = si;
  }
  Pwl pwl{pwl_mem, pwl_mem + p.segs, 0.f, 0.f, 0.f, p.segs};
  if (PWL) {
    for (int k = tid; k < 2 * p.segs; k += kThreads) pwl_mem[k] = p.pwl[k];
    pwl.z_lo = p.pwl[2 * p.segs];
    pwl.z_hi = p.pwl[2 * p.segs + 1];
    pwl.inv_step = p.pwl[2 * p.segs + 2];
  }
  const uint2 key = DRAW ? sweep_chunk_key(p.key0, p.key1, p.chunk, p.fold)
                         : make_uint2(0u, 0u);
  float e = p.e0[r], be = e;  // every thread of every rank keeps the same
  int nf = 0;
  // Every block of the cluster has started and loaded its slice.
  replica_sync(cluster, c);

  const int warp = tid >> 5, wl = tid & 31;
  const bool log_sites = p.site_log != nullptr && q == 0 && tid == 0;
  for (int t = 0; t < p.T; ++t) {
    const int w = t % kWindow;
    if (w == 0) {
      // The previous window was last read before the barrier that ended
      // the previous step.
      stage_window<DRAW>(p, r, t, key, wunif, wtemp);
      __syncthreads();
    }
    const float temp = wtemp[w];
    const float* un = wunif + w * kSlots;
    Decision* box = mail + (t & 1);
    if (RWA) {
      // The slice's lane-block sums, one warp per block of sites.
      for (int g = warp; g < gq; g += kWarps) {
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
      float excl = 0.f;
      if (warp == 0) {
        float mine;
        excl = warp_exclusive_prefix(blk, gq, &mine);
        if (wl == 0) part = mine;
      }
      replica_sync(cluster, c);  // barrier 1: every slice's total is posted
      if (warp == 0) {
        // Every rank: the c totals, added in rank order, the radius and
        // the owner rank (the count of rank prefixes <= radius).
        float pk = 0.f;
        if (wl < c) pk = c > 1 ? *cluster.map_shared_rank(&part, wl) : part;
        float total = 0.f;
        int owner = 0;
        const float radius_unit = un[2];
        for (int k = 0; k < c; ++k)
          total = __fadd_rn(total, __shfl_sync(kFull, pk, k));
        const bool degenerate = (total <= 0.f) || !isfinite(total);
        const float radius = __fmul_rn(radius_unit, degenerate ? 1.f : total);
        float run = 0.f;
        for (int k = 0; k < c; ++k) {
          run = __fadd_rn(run, __shfl_sync(kFull, pk, k));
          owner += run <= radius;
        }
        owner = min(owner, c - 1);
        float base_rank = 0.f;
        for (int k = 0; k < owner; ++k)
          base_rank = __fadd_rn(base_rank, __shfl_sync(kFull, pk, k));
        const int j_fb = site_from_uniform(un[0], p.N);
        const bool fallback = !UNIFORMIZED && degenerate;
        const int decider = fallback ? j_fb / nc : owner;
        if (q == decider) {
          Decision d;
          if (fallback) {
            const int jl = j_fb - lo;
            d.j = j_fb;
            d.de = delta_e(s, u, jl);
            d.accept = un[1] < flip_probability<PWL>(d.de, temp, pwl);
            d.s_old = s[jl];
          } else {
            const float residual_rank = __fsub_rn(radius, base_rank);
            int g = min(warp_count_le(blk, gq, excl, residual_rank), gq - 1);
            float base = warp_prefix_before(blk, gq, excl, g);
            float residual = __fsub_rn(residual_rank, base);
            for (int k = wl; k < lane; k += 32)
              lanebuf[k] = flip_probability<PWL>(delta_e(s, u, g * lane + k),
                                                 temp, pwl);
            __syncwarp();
            float lane_total;
            float lexcl = warp_exclusive_prefix(lanebuf, lane, &lane_total);
            int l = min(warp_count_le(lanebuf, lane, lexcl, residual),
                        lane - 1);
            const int jl = g * lane + l;
            d.j = lo + jl;
            d.de = delta_e(s, u, jl);
            d.s_old = s[jl];
            d.accept = UNIFORMIZED
                           ? (!degenerate &&
                              __fmul_rn(un[3], (float)p.N) < total)
                           : true;
          }
          post(cluster, box, d, c);
        }
      }
    } else if (warp == 0) {
      const int j = site_from_uniform(un[0], p.N);
      if (j >= lo && j < lo + nc) {  // this rank holds site j: it decides
        Decision d;
        d.j = j;
        d.de = delta_e(s, u, j - lo);
        d.accept = un[1] < flip_probability<PWL>(d.de, temp, pwl);
        d.s_old = s[j - lo];
        post(cluster, box, d, c);
      }
    }
    replica_sync(cluster, c);  // the step's decision is in every mailbox
    const Decision d = *box;
    if (log_sites) p.site_log[(size_t)t * p.R + r] = d.j;
    const float acc = d.accept ? 1.f : 0.f;
    e = __fadd_rn(e, __fmul_rn(acc, d.de));
    nf += d.accept;
    const bool better = e < be;
    if (better) be = e;
    // A rejected step leaves e, and so best, unchanged: nothing to apply.
    if (d.accept) {
      const float coef = __fmul_rn(__fmul_rn(2.f, acc), d.s_old);
      const float new_sj =
          __fmul_rn(d.s_old, __fsub_rn(1.f, __fmul_rn(2.f, acc)));
      const int jl = d.j - lo;  // outside [0, nc) on the other ranks
      if constexpr (STORE == kDense) {
        const float* jrow = p.st.J + (size_t)d.j * p.N + lo;
        for (int i = tid; i < nc; i += kThreads) {
          const float row = __ldg(jrow + i);
          u[i] = __fsub_rn(u[i], __fmul_rn(coef, row));
          if (i == jl) s[i] = new_sj;
          if (better) bs[i] = s[i];
        }
      } else {
        // Warp w takes words w*32 .. w*32+31 of the slice (1024 spins),
        // then the next 8192 spins; lane L updates spin 32*word + L.
        const int wend = (lo + nc + 31) / 32;
        for (int w0 = lo / 32 + warp * 32; w0 < wend; w0 += kWarps * 32) {
          float row[32];
          plane_couplings(p.st, d.j, p.N, w0, row);
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int i = (w0 + k) * 32 + wl - lo;
            if (i >= 0 && i < nc) {
              u[i] = __fsub_rn(u[i], __fmul_rn(coef, row[k]));
              if (i == jl) s[i] = new_sj;
              if (better) bs[i] = s[i];
            }
          }
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nc; i += kThreads) {
    p.u_out[row0 + i] = u[i];
    p.s_out[row0 + i] = s[i];
    p.bs_out[row0 + i] = bs[i];
  }
  if (q == 0 && tid == 0) {
    p.e_out[r] = e;
    p.be_out[r] = be;
    p.nf_out[r] = nf;
    if (p.site_log == nullptr) p.rf_out[r] = p.T;  // one row a step
  }
  if (p.site_log != nullptr && q == 0) {
    const int r0 = r - r % p.group;
    if (tid == 0) {
      __threadfence();  // this replica's sites before its arrival
      sh_last = atomicAdd(p.group_done + r / p.group, 1) == p.group - 1;
    }
    __syncthreads();
    if (sh_last) {
      __threadfence();
      count_group_rows(p.site_log, p.rf_out, p.R, p.T, p.group, r0, kWarps);
    }
  }
  // No rank leaves while a peer could still address its shared memory.
  if (c > 1) cluster.sync();
}

template <bool RWA, bool UNIFORMIZED, bool PWL, int STORE, bool DRAW>
int launch(const SweepParams& p, size_t smem, cudaStream_t stream) {
  auto kernel = sweep_kernel<RWA, UNIFORMIZED, PWL, STORE, DRAW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.R * p.width);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.width;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int STORE, bool DRAW>
int dispatch(const SweepParams& p, int rwa, int uniformized, size_t smem,
             cudaStream_t stream) {
  const bool pwl = p.pwl != nullptr;
#define SNOWBALL_LAUNCH(A, B, C) \
  return launch<A, B, C, STORE, DRAW>(p, smem, stream)
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

__global__ void uniforms_kernel(unsigned key0, unsigned key1, int chunk,
                                int fold, int count, float* out) {
  const uint2 key = sweep_chunk_key(key0, key1, chunk, fold);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x)
    out[i] = uniform_at(key, (unsigned)i);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of a width-`width` cluster, in bytes
// (the wrapper's size check): u, s and best_s of the slice, the PWL
// table, the staged window, and for RWA the slice's block sums and one
// lane buffer.
size_t snowball_sweep_smem_bytes(int N, int lane, int segs, int rwa,
                                 int width) {
  const size_t nc = (size_t)(N / width);
  size_t floats = 3 * nc + 2 * (size_t)segs + kWindow * (kSlots + 1);
  if (rwa) floats += nc / lane + kMaxLane;
  return floats * sizeof(float);
}

// T steps for R replicas. The couplings are a dense (N, N) f32 J (pos ==
// neg == nullptr) or (B, N, W) uint32 pos/neg planes (J == nullptr).
// unif != nullptr reads the (T, R, 4) uniforms; unif == nullptr draws them
// from stream(base, SWEEP, chunk), base = (key0, key1), or from
// stream(base, SWEEP, fold, chunk) where fold >= 0. pwl_in packs the
// PWL table as icpt[segs], slope[segs], z_lo, z_hi, inv_step; pwl_in ==
// nullptr selects the exact sigmoid. width blocks (a cluster, 1..8, with
// N/width a multiple of lane) run each replica. site_log != nullptr counts
// rows_fetched as the unique rows per step of each group of `group`
// consecutive replicas (site_log (T, R) int32 scratch, group_done (R/group)
// int32 zeros); nullptr counts one row per replica per step. Returns the
// launch's CUDA error (0 on success).
int snowball_sweep(const float* J, const unsigned* pos, const unsigned* neg,
                   int B, int W, const float* u0, const float* s0,
                   const float* e0, const float* unif, unsigned key0,
                   unsigned key1, int chunk, int fold, const float* temps,
                   const float* pwl_in, int segs, float* u_out, float* s_out,
                   float* e_out, float* be_out, float* bs_out, int* nf_out,
                   int* rf_out, int* site_log, int* group_done, int group,
                   int R, int N, int T, int rwa, int uniformized, int lane,
                   int width, void* stream) {
  const bool planes = J == nullptr;
  if (R <= 0 || N <= 0 || T < 0 || lane <= 0 || lane > kMaxLane ||
      width < 1 || width > kMaxWidth || N % width != 0 ||
      (N / width) % lane != 0 || (pwl_in != nullptr && segs <= 0) ||
      (planes && (pos == nullptr || neg == nullptr || B <= 0 || B > 30 ||
                  W * 32 < N)) ||
      (site_log != nullptr &&
       (group_done == nullptr || group <= 0 || R % group != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      snowball_sweep_smem_bytes(N, lane, pwl_in ? segs : 0, rwa, width);
  SweepParams p{Store{J, pos, neg, B, W}, u0, s0, e0, unif, key0, key1,
                chunk, fold, temps, pwl_in, pwl_in ? segs : 0, u_out, s_out,
                e_out, be_out, bs_out, nf_out, rf_out, site_log, group_done,
                group, R, N, T, lane, width};
  const int uni = uniformized && rwa;
  cudaStream_t st = (cudaStream_t)stream;
  const bool draw = unif == nullptr;
  if (planes)
    return draw ? dispatch<kPlanes, true>(p, rwa, uni, smem, st)
                : dispatch<kPlanes, false>(p, rwa, uni, smem, st);
  return draw ? dispatch<kDense, true>(p, rwa, uni, smem, st)
              : dispatch<kDense, false>(p, rwa, uni, smem, st);
}

// Writes the (T, R, 4) uniforms of stream(base, SWEEP, chunk) (with a
// device fold >= 0, stream(base, SWEEP, fold, chunk)) that the DRAW sweep
// draws, with the same device function, into out.
int snowball_sweep_uniforms(unsigned key0, unsigned key1, int chunk,
                            int fold, int T, int R, float* out,
                            void* stream) {
  if (T < 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const int count = T * R * kSlots;
  if (count == 0) return 0;
  const int blocks = min((count + kThreads - 1) / kThreads, 1024);
  uniforms_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      key0, key1, chunk, fold, count, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
