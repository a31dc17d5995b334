// Graph-colored block-Gibbs sweep for Hopper (sm_90a), on a dense J or
// packed planes.
//
// Replaces the TPU kernel repro/kernels/sweep.py: colored_sweep (body
// _colored_kernel) with coupling="dense", "bitplane" and "bitplane_hbm".
// Spins are in color-sorted order. Each of the T steps schedules one color
// class, given as a (T, 3) int32 row (w, offset, size): the class occupies
// [offset, offset + size) inside the static window [w, w + S). Every class
// member takes an independent heat-bath flip off the live local fields
// (accept iff uniforms[t, r, k] < p(dE), p the PWL or exact sigmoid), e and
// num_flips add the accepted dE and the accept count, the accepted spins
// flip, and each accepted slot k, in ascending k, applies
// u <- u - 2*s_old_k*J[w+k, :]. Same-color spins share no coupling, so the
// dE taken at the start of the step stays valid at every member: exact
// block Gibbs. Then best_s takes s when e improves. The kernel takes no
// selection mode: colored trajectories do not depend on rsa/rwa.
//
// What bounds it on this card: the row updates. A step at the N=16384
// anchor accepts hundreds to thousands of slots per replica, and each
// accepted slot is an N-wide FMA (plus, on the plane tiers, a decode at a
// few integer operations per plane and spin), so one block does millions of
// operations a step and the SM's issue rate sets the pace; the rows
// themselves (64 KB dense, 4 KB a B=1 plane row) stream from L2 or HBM.
//
// What the design does about it: one thread block per replica keeps u, s
// and best_s in shared memory for the chunk, as sweep.cu does. A step:
//  1. accept pass: one window slot per thread (S/256 passes); a warp ballot
//     packs the accepts into a bit mask in shared memory (S/32 words);
//  2. a block scan over the mask words compacts the accepted slots, in
//     ascending k, into a 2-byte list (S * 2 bytes: 6 KB at S=3072);
//  3. apply: each warp takes 1024 spins at a time (32 packed words), holds
//     their u in registers and runs the whole accepted list over them, so
//     every u element sees its row updates in ascending k, as in the plain
//     version. Plane rows are decoded by the warp decode of sweep.cu
//     (decode_plane_words); the first plane's words of the next few rows
//     are loaded ahead, so the loads of several rows are in flight at once.
// A replica that did not accept slot k skips it: the reference's gated
// u - 0*row changes nothing but the sign of a zero. Decoding each row once
// for all replicas, and spreading N over a cluster, is later work.
//
// rows_fetched: the reference counts, per group of br replicas (one
// thread-block cluster here) and per step, one row for each slot that any
// replica of the group accepted, charged to the lowest-index replica that
// accepted it. Each block writes its per-step accept masks to a global
// scratch (T, R, S/32); after its last step it meets its cluster at one
// barrier and counts, for every step and word, popc(mine & ~OR(lower-ranked
// peers' words)). The replicas never walk in lockstep during the steps.
//
// Arithmetic: build with -fmad=false, as sweep.cu; the flip probability,
// dE and the row decode are the shared device functions of
// snowball_device.cuh. The sums of accepted dE are added in another order
// than the reference's jnp.sum; with integer J and h they are integers and
// the order does not matter.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "snowball_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Rows whose first-plane words are loaded ahead in the plane apply loop.
constexpr int kAhead = 4;

// Words of a (1024-spin) warp chunk.
constexpr int kChunkWords = 32;

template <bool PWL, bool PLANES>
__global__ void __launch_bounds__(kThreads) colored_kernel(
    const Store st, const float* __restrict__ u0,
    const float* __restrict__ s0, const float* __restrict__ e0,
    const float* __restrict__ unif, const float* __restrict__ temps,
    const int* __restrict__ sched, const float* __restrict__ pwl_in,
    int segs, float* __restrict__ u_out, float* __restrict__ s_out,
    float* __restrict__ e_out, float* __restrict__ be_out,
    float* __restrict__ bs_out, int* __restrict__ nf_out,
    int* __restrict__ rf_out, unsigned* __restrict__ masks, int R, int N,
    int T, int S) {
  extern __shared__ float smem[];
  float* u = smem;
  float* s = u + N;
  float* bs = s + N;
  float* pwl_mem = bs + N;                                  // icpt, slope
  const int NW = (S + 31) / 32;
  unsigned* mask = (unsigned*)(pwl_mem + (PWL ? 2 * segs : 0));  // NW words
  unsigned short* list = (unsigned short*)(mask + NW);      // <= S slots

  __shared__ float sh_part[kWarps];
  __shared__ int sh_cnt[kWarps];
  __shared__ int sh_scan[kWarps];
  __shared__ int sh_nacc, sh_better;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31;
  const size_t row0 = (size_t)r * N;
  for (int i = tid; i < N; i += kThreads) {
    u[i] = u0[row0 + i];
    const float si = s0[row0 + i];
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
  // Mask words per thread in the compaction scan (contiguous, in order).
  const int per = (NW + kThreads - 1) / kThreads;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // The reference's dynamic_slice clamps the window into [0, N - S].
    const int w = min(max(sched[3 * t], 0), N - S);
    const int off = sched[3 * t + 1];
    const int size = sched[3 * t + 2];
    const float temp = temps[(size_t)t * R + r];
    const float* un = unif + ((size_t)t * R + r) * S;

    // 1. Accept pass. dE and p of every slot come from the u and s of the
    // step's start: a thread reads and writes only its own slot's spin.
    float part = 0.f;
    int cnt = 0;
    for (int k0 = 0; k0 < S; k0 += kThreads) {
      const int k = k0 + tid;
      bool acc = false;
      if (k < S) {
        const int i = w + k;
        const float de = delta_e(s, u, i);
        const float p = flip_probability<PWL>(de, temp, pwl);
        acc = (un[k] < p) && i >= off && i < off + size;
        const float af = acc ? 1.f : 0.f;
        part = __fadd_rn(part, __fmul_rn(af, de));
        cnt += acc;
        s[i] = __fmul_rn(s[i], __fsub_rn(1.f, __fmul_rn(2.f, af)));
      }
      const unsigned bits = __ballot_sync(kFull, acc);
      if (wl == 0 && k0 + warp * 32 < S) mask[(k0 >> 5) + warp] = bits;
    }
    for (int o = 16; o > 0; o >>= 1) {
      part = __fadd_rn(part, __shfl_xor_sync(kFull, part, o));
      cnt += __shfl_xor_sync(kFull, cnt, o);
    }
    if (wl == 0) {
      sh_part[warp] = part;
      sh_cnt[warp] = cnt;
    }
    __syncthreads();

    // 2. Compaction: thread tid owns words [tid*per, (tid+1)*per); a block
    // exclusive scan of their accept counts places each slot in the list.
    const int wlo = min(NW, tid * per), whi = min(NW, wlo + per);
    int mine = 0;
    for (int x = wlo; x < whi; ++x) mine += __popc(mask[x]);
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (wl >= o) incl += v;
    }
    if (wl == 31) sh_scan[warp] = incl;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      int count = 0, run = 0;
      for (int q = 0; q < kWarps; ++q) {
        sum = __fadd_rn(sum, sh_part[q]);
        count += sh_cnt[q];
        const int v = sh_scan[q];
        sh_scan[q] = run;
        run += v;
      }
      e = __fadd_rn(e, sum);
      nf += count;
      const bool better = e < be;
      if (better) be = e;
      sh_better = better;
      sh_nacc = run;
    }
    __syncthreads();
    {
      int at = sh_scan[warp] + incl - mine;
      unsigned* gm = masks + ((size_t)t * R + r) * NW;
      for (int x = wlo; x < whi; ++x) {
        unsigned m = mask[x];
        gm[x] = m;
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          list[at++] = (unsigned short)(x * 32 + b);
        }
      }
    }
    __syncthreads();

    // 3. Apply the accepted rows in ascending slot order, then best_s.
    const int nacc = sh_nacc;
    const bool better = sh_better;
    if (nacc > 0 || better) {
      for (int w0 = warp * kChunkWords; w0 * 32 < N;
           w0 += kWarps * kChunkWords) {
        float ureg[kChunkWords];
#pragma unroll
        for (int k = 0; k < kChunkWords; ++k) {
          const int i = (w0 + k) * 32 + wl;
          ureg[k] = i < N ? u[i] : 0.f;
        }
        if constexpr (PLANES) {
          for (int a0 = 0; a0 < nacc; a0 += kAhead) {
            unsigned pw[kAhead], qw[kAhead];
#pragma unroll
            for (int x = 0; x < kAhead; ++x) {
              pw[x] = qw[x] = 0u;
              if (a0 + x < nacc)
                load_plane_words(st, 0, w + list[a0 + x], N, w0, &pw[x],
                                 &qw[x]);
            }
#pragma unroll
            for (int x = 0; x < kAhead; ++x) {
              if (a0 + x < nacc) {
                const int j = w + list[a0 + x];
                // s_old = -s_new of an accepted slot; coef = 2*s_old.
                const float coef = __fmul_rn(2.f, -s[j]);
                float row[kChunkWords];
#pragma unroll
                for (int k = 0; k < kChunkWords; ++k) row[k] = 0.f;
                decode_plane_words(pw[x], qw[x], 1.f, row);
                for (int b = 1; b < st.B; ++b) {
                  unsigned p, q;
                  load_plane_words(st, b, j, N, w0, &p, &q);
                  decode_plane_words(p, q, (float)(1 << b), row);
                }
#pragma unroll
                for (int k = 0; k < kChunkWords; ++k)
                  ureg[k] = __fsub_rn(ureg[k], __fmul_rn(coef, row[k]));
              }
            }
          }
        } else {
          for (int a = 0; a < nacc; ++a) {
            const int j = w + list[a];
            const float coef = __fmul_rn(2.f, -s[j]);
            const float* Jrow = st.J + (size_t)j * N;
#pragma unroll
            for (int k = 0; k < kChunkWords; ++k) {
              const int i = (w0 + k) * 32 + wl;
              const float v = i < N ? __ldg(Jrow + i) : 0.f;
              ureg[k] = __fsub_rn(ureg[k], __fmul_rn(coef, v));
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kChunkWords; ++k) {
          const int i = (w0 + k) * 32 + wl;
          if (i < N) {
            u[i] = ureg[k];
            if (better) bs[i] = s[i];
          }
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < N; i += kThreads) {
    u_out[row0 + i] = u[i];
    s_out[row0 + i] = s[i];
    bs_out[row0 + i] = bs[i];
  }

  // rows_fetched: every block of the cluster has written all its masks.
  __threadfence();
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  int fetched = 0;
  for (int x = tid; x < T * NW; x += kThreads) {
    const int t = x / NW, word = x % NW;
    const size_t at = (size_t)t * R * NW + word;
    unsigned lower = 0u;
    for (int q = r - rank; q < r; ++q) lower |= __ldcg(masks + at + q * NW);
    fetched += __popc(__ldcg(masks + at + (size_t)r * NW) & ~lower);
  }
  for (int o = 16; o > 0; o >>= 1) fetched += __shfl_xor_sync(kFull, fetched, o);
  if (wl == 0) sh_cnt[warp] = fetched;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int q = 0; q < kWarps; ++q) total += sh_cnt[q];
    e_out[r] = e;
    be_out[r] = be;
    nf_out[r] = nf;
    rf_out[r] = total;
  }
}

template <bool PWL, bool PLANES>
int launch(const Store& st, const float* u0, const float* s0, const float* e0,
           const float* unif, const float* temps, const int* sched,
           const float* pwl_in, int segs, float* u_out, float* s_out,
           float* e_out, float* be_out, float* bs_out, int* nf_out,
           int* rf_out, unsigned* masks, int R, int N, int T, int S,
           int cluster, size_t smem, cudaStream_t stream) {
  auto kernel = colored_kernel<PWL, PLANES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
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
  err = cudaLaunchKernelEx(&cfg, kernel, st, u0, s0, e0, unif, temps, sched,
                           pwl_in, segs, u_out, s_out, e_out, be_out, bs_out,
                           nf_out, rf_out, masks, R, N, T, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes (the wrapper's size check):
// u, s, best_s (3N f32), the PWL intercepts and slopes (2*segs f32), the
// accept mask (ceil(S/32) words) and the accepted-slot list (S uint16).
size_t snowball_colored_smem_bytes(int N, int S, int segs) {
  const size_t words = ((size_t)S + 31) / 32;
  return (3 * (size_t)N + 2 * (size_t)segs) * sizeof(float) +
         words * sizeof(unsigned) + (size_t)S * sizeof(unsigned short);
}

// T colored steps for R replicas. J != nullptr selects the dense (N, N)
// f32 store; otherwise pos/neg are (B, N, W) uint32 planes. uniforms
// (T, R, S), temps (T, R), sched (T, 3) int32 rows (w, offset, size);
// pwl_in packs icpt[segs], slope[segs], z_lo, z_hi, inv_step, or nullptr
// for the exact sigmoid. masks is a (T, R, ceil(S/32)) uint32 scratch.
// cluster (a divisor of R, 1..8) replicas form one rows_fetched group.
// Returns the launch's CUDA error (0 on success).
int snowball_colored_sweep(const float* J, const unsigned* pos,
                           const unsigned* neg, int B, int W, const float* u0,
                           const float* s0, const float* e0,
                           const float* unif, const float* temps,
                           const int* sched, const float* pwl_in, int segs,
                           float* u_out, float* s_out, float* e_out,
                           float* be_out, float* bs_out, int* nf_out,
                           int* rf_out, unsigned* masks, int R, int N, int T,
                           int S, int cluster, void* stream) {
  const bool planes = J == nullptr;
  if (R <= 0 || N <= 0 || T < 0 || S <= 0 || S > N || S > 65536 ||
      cluster < 1 || cluster > 8 || R % cluster != 0 ||
      (pwl_in != nullptr && segs <= 0) ||
      (planes && (pos == nullptr || neg == nullptr || B <= 0 || B > 30 ||
                  W * 32 < N)))
    return (int)cudaErrorInvalidValue;
  const int sg = pwl_in ? segs : 0;
  const size_t smem = snowball_colored_smem_bytes(N, S, sg);
  const Store st{J, pos, neg, B, W};
  cudaStream_t stream_ = (cudaStream_t)stream;
#define SNOWBALL_COLORED(P, Q)                                               \
  return launch<P, Q>(st, u0, s0, e0, unif, temps, sched, pwl_in, segs,       \
                      u_out, s_out, e_out, be_out, bs_out, nf_out, rf_out,    \
                      masks, R, N, T, S, cluster, smem, stream_)
  if (pwl_in) {
    if (planes) SNOWBALL_COLORED(true, true);
    SNOWBALL_COLORED(true, false);
  }
  if (planes) SNOWBALL_COLORED(false, true);
  SNOWBALL_COLORED(false, false);
#undef SNOWBALL_COLORED
}

}  // extern "C"
