// Kernel A's RWA step for Hopper (sm_90a), on a dense J or packed planes.
//
// Replaces the TPU kernel repro/kernels/sweep.py: mcmc_sweep (body _kernel)
// with mode="rwa" and coupling="dense", "bitplane" and "bitplane_hbm"; RSA
// runs on sweep_rsa.cu. It runs T asynchronous single-spin RWA steps for each
// of R replicas: the roulette over every site's flip probability (with the
// RSA fallback on a degenerate total, or the uniformized null transition),
// then e += accept*dE, u <- u - 2*accept*s_old*J[j,:], the spin flip and
// the copy of s into best_s when e improves.
//
// What bounds it on this card: the T steps of a replica are a serial
// chain. Each step must know every site's flip probability to pick j, and
// must read row j to update the fields the next pick needs. So a step's
// time is a latency: the evaluation, the sums, two exchanges between the
// blocks of the replica and one row read, not the bytes (R*N*4 a step) or
// the operations (R*N flip probabilities a step, a few microseconds of the
// card's rate at N=16384).
//
// What the design does about it:
//
// * The roulette is a tree that does not depend on the width. Leaves are
//   128 sites (lane L of a warp holds the 4 contiguous sites 4L..4L+3); N
//   is padded up to a power-of-two count of leaves with phantom sites of
//   probability exactly 0. Every node is the sum of its two children, left
//   plus right, in index order, from the 4 sites of a lane up to the
//   total; the cluster's c = 2^k blocks each own one whole subtree (rank q
//   the leaves [q*L, (q+1)*L)). So the total and every node's sum are
//   bitwise the same at every width and on every tier, and c is a free
//   choice for speed. The pick descends the tree: go right iff the radius
//   is >= the left sum and the right subtree holds a site < N, subtracting
//   that sum; then the <=-count of the leaf's prefix sums (a lane's
//   running sum of its 4 sites plus the exclusive scan of the lane totals)
//   gives the site, clamped to the leaf's last site < N. common.
//   roulette_pick_tree is its plain version, so ref.mcmc_sweep walks this
//   kernel's trajectory; against the JAX reference, which sums in its
//   lane order, picks agree except near ties.
// * One fused pass a step. Once step t's decision is known every thread
//   applies row j to its sites, evaluates their flip probabilities at step
//   t+1's staged temperature, stores them in shared memory and adds its
//   leaf sums. The owner's leaf pick reads those stored probabilities (the
//   same values bitwise), so no divide is recomputed.
// * No cluster barrier inside the step loop. Each rank posts its subtree
//   sum into slot q of every rank's sums with st.async, which completes on
//   that rank's mbarrier; each rank waits on its own mbarrier only and
//   descends the top log2(c) levels from its local copies. The owner rank
//   descends its subtree (warp 0 keeps the subtree's node sums in
//   registers from building it) and its leaf, and sends the 16-byte
//   decision to every rank the same way; every thread of every rank waits
//   on its own decision barrier. The row read follows the decision (no
//   speculation): a warp issues the loads of all its leaves at once.
// * Window staging (64 steps of 4 uniforms and a temperature; the DRAW
//   variant computes the uniforms with threefry2x32 from the chunk key,
//   uniform01's count (t*R + r)*4 + k) runs on warps 1.. while warp 0
//   waits on the step's exchange, into the second of two buffers.
//
// Barriers, and why they are enough. The sums and decisions live in
// slots of two, sub[t & 1] and dec[t & 1], each with its mbarrier whose
// phase (t >> 1) is step t's. Thread 0 of a rank arms both barriers of
// step t (one arrival plus the bytes expected: 4c and 16) at the start of
// step t, after it waited on both barriers of step t-2, so the arm lands
// in step t's phase; a peer's st.async for step t may arrive before the
// arm (the transaction count dips below zero) but cannot complete the
// phase without it. No arrival for step t+2 can land in step t's phase:
// a rank posts step t+2's sum only after decision t+1, which needs every
// rank's step t+1 sum, which each rank posts only after it has consumed
// step t (its warp 0 read sub[t & 1] and every thread read dec[t & 1],
// the block barrier that ends step t lies between). The same chain keeps
// the slots' contents: sub[t & 1] and dec[t & 1] are overwritten only at
// step t+2. Within a rank, the block barrier that ends each step orders
// the fused pass's writes (u, s, best_s, the probabilities, the leaf sums)
// before warp 0's reads of them and the next pass's writes after the
// pick's reads. Cluster barriers remain at the start (every rank's
// mbarriers are initialised before a peer stores into them) and at the
// end (no rank leaves while a peer could still address its memory).
//
// rows_fetched on the coalesced tier (bitplane_hbm with coalesce): rank 0
// logs the chunk's sites in a (T, R) int32 scratch tensor and the last
// cluster of each group of br replicas counts the group's unique rows per
// step, as sweep.cu does.
//
// Arithmetic: build with -fmad=false, so no multiply-add is contracted
// except the explicit __fmaf_rn of the PWL table. Division is the IEEE-
// rounded __fdiv_rn, kept off zero dividends (whose quotient, a signed
// zero, is taken directly: a zero dividend sends __fdiv_rn down its slow
// path, and on an H100 the evaluation of the sparse N=16384 instance took
// 1.6x as long with it). With the PWL table the kernel is bitwise its plain version at
// every width; the exact sigmoid's expf may differ from torch.sigmoid by
// an ulp, so picks may differ near ties.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ptx.cuh"
#include "snowball_device.cuh"

namespace cg = cooperative_groups;

namespace {

#ifndef SNOWBALL_RWA_THREADS
#define SNOWBALL_RWA_THREADS 256
#endif
constexpr int kThreads = SNOWBALL_RWA_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kLeaf = 128;          // sites of a leaf: 32 lanes x 4
constexpr int kMaxWidth = 16;       // blocks of a cluster (non-portable)
constexpr int kMaxRankLeaves = 128; // a rank's subtree: at most 16384 sites
constexpr int kWindow = 64;         // steps staged at a time
constexpr int kSlots = 4;           // uniforms a step
constexpr int kBatch = 4;           // leaves whose row a warp loads at once
static_assert(kThreads % 32 == 0 && kWarps >= 2, "warp 0 and stagers");

// Measurement hooks, empty here: scripts/rwa_variants.cu defines them to
// stamp clock64() at the step's phase boundaries (thread 0 of each block
// of replica 0) and to wait by spinning on test_wait.
#ifndef RWA_STAMP
#define RWA_STAMP(phase)
#endif
#ifndef RWA_STAMP_ROWS
#define RWA_STAMP_ROWS(x)
#endif
#ifndef RWA_WAIT
#define RWA_WAIT mbar_wait_cluster
#endif

enum StoreKind { kDense = 0, kPlanes = 1 };

// One step's outcome, sent by the deciding rank to every rank.
struct __align__(16) Decision {
  int j;         // the selected site (global index)
  int accept;
  float de;      // its dE
  float s_old;   // its spin before the step
};

struct RwaParams {
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
  int R, N, T, width;
  int leaves;          // leaves of a rank's subtree (a power of two)
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Byte offsets of one block's dynamic shared memory: u and the flip
// probabilities (f32), s and best_s (int8, four a word) of its S sites,
// the PWL table, two staged windows and the leaf sums.
struct Layout {
  size_t u, p, s, bs, pwl, wunif, wtemp, leaf, total;
};

__host__ __device__ inline Layout layout(int leaves, int segs) {
  const size_t S = (size_t)leaves * kLeaf;
  Layout l;
  size_t at = 0;
  l.u = at;     at += 4 * S;
  l.p = at;     at += 4 * S;
  l.s = at;     at += S;
  l.bs = at;    at += S;
  l.pwl = at;   at += align16(8 * (size_t)segs);
  l.wunif = at; at += 4 * 2 * kWindow * kSlots;
  l.wtemp = at; at += 4 * 2 * kWindow;
  l.leaf = at;  at += align16(4 * (size_t)leaves);
  l.total = at;
  return l;
}

// The padded leaves of N sites: the power of two >= ceil(N / 128).
__host__ __device__ inline int tree_leaves(int N) {
  const int need = (N + kLeaf - 1) / kLeaf;
  int nl = 1;
  while (nl < need) nl <<= 1;
  return nl;
}

// J[j, g .. g+3] (0 past N); aligned: N % 4 == 0, so a float4 load.
__device__ __forceinline__ float4 dense_quad(const float* J, int N, int j,
                                             int g, bool aligned) {
  const float* row = J + (size_t)j * N + g;
  if (aligned && g + 4 <= N)
    return __ldg(reinterpret_cast<const float4*>(row));
  float4 v;
  v.x = g < N ? __ldg(row) : 0.f;
  v.y = g + 1 < N ? __ldg(row + 1) : 0.f;
  v.z = g + 2 < N ? __ldg(row + 2) : 0.f;
  v.w = g + 3 < N ? __ldg(row + 3) : 0.f;
  return v;
}

// Stages the uniforms and temperatures of steps [t0, t0 + kWindow) into
// one window buffer; threads k0, k0 + step, ... take slots k.
template <bool DRAW>
__device__ void stage_window(const RwaParams& p, int r, int t0, uint2 key,
                             float* wunif, float* wtemp, int k0, int step) {
  for (int k = k0; k < kWindow * kSlots; k += step) {
    const int t = t0 + k / kSlots;
    if (t < p.T) {
      const size_t at = ((size_t)t * p.R + r) * kSlots + k % kSlots;
      wunif[k] = DRAW ? uniform_at(key, (unsigned)at) : p.unif[at];
    }
  }
  for (int k = k0; k < kWindow; k += step)
    if (t0 + k < p.T) wtemp[k] = p.temps[(size_t)(t0 + k) * p.R + r];
}

// Warp 0: the node sums of this rank's subtree from its leaf sums. Lane k
// < ul = min(L, 32) holds leaves [k*a, k*a + a), a = L / ul (1, 2 or 4),
// in l[]; pair[] their pair sums (a == 4); v[st] the sum of the node of
// 2^st lanes holding lane k (v[0] the lane's own node; v[5] the subtree).
struct Subtree {
  float l[4];
  float pair[2];
  float v[6];
};

__device__ __forceinline__ void build_subtree(const float* leafsum, int ul,
                                              int a, int lg, Subtree& t) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < ul;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    t.l[m] = (in && m < a) ? leafsum[lane * a + m] : 0.f;
  t.pair[0] = __fadd_rn(t.l[0], t.l[1]);
  t.pair[1] = __fadd_rn(t.l[2], t.l[3]);
  t.v[0] = a == 4 ? __fadd_rn(t.pair[0], t.pair[1])
                  : (a == 2 ? t.pair[0] : t.l[0]);
#pragma unroll
  for (int st = 0; st < 5; ++st)
    t.v[st + 1] = st < lg
                      ? __fadd_rn(t.v[st],
                                  __shfl_xor_sync(kFull, t.v[st], 1 << st))
                      : t.v[st];
}

// Warp 0 of the owner: descends its subtree from the residual `res`
// (updated), going right only into a subtree that holds a site below N,
// and returns the local leaf.
__device__ __forceinline__ int descend_subtree(const Subtree& t, int a,
                                               int lg, int lo, int N,
                                               float& res) {
  int g0 = 0;
#pragma unroll
  for (int st = 4; st >= 0; --st) {
    if (st < lg) {
      const float left = __shfl_sync(kFull, t.v[st], g0);
      const int right = g0 + (1 << st);
      if (res >= left && lo + right * a * kLeaf < N) {
        res = __fsub_rn(res, left);
        g0 = right;
      }
    }
  }
  int leaf = g0 * a;
  if (a == 4) {
    const float left = __shfl_sync(kFull, t.pair[0], g0);
    if (res >= left && lo + (leaf + 2) * kLeaf < N) {
      res = __fsub_rn(res, left);
      leaf += 2;
    }
  }
  if (a >= 2) {
    const float mine = leaf - g0 * a ? t.l[2] : t.l[0];
    const float left = __shfl_sync(kFull, mine, g0);
    if (res >= left && lo + (leaf + 1) * kLeaf < N) {
      res = __fsub_rn(res, left);
      leaf += 1;
    }
  }
  return leaf;
}

// Warp 0 of the owner: the site of local leaf `leaf` for the residual
// `res`: the <=-count of the leaf's prefix sums (lane k: the exclusive
// scan of the lane totals plus its running sum over its 4 sites),
// clamped to the leaf's last site below N. Returns the global site.
__device__ __forceinline__ int leaf_pick(const float4* p4, int leaf, int lo,
                                         int N, float res) {
  const int lane = threadIdx.x & 31;
  const float4 x = p4[leaf * 32 + lane];
  const float c0 = x.x;
  const float c1 = __fadd_rn(c0, x.y);
  const float c2 = __fadd_rn(c1, x.z);
  const float c3 = __fadd_rn(c2, x.w);
  float incl = c3;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, v);
  }
  float ex = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) ex = 0.f;
  const int cnt = __popc(__ballot_sync(kFull, __fadd_rn(ex, c0) <= res)) +
                  __popc(__ballot_sync(kFull, __fadd_rn(ex, c1) <= res)) +
                  __popc(__ballot_sync(kFull, __fadd_rn(ex, c2) <= res)) +
                  __popc(__ballot_sync(kFull, __fadd_rn(ex, c3) <= res));
  const int first = lo + leaf * kLeaf;
  return first + min(cnt, min(kLeaf - 1, N - 1 - first));
}

template <bool UNIFORMIZED, bool PWL, int STORE, bool DRAW>
__global__ void __launch_bounds__(kThreads, 1) rwa_kernel(const RwaParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = p.width;
  const int q = (int)cluster.block_rank();   // rank in the replica's cluster
  const int r = blockIdx.x / c;
  const int L = p.leaves;
  const int S = L * kLeaf;                    // sites of this rank's subtree
  const int lo = q * S;
  const int N = p.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Warp 0's view of the subtree: lanes used, leaves a lane, log2 lanes.
  const int ul = min(L, 32), a = L / ul;
  const int lg = 31 - __clz(ul);
  const int lc = 31 - __clz(c);
  const int log_s = 31 - __clz(S);            // S is a power of two

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(L, p.segs);
  float4* u4 = reinterpret_cast<float4*>(smem + lay.u);
  float4* p4 = reinterpret_cast<float4*>(smem + lay.p);
  uint32_t* s4 = reinterpret_cast<uint32_t*>(smem + lay.s);
  uint32_t* bs4 = reinterpret_cast<uint32_t*>(smem + lay.bs);
  float* pwl_mem = reinterpret_cast<float*>(smem + lay.pwl);
  float* wunif = reinterpret_cast<float*>(smem + lay.wunif);
  float* wtemp = reinterpret_cast<float*>(smem + lay.wtemp);
  float* leafsum = reinterpret_cast<float*>(smem + lay.leaf);
  __shared__ float sub[2][kMaxWidth];
  __shared__ Decision dec[2];
  __shared__ __align__(8) uint64_t bar_sum[2];
  __shared__ __align__(8) uint64_t bar_dec[2];
  __shared__ int sh_last;

  const size_t row0 = (size_t)r * N;
  for (int qi = tid; qi < S / 4; qi += kThreads) {
    float4 uu;
    uint32_t sw = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int g = lo + 4 * qi + m;
      const bool real = g < N;
      set_comp(uu, m, real ? p.u0[row0 + g] : 0.f);
      sw = with_spin(sw, m, real ? p.s0[row0 + g] : 1.f);
    }
    u4[qi] = uu;
    s4[qi] = sw;
    bs4[qi] = sw;
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
  stage_window<DRAW>(p, r, 0, key, wunif, wtemp, tid, kThreads);
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(&bar_sum[k], 1);
      mbar_init(&bar_dec[k], 1);
    }
    fence_barrier_init();
  }
  float e = p.e0[r], be = e;  // every thread of every rank keeps the same
  int nf = 0;
  // Every rank has loaded its subtree and initialised its barriers.
  if (c > 1)
    cluster.sync();
  else
    __syncthreads();

  const bool aligned = (N & 3) == 0;
  const bool log_sites = p.site_log != nullptr && q == 0 && tid == 0;
  Subtree tree;

  // The fused pass over this warp's leaves: apply the decision's row
  // (apply), then evaluate the flip probabilities at temp1 and the leaf
  // sums (eval).
  auto pass = [&](bool apply, int j, float coef, float new_sj, bool better,
                  bool eval, float temp1) {
    const int jl = j - lo;
    for (int lf0 = warp; lf0 < L; lf0 += kWarps * kBatch) {
      float4 rows[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) rows[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (apply) {
        if constexpr (STORE == kDense) {
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int lf = lf0 + k * kWarps;
            if (lf < L)
              rows[k] = dense_quad(p.st.J, N, j, lo + lf * kLeaf + 4 * lane,
                                   aligned);
          }
        } else {
          const int sh = (lane & 7) * 4;  // the quad's bits in its word
          for (int b = 0; b < p.st.B; ++b) {
            unsigned pw[kBatch], nw[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
              const int lf = lf0 + k * kWarps;
              const int w = (lo + lf * kLeaf + 4 * lane) >> 5;
              const bool valid = lf < L && w < p.st.W;
              const size_t at = ((size_t)b * N + j) * p.st.W + w;
              pw[k] = valid ? __ldg(p.st.pos + at) : 0u;
              nw[k] = valid ? __ldg(p.st.neg + at) : 0u;
            }
            const float scale = (float)(1 << b);
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const int d = (int)((pw[k] >> (sh + m)) & 1u) -
                              (int)((nw[k] >> (sh + m)) & 1u);
                set_comp(rows[k], m,
                         __fadd_rn(comp(rows[k], m),
                                   __fmul_rn(scale, (float)d)));
              }
            }
          }
        }
        if (lf0 == warp) RWA_STAMP_ROWS(rows[0].x);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int lf = lf0 + k * kWarps;
        if (lf >= L) break;
        const int qi = lf * 32 + lane;
        const int i0 = 4 * qi;
        float4 uu = u4[qi];
        uint32_t sw = s4[qi];
        if (apply) {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            set_comp(uu, m, __fsub_rn(comp(uu, m),
                                      __fmul_rn(coef, comp(rows[k], m))));
          u4[qi] = uu;
          const int m = jl - i0;
          if (m >= 0 && m < 4) {
            sw = with_spin(sw, m, new_sj);
            s4[qi] = sw;
          }
          if (better) bs4[qi] = sw;
        }
        if (eval) {
          float4 pq;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float de = __fmul_rn(__fmul_rn(2.f, spin(sw, m)),
                                       comp(uu, m));
            const float pv = site_probability<PWL>(de, temp1, pwl);
            set_comp(pq, m, lo + i0 + m < N ? pv : 0.f);
          }
          p4[qi] = pq;
          float ls = __fadd_rn(__fadd_rn(pq.x, pq.y), __fadd_rn(pq.z, pq.w));
#pragma unroll
          for (int off = 1; off < 32; off <<= 1)
            ls = __fadd_rn(ls, __shfl_xor_sync(kFull, ls, off));
          if (lane == 0) leafsum[lf] = ls;
        }
      }
    }
  };

  // Warp 0: this rank's subtree sum into slot q of every rank's sums[b].
  auto post_sum = [&](int b) {
    build_subtree(leafsum, ul, a, lg, tree);
    const float total = __shfl_sync(kFull, tree.v[5], 0);
    __syncwarp();
    if (lane < c)
      st_async_b32(cluster_addr(&sub[b][q], lane), __float_as_uint(total),
                   cluster_addr(&bar_sum[b], lane));
  };

  if (p.T > 0) {
    pass(false, -1, 0.f, 0.f, false, true, wtemp[0]);
    __syncthreads();
    if (warp == 0) post_sum(0);
  }

  for (int t = 0; t < p.T; ++t) {
    const int b = t & 1;
    const uint32_t ph = (t >> 1) & 1;
    const int w = t % kWindow;
    const float* un = wunif + (((t / kWindow) & 1) * kWindow + w) * kSlots;
    RWA_STAMP(0);
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&bar_sum[b], 4u * c);
        mbar_arrive_expect_tx(&bar_dec[b], (uint32_t)sizeof(Decision));
      }
      RWA_WAIT(&bar_sum[b], ph);
      RWA_STAMP(1);
      // The top of the tree over the c subtree sums, the same on every
      // rank: the total, the radius and the owner.
      float tv[5];
      tv[0] = lane < c ? sub[b][lane] : 0.f;
#pragma unroll
      for (int st = 0; st < 4; ++st)
        tv[st + 1] = st < lc ? __fadd_rn(tv[st],
                                         __shfl_xor_sync(kFull, tv[st], 1 << st))
                             : tv[st];
      const float total = __shfl_sync(kFull, tv[4], 0);
      const bool degenerate = (total <= 0.f) || !isfinite(total);
      float res = __fmul_rn(un[2], degenerate ? 1.f : total);
      int owner = 0;
#pragma unroll
      for (int st = 3; st >= 0; --st) {
        if (st < lc) {
          const float left = __shfl_sync(kFull, tv[st], owner);
          const int right = owner + (1 << st);
          if (res >= left && right * S < N) {
            res = __fsub_rn(res, left);
            owner = right;
          }
        }
      }
      const int j_fb = site_from_uniform(un[0], N);
      const bool fallback = !UNIFORMIZED && degenerate;
      const int decider = fallback ? j_fb >> log_s : owner;
      if (q == decider) {
        Decision d;
        if (fallback) {
          d.j = j_fb;
        } else {
          const int leaf = descend_subtree(tree, a, lg, lo, N, res);
          d.j = leaf_pick(p4, leaf, lo, N, res);
        }
        const int jl = d.j - lo;
        const float sj = spin(s4[jl >> 2], jl & 3);
        d.s_old = sj;
        d.de = __fmul_rn(__fmul_rn(2.f, sj),
                         reinterpret_cast<const float*>(u4)[jl]);
        if (fallback)
          d.accept = un[1] < reinterpret_cast<const float*>(p4)[jl];
        else
          d.accept = UNIFORMIZED
                         ? (!degenerate && __fmul_rn(un[3], (float)N) < total)
                         : true;
        __syncwarp();
        if (lane < c) {
          const int4 v = make_int4(d.j, d.accept, __float_as_int(d.de),
                                   __float_as_int(d.s_old));
          st_async_v4(cluster_addr(&dec[b], lane), v,
                      cluster_addr(&bar_dec[b], lane));
        }
      }
      RWA_STAMP(2);
    } else if (w == kWindow / 2) {
      // Warps 1.. stage the next window while warp 0 exchanges.
      const int t0 = (t / kWindow + 1) * kWindow;
      if (t0 < p.T) {
        const int nb = (t0 / kWindow) & 1;
        stage_window<DRAW>(p, r, t0, key, wunif + nb * kWindow * kSlots,
                           wtemp + nb * kWindow, tid - 32, kThreads - 32);
      }
    }
    RWA_WAIT(&bar_dec[b], ph);
    RWA_STAMP(3);
    const Decision d = dec[b];
    if (log_sites) p.site_log[(size_t)t * p.R + r] = d.j;
    const float acc = d.accept ? 1.f : 0.f;
    e = __fadd_rn(e, __fmul_rn(acc, d.de));
    nf += d.accept;
    const bool better = e < be;
    if (better) be = e;
    const float coef = __fmul_rn(__fmul_rn(2.f, acc), d.s_old);
    const float new_sj =
        __fmul_rn(d.s_old, __fsub_rn(1.f, __fmul_rn(2.f, acc)));
    const bool eval = t + 1 < p.T;
    const int t1 = t + 1;
    const float temp1 =
        eval ? wtemp[((t1 / kWindow) & 1) * kWindow + t1 % kWindow] : 0.f;
    // A rejected step leaves u, s and best_s unchanged: no row to apply.
    pass(d.accept != 0, d.j, coef, new_sj, better, eval, temp1);
    RWA_STAMP(5);
    __syncthreads();
    RWA_STAMP(6);
    if (eval && warp == 0) post_sum(b ^ 1);
    RWA_STAMP(7);
  }

  for (int qi = tid; qi < S / 4; qi += kThreads) {
    const float4 uu = u4[qi];
    const uint32_t sw = s4[qi], bw = bs4[qi];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int g = lo + 4 * qi + m;
      if (g < N) {
        p.u_out[row0 + g] = comp(uu, m);
        p.s_out[row0 + g] = spin(sw, m);
        p.bs_out[row0 + g] = spin(bw, m);
      }
    }
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

template <bool UNIFORMIZED, bool PWL, int STORE, bool DRAW>
int launch(const RwaParams& p, size_t smem, cudaStream_t stream) {
  auto kernel = rwa_kernel<UNIFORMIZED, PWL, STORE, DRAW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (p.width > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
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
int dispatch(const RwaParams& p, int uniformized, size_t smem,
             cudaStream_t stream) {
  const bool pwl = p.pwl != nullptr;
  if (uniformized)
    return pwl ? launch<true, true, STORE, DRAW>(p, smem, stream)
               : launch<true, false, STORE, DRAW>(p, smem, stream);
  return pwl ? launch<false, true, STORE, DRAW>(p, smem, stream)
             : launch<false, false, STORE, DRAW>(p, smem, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of a width-`width` cluster, in bytes
// (the wrapper's size check; sweep.rwa_shared_bytes mirrors it): u and the
// flip probabilities (f32) and s and best_s (int8) of the block's
// tree_leaves(N)/width leaves of 128 sites, the PWL table, two staged
// windows and the leaf sums.
size_t snowball_sweep_rwa_smem_bytes(int N, int segs, int width) {
  const int nl = tree_leaves(N);
  return layout(nl / width > 0 ? nl / width : 1, segs).total;
}

// T RWA steps for R replicas. The couplings are a dense (N, N) f32 J (pos
// == neg == nullptr) or (B, N, W) uint32 pos/neg planes (J == nullptr).
// unif != nullptr reads the (T, R, 4) uniforms; unif == nullptr draws them
// from stream(base, SWEEP, chunk), base = (key0, key1), or from
// stream(base, SWEEP, fold, chunk) where fold >= 0. pwl_in packs the PWL
// table as icpt[segs], slope[segs], z_lo, z_hi, inv_step; pwl_in ==
// nullptr selects the exact sigmoid. width blocks (a cluster of 1, 2, 4, 8
// or 16, at most tree_leaves(N), each holding at most 128 leaves) run each
// replica. site_log != nullptr counts rows_fetched as the unique rows per
// step of each group of `group` consecutive replicas (site_log (T, R)
// int32 scratch, group_done (R/group) int32 zeros); nullptr counts one row
// per replica per step. Returns the launch's CUDA error (0 on success).
int snowball_sweep_rwa(const float* J, const unsigned* pos,
                       const unsigned* neg, int B, int W, const float* u0,
                       const float* s0, const float* e0, const float* unif,
                       unsigned key0, unsigned key1, int chunk, int fold,
                       const float* temps, const float* pwl_in, int segs,
                       float* u_out, float* s_out, float* e_out,
                       float* be_out, float* bs_out, int* nf_out,
                       int* rf_out, int* site_log, int* group_done,
                       int group, int R, int N, int T, int uniformized,
                       int width, void* stream) {
  const bool planes = J == nullptr;
  const bool pow2 = width >= 1 && (width & (width - 1)) == 0;
  if (R <= 0 || N <= 0 || T < 0 || !pow2 || width > kMaxWidth ||
      width > tree_leaves(N) ||
      tree_leaves(N) / width > kMaxRankLeaves ||
      (pwl_in != nullptr && segs <= 0) ||
      (planes && (pos == nullptr || neg == nullptr || B <= 0 || B > 30 ||
                  W * 32 < N)) ||
      (site_log != nullptr &&
       (group_done == nullptr || group <= 0 || R % group != 0)))
    return (int)cudaErrorInvalidValue;
  const int sg = pwl_in ? segs : 0;
  const int leaves = tree_leaves(N) / width;
  const size_t smem = layout(leaves, sg).total;
  RwaParams p{Store{J, pos, neg, B, W}, u0, s0, e0, unif, key0, key1,
              chunk, fold, temps, pwl_in, sg, u_out, s_out,
              e_out, be_out, bs_out, nf_out, rf_out, site_log, group_done,
              group, R, N, T, width, leaves};
  cudaStream_t st = (cudaStream_t)stream;
  const bool draw = unif == nullptr;
  const int uni = uniformized != 0;
  if (planes)
    return draw ? dispatch<kPlanes, true>(p, uni, smem, st)
                : dispatch<kPlanes, false>(p, uni, smem, st);
  return draw ? dispatch<kDense, true>(p, uni, smem, st)
              : dispatch<kDense, false>(p, uni, smem, st);
}

}  // extern "C"
