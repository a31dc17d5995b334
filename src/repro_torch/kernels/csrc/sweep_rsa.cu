// Kernel A's RSA step for Hopper (sm_90a), on a dense J or packed planes.
//
// Replaces the TPU kernel repro/kernels/sweep.py: mcmc_sweep (body _kernel)
// with mode="rsa" and coupling="dense", "bitplane" and "bitplane_hbm"; RWA
// runs on sweep_rwa.cu. It runs T asynchronous single-spin RSA steps for
// each of R replicas: site j from the step's first uniform, accept when the
// second is below the flip probability of dE = 2 s_j u_j at the step's
// temperature, then e += accept*dE, u <- u - 2*accept*s_old*J[j,:], the
// spin flip and the copy of s into best_s when e improves.
//
// What bounds it on this card: the T steps of a replica are a serial
// chain. Step t+1's decision reads u[j_{t+1}], which step t's row may have
// changed, so a step's time is a latency: the decision, its exchange
// between the blocks of the replica, the row's apply and a block barrier.
// The bytes (one row a step, R*N*4 at most) and the operations (one flip
// probability and one row update a step) are far below it.
//
// What the design does about it:
//
// * Any N, any width. Rank q of a cluster of c = 1..16 blocks (16 the
//   non-portable size) holds the slice [q*S, (q+1)*S) of S sites, S the
//   multiple of 128 at or above N/c; sites past N are phantoms that no
//   step selects and no output reads. A decision depends on site j alone,
//   so every width walks the same trajectory bitwise, and c is a free
//   choice for speed. u is f32; s and best_s are int8.
// * The row off the chain. An RSA site depends only on its uniform, so the
//   sites of a staged window are known before any of its decisions. A ring
//   of K row slots (K from the shared memory left over, 2 to 4) holds the
//   rank's part of the rows of steps t..t+K-1; after step t warps 1.. issue
//   the cp.async copies of step t+K's row into the slot step t freed.
//   On a dense J warps 1.. own the slice's quads of 4 sites (quad q belongs
//   to thread 32 + q % 224): a thread copies its own quads' row parts (16
//   bytes a quad where the rows are 16-byte aligned, else 4) as one commit
//   group and waits for them with cp.async.wait_group before it applies a
//   step to them. On planes warps 1.. share the B x 2 runs of the slice's
//   words out as 16-byte copies (4 where the rows are not aligned), each
//   arrives on the slot's mbarrier when its copies land (count 224), and
//   every thread waits on it before it applies a step to its quads (quad q
//   on thread q % 256). Every step's row is fetched, accepted or not; a
//   rejected step applies nothing.
// * No cluster barrier in the loop. Warp 0 of the rank holding j_{t+1}
//   decides step t+1 once step t is applied (u[j], s[j], dE, the
//   probability with the IEEE divide kept off a zero dE, the compare) and
//   sends the 16-byte decision with st.async into slot (t+1) % 128 of every
//   rank's decisions, completing on that rank's mbarrier for the slot;
//   every thread of every rank waits on its own barrier, the row's owners
//   apply it, and a block barrier orders the apply before the next
//   decision. At c = 1 the same path runs within the block.
// * Window staging (64 steps of a site, an accept uniform and a
//   temperature; the DRAW variant computes the two uniforms with
//   threefry2x32 from the chunk key, uniform01's counts (t*R + r)*4 + 0 and
//   + 1) runs on warps 1.. while warp 0 decides, into the second of two
//   buffers, half a window ahead (so K <= 32 keeps the ring's sites
//   staged). The coalesced tier's site log is written there too.
//
// Barriers, and why they are enough. Decision slot k serves steps k, k+128,
// ...; its mbarrier's phase n is step k + 128n's. Thread 32 arms a slot's
// phase (one arrival plus 16 bytes) at the start for the first 128 steps,
// and after the block barrier that ends step t for step t+128: every thread
// of the rank has then waited on step t's phase. A decision may land before
// its arm (the transaction count dips below zero) but cannot complete the
// phase without it. A decision for step t+128 must not land before step
// t's phase has completed on every rank, and ranks that never decide are
// not held back by the decisions: so at the end of each window w every rank
// arrives on every rank's free[w & 1] (count c), and warp 0, the only
// poster, waits on free[w & 1] before it posts the first step of window
// w+2, which reuses window w's slots. A rank arrives for window w+2 only
// after it has waited there for window w, so no arrival lands in an
// earlier phase. A ring slot is read (apply) before the block barrier that
// ends its step and refilled after it (a dense part by the thread that
// copies and reads it; plane runs by warps 1.., each of which has waited
// on the slot's phase before it arrives for the next). Within a rank, the block barrier ending each step orders the apply's
// writes (u, s, best_s) before the next decision's reads. Cluster barriers
// remain at the start (every rank's mbarriers are initialised before a
// peer stores into them) and at the end (no rank leaves while a peer could
// address its memory).
//
// rows_fetched: one row per replica per step, or on the coalesced tier
// (bitplane_hbm with coalesce) the group's unique rows per step from the
// (T, R) site log, counted by the last cluster of each group of br
// replicas, as sweep.cu does. The physical fetch (every step's row) is not
// what it counts.
//
// Arithmetic: build with -fmad=false, so no multiply-add is contracted
// except the explicit __fmaf_rn of the PWL table. Division is the IEEE-
// rounded __fdiv_rn, kept off zero dividends (a signed zero, taken
// directly; bitwise the same). With the PWL table the kernel is bitwise its
// plain version at every width; the exact sigmoid's expf may differ from
// torch.sigmoid by an ulp, so an accept within a few ulp may split.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ptx.cuh"
#include "snowball_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 16;       // blocks of a cluster (non-portable)
constexpr int kSlab = 128;          // a slice is a multiple of 128 sites
constexpr int kWindow = 64;         // steps staged at a time
constexpr int kDecSlots = 2 * kWindow;
constexpr int kMinRing = 2;         // row slots of the ring
constexpr int kMaxRing = 4;
// Dynamic shared memory a block may take: the 232,448 bytes a block may
// hold less 1,024 kept for the static part (sweep.MAX_SHARED_BYTES).
constexpr size_t kBudget = 232448 - 1024;

// Measurement hook, empty here: scripts/rsa_variants.cu defines it to
// stamp clock64() at the step's phase boundaries (thread 0 of each block
// of replica 0).
#ifndef RSA_STAMP
#define RSA_STAMP(phase)
#endif
// Measurement hook, off here: scripts/rsa_variants.cu defines RSA_BULK_FILL
// to fill each ring slot by one cp.async.bulk a row part (dense) or plane
// run (planes), issued by thread 32 on the slot's mbarrier, in place of the
// warps' copies (16-byte aligned rows only).
#ifdef RSA_BULK_FILL
constexpr bool kBulkFill = true;
#else
constexpr bool kBulkFill = false;
#endif

enum StoreKind { kDense = 0, kPlanes = 1 };

// One step's outcome, sent by the deciding rank to every rank.
struct __align__(16) Decision {
  int j;         // the selected site (global index)
  int accept;
  float de;      // its dE
  float s_old;   // its spin before the step
};

struct RsaParams {
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
  int slice;           // S: sites of a rank's slice, a multiple of kSlab
  int ring;            // K: row slots
  int vec;             // the rows are 16-byte aligned: 16-byte copies
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Sites of a rank's slice at `width` blocks: the multiple of 128 at or
// above ceil(N / width).
__host__ __device__ inline int slice_sites(int N, int width) {
  const int per = (N + width - 1) / width;
  return (per + kSlab - 1) / kSlab * kSlab;
}

// Bytes of one ring slot: the rank's part of a row, S f32 (B == 0, dense)
// or B planes x 2 signs x S/32 words.
__host__ __device__ inline size_t row_bytes(int S, int B) {
  return B == 0 ? 4 * (size_t)S : (size_t)B * 2 * (S / 32) * 4;
}

// Byte offsets of one block's dynamic shared memory: u (f32), s and best_s
// (int8, four a word) of its S sites, the ring of K row slots, the PWL
// table, two staged windows (sites, accept uniforms, temperatures), the
// decision slots and their mbarriers, the plane ring's and the window
// flow's two.
struct Layout {
  size_t u, s, bs, ring, slot, pwl, wj, wacc, wtemp, dec, bar_dec, bar_ring,
      bar_free, total;
};

__host__ __device__ inline Layout layout(int S, int B, int segs, int K) {
  Layout l;
  size_t at = 0;
  l.slot = row_bytes(S, B);
  l.u = at;        at += 4 * (size_t)S;
  l.s = at;        at += S;
  l.bs = at;       at += S;
  l.ring = at;     at += K * l.slot;
  l.pwl = at;      at += align16(8 * (size_t)segs);
  l.wj = at;       at += 4 * 2 * kWindow;
  l.wacc = at;     at += 4 * 2 * kWindow;
  l.wtemp = at;    at += 4 * 2 * kWindow;
  l.dec = at;      at += 16 * kDecSlots;
  l.bar_dec = at;  at += 8 * kDecSlots;
  l.bar_ring = at; at += 8 * kMaxRing;
  l.bar_free = at; at += 8 * 2;
  l.total = at;
  return l;
}

// The ring's slots: as many as the budget leaves room for, at most
// kMaxRing; 0 where not even kMinRing fit.
__host__ __device__ inline int ring_slots(int S, int B, int segs) {
  const size_t base = layout(S, B, segs, 0).total;
  const size_t slot = row_bytes(S, B);
  if (base + kMinRing * slot > kBudget) return 0;
  const size_t k = (kBudget - base) / slot;
  return k < (size_t)kMaxRing ? (int)k : kMaxRing;
}

// Stages the sites, accept uniforms and temperatures of steps [t0, t0 +
// kWindow) into one window buffer; threads k0, k0 + step, ... take items k
// (step t0 + k/2, uniform k % 2). log: write the sites into the site log.
template <bool DRAW>
__device__ void stage_window(const RsaParams& p, int r, int t0, uint2 key,
                             int* wj, float* wacc, float* wtemp, bool log,
                             int k0, int step) {
  for (int k = k0; k < 2 * kWindow; k += step) {
    const int t = t0 + (k >> 1);
    if (t < p.T) {
      const size_t at = ((size_t)t * p.R + r) * 4 + (k & 1);
      const float x = DRAW ? uniform_at(key, (unsigned)at) : p.unif[at];
      if (k & 1) {
        wacc[k >> 1] = x;
      } else {
        const int j = site_from_uniform(x, p.N);
        wj[k >> 1] = j;
        if (log) p.site_log[(size_t)t * p.R + r] = j;
      }
    }
  }
  for (int k = k0; k < kWindow; k += step)
    if (t0 + k < p.T) wtemp[k] = p.temps[(size_t)(t0 + k) * p.R + r];
}

// Returns once at most n (1 to 3) of this thread's cp.async groups are in
// flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

template <bool PWL, int STORE, bool DRAW>
__global__ void __launch_bounds__(kThreads, 1) rsa_kernel(const RsaParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = p.width;
  const int q = (int)cluster.block_rank();   // rank in the replica's cluster
  const int r = blockIdx.x / c;
  const int S = p.slice, K = p.ring, N = p.N, T = p.T;
  const int lo = q * S;
  const int nreal = min(S, N - lo);          // >= 1 by the width rule
  const int nq = (nreal + 3) / 4;            // quads holding a real site
  const int B = STORE == kDense ? 0 : p.st.B;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int own = tid - 32;                  // warps 1..: the quad owner index

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(S, B, p.segs, K);
  float* u = reinterpret_cast<float*>(smem + lay.u);
  float4* u4 = reinterpret_cast<float4*>(u);
  uint32_t* s4 = reinterpret_cast<uint32_t*>(smem + lay.s);
  uint32_t* bs4 = reinterpret_cast<uint32_t*>(smem + lay.bs);
  unsigned char* ring = smem + lay.ring;
  float* pwl_mem = reinterpret_cast<float*>(smem + lay.pwl);
  int* wj = reinterpret_cast<int*>(smem + lay.wj);
  float* wacc = reinterpret_cast<float*>(smem + lay.wacc);
  float* wtemp = reinterpret_cast<float*>(smem + lay.wtemp);
  Decision* dec = reinterpret_cast<Decision*>(smem + lay.dec);
  uint64_t* bar_dec = reinterpret_cast<uint64_t*>(smem + lay.bar_dec);
  uint64_t* bar_ring = reinterpret_cast<uint64_t*>(smem + lay.bar_ring);
  uint64_t* bar_free = reinterpret_cast<uint64_t*>(smem + lay.bar_free);
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
  const bool log_sites = p.site_log != nullptr && q == 0;
  stage_window<DRAW>(p, r, 0, key, wj, wacc, wtemp, log_sites, tid,
                     kThreads);
  if (tid == 0) {
    for (int k = 0; k < kDecSlots; ++k) mbar_init(&bar_dec[k], 1);
    for (int k = 0; k < K; ++k)
      mbar_init(&bar_ring[k], kBulkFill ? 1 : kThreads - 32);
    for (int k = 0; k < 2; ++k) mbar_init(&bar_free[k], c);
    for (int k = 0; k < kDecSlots && k < T; ++k)
      mbar_arrive_expect_tx(&bar_dec[k], (uint32_t)sizeof(Decision));
    fence_barrier_init();
  }
  float e = p.e0[r], be = e;  // every thread of every rank keeps the same
  int nf = 0;
  __syncthreads();  // window 0 staged, the state loaded

  // Step tt's staged entries.
  auto at = [&](int tt) {
    return ((tt / kWindow) & 1) * kWindow + tt % kWindow;
  };
  auto ring_slot = [&](int tt) { return ring + (size_t)(tt % K) * lay.slot; };
  // Warps 1..: this thread's copies of step tt's row into ring slot tt %
  // K. Dense: its quads' row parts, as one commit group (empty past T, so
  // that there is one group a step). Planes: its share of the slice's
  // 16-byte runs of words (4 where the rows are not 16-byte aligned), then
  // its arrival on the slot's mbarrier once they land.
  auto fill = [&](int tt) {
    const bool live = tt < T;
    const int j = live ? wj[at(tt)] : 0;
    unsigned char* slot = ring_slot(tt);
    if constexpr (kBulkFill) {
      if (own != 0 || !live) return;
      uint64_t* bar = &bar_ring[tt % K];
      fence_proxy_async_shared();
      if constexpr (STORE == kDense) {
        mbar_arrive_expect_tx(bar, 4u * nreal);
        cp_async_bulk_1d(slot, p.st.J + (size_t)j * N + lo, 4u * nreal, bar);
      } else {
        const int nws = S / 32, w0 = lo / 32, nw = min(nws, p.st.W - w0);
        mbar_arrive_expect_tx(bar, 8u * B * nw);
        for (int run = 0; run < 2 * B; ++run)
          cp_async_bulk_1d(
              reinterpret_cast<uint32_t*>(slot) + run * nws,
              ((run & 1) ? p.st.neg : p.st.pos) +
                  ((size_t)(run >> 1) * N + j) * p.st.W + w0,
              4u * nw, bar);
      }
      return;
    }
    if constexpr (STORE == kDense) {
      for (int qi = own; live && qi < nq; qi += kThreads - 32) {
        const float* src = p.st.J + (size_t)j * N + lo + 4 * qi;
        float* dst = reinterpret_cast<float*>(slot) + 4 * qi;
        if (p.vec) {
          cp_async_16(dst, src);
        } else {
          for (int m = 0; m < 4 && 4 * qi + m < nreal; ++m)
            cp_async_4(dst + m, src + m);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else if (live) {
      const int nws = S / 32, w0 = lo / 32;
      const int nw = min(nws, p.st.W - w0);   // words of the slice in a row
      uint32_t* dst = reinterpret_cast<uint32_t*>(slot);
      const int per = p.vec ? nw / 4 : nw;    // copies a plane and sign
      for (int k = own; k < 2 * B * per; k += kThreads - 32) {
        const int run = k / per, i = k - run * per;  // run = 2b + sign
        const unsigned* base = (run & 1) ? p.st.neg : p.st.pos;
        const unsigned* src =
            base + ((size_t)(run >> 1) * N + j) * p.st.W + w0;
        if (p.vec)
          cp_async_16(dst + run * nws + 4 * i, src + 4 * i);
        else
          cp_async_4(dst + run * nws + i, src + i);
      }
      cp_async_arrive_noinc(&bar_ring[tt % K]);
    }
  };

  // Step t's row, accepted, on this thread's quads: u -= coef * row, site
  // j's flip, and the copy into best_s when e improved. Dense: warps 1..,
  // each on the quads it copies; planes: every thread, quad q on thread
  // q % 256.
  auto apply = [&](const unsigned char* slot, int j, float coef,
                   float new_sj, bool better) {
    const int jl = j - lo;   // outside [0, S) on the other ranks
    const int q0 = STORE == kDense ? own : tid;
    const int qs = STORE == kDense ? kThreads - 32 : kThreads;
    for (int qi = q0; qi < nq; qi += qs) {
      float4 row;
      if constexpr (STORE == kDense) {
        row = reinterpret_cast<const float4*>(slot)[qi];
      } else {
        // Quad qi's 4 sites are bits sh..sh+3 of the slice's word qi / 8.
        const uint32_t* wds = reinterpret_cast<const uint32_t*>(slot);
        const int nws = S / 32, wi = qi >> 3, sh = (qi & 7) * 4;
        row = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int b = 0; b < B; ++b) {
          const uint32_t pw = wds[(2 * b) * nws + wi];
          const uint32_t nw = wds[(2 * b + 1) * nws + wi];
          const float scale = (float)(1 << b);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int d = (int)((pw >> (sh + m)) & 1u) -
                          (int)((nw >> (sh + m)) & 1u);
            set_comp(row, m,
                     __fadd_rn(comp(row, m), __fmul_rn(scale, (float)d)));
          }
        }
      }
      float4 uu = u4[qi];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        set_comp(uu, m, __fsub_rn(comp(uu, m), __fmul_rn(coef, comp(row, m))));
      u4[qi] = uu;
      uint32_t sw = s4[qi];
      const int m = jl - 4 * qi;
      if (m >= 0 && m < 4) {
        sw = with_spin(sw, m, new_sj);
        s4[qi] = sw;
      }
      if (better) bs4[qi] = sw;
    }
  };

  // Warp 0 of the rank holding step tt's site: its decision, sent to every
  // rank (lane k to rank k).
  auto holds = [&](int tt) {
    const int jl = wj[at(tt)] - lo;
    return jl >= 0 && jl < S;
  };
  auto decide = [&](int tt) {
    const int jl = wj[at(tt)] - lo;
    const float sx = spin(s4[jl >> 2], jl & 3);
    const float de = __fmul_rn(__fmul_rn(2.f, sx), u[jl]);
    const int acc = wacc[at(tt)] < site_probability<PWL>(de, wtemp[at(tt)],
                                                         pwl);
    return make_int4(jl + lo, acc, __float_as_int(de), __float_as_int(sx));
  };
  auto send = [&](int tt, int4 v) {
    const int slot = tt % kDecSlots;
    if (lane < c)
      st_async_v4(cluster_addr(&dec[slot], lane), v,
                  cluster_addr(&bar_dec[slot], lane));
  };
  // Window tt / 64 reuses the decision slots of the window two back, which
  // every rank has consumed.
  auto flow = [&](int tt) {
    const int win = tt / kWindow;
    if (tt % kWindow == 0 && win >= 2)
      mbar_wait_cluster(&bar_free[win & 1], ((win - 2) >> 1) & 1);
  };

  int4 first = make_int4(0, 0, 0, 0);
  // No rank applies before the cluster barrier below: step 0 is decided on
  // the chunk's initial state.
  if (warp == 0 && T > 0 && holds(0)) first = decide(0);
  if (warp != 0)
    for (int k = 0; k < K; ++k) fill(k);
  // Every rank has loaded its slice and initialised its barriers.
  if (c > 1)
    cluster.sync();
  else
    __syncthreads();
  if (warp == 0 && T > 0 && holds(0)) send(0, first);

  for (int t = 0; t < T; ++t) {
    const int w = t % kWindow;
    const int slot = t % kDecSlots;
    RSA_STAMP(0);
    mbar_wait_cluster(&bar_dec[slot], (t / kDecSlots) & 1);
    RSA_STAMP(1);
    const Decision d = dec[slot];
    const float acc = d.accept ? 1.f : 0.f;
    e = __fadd_rn(e, __fmul_rn(acc, d.de));
    nf += d.accept;
    const bool better = e < be;
    if (better) be = e;
    if (STORE != kDense || warp != 0) {
      // Step t's row is in: this thread's copies (dense), every thread's
      // (planes).
      if constexpr (STORE == kDense && !kBulkFill)
        cp_async_wait(K - 1);
      else
        mbar_wait(&bar_ring[t % K], (t / K) & 1);
      // A rejected step leaves u, s and best_s unchanged: nothing to apply.
      if (d.accept)
        apply(ring_slot(t), d.j, __fmul_rn(__fmul_rn(2.f, acc), d.s_old),
              __fmul_rn(d.s_old, __fsub_rn(1.f, __fmul_rn(2.f, acc))),
              better);
    }
    RSA_STAMP(2);
    __syncthreads();
    RSA_STAMP(3);
    if (warp != 0) {
      fill(t + K);   // into the slot step t freed
      if (tid == 32 && t + kDecSlots < T)
        mbar_arrive_expect_tx(&bar_dec[slot], (uint32_t)sizeof(Decision));
      if (w == kWindow / 2 && (t / kWindow + 1) * kWindow < T) {
        // Stage the next window; it is read from the next step on.
        const int t0 = (t / kWindow + 1) * kWindow;
        const int nb = ((t0 / kWindow) & 1) * kWindow;
        stage_window<DRAW>(p, r, t0, key, wj + nb, wacc + nb, wtemp + nb,
                           log_sites, own, kThreads - 32);
      }
    } else {
      if (w == kWindow - 1 && (t / kWindow + 2) * kWindow < T && lane < c)
        mbar_arrive_remote(
            cluster_addr(&bar_free[(t / kWindow) & 1], lane));
      RSA_STAMP(4);
      if (t + 1 < T) {
        flow(t + 1);
        if (holds(t + 1)) send(t + 1, decide(t + 1));
      }
    }
    RSA_STAMP(5);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

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
    if (p.site_log == nullptr) p.rf_out[r] = T;  // one row a step
  }
  if (log_sites) {
    const int r0 = r - r % p.group;
    __threadfence();  // this thread's log entries before the arrival
    __syncthreads();
    if (tid == 0)
      sh_last = atomicAdd(p.group_done + r / p.group, 1) == p.group - 1;
    __syncthreads();
    if (sh_last) {
      __threadfence();
      count_group_rows(p.site_log, p.rf_out, p.R, T, p.group, r0,
                       kThreads / 32);
    }
  }
  // No rank leaves while a peer could still address its shared memory.
  if (c > 1) cluster.sync();
}

template <bool PWL, int STORE, bool DRAW>
int launch(const RsaParams& p, size_t smem, cudaStream_t stream) {
  auto kernel = rsa_kernel<PWL, STORE, DRAW>;
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
int dispatch(const RsaParams& p, size_t smem, cudaStream_t stream) {
  return p.pwl != nullptr ? launch<true, STORE, DRAW>(p, smem, stream)
                          : launch<false, STORE, DRAW>(p, smem, stream);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of a width-`width` cluster, in bytes
// (the wrapper's size check; sweep.rsa_shared_bytes mirrors it): u (f32),
// s and best_s (int8) of its slice_sites(N, width) sites, the ring (as
// many row slots as the budget leaves room for, 2 to 4; a row part is S
// f32 on a dense J, B == 0, or 2B runs of S/32 plane words), the PWL
// table, two staged windows, 128 decision slots and the mbarriers. Where
// not even 2 slots fit, the size at 2.
size_t snowball_sweep_rsa_smem_bytes(int N, int B, int segs, int width) {
  const int S = slice_sites(N, width);
  const int K = ring_slots(S, B, segs);
  return layout(S, B, segs, K > 0 ? K : kMinRing).total;
}

// T RSA steps for R replicas. The couplings are a dense (N, N) f32 J (pos
// == neg == nullptr) or (B, N, W) uint32 pos/neg planes (J == nullptr).
// unif != nullptr reads the (T, R, 4) uniforms; unif == nullptr draws them
// from stream(base, SWEEP, chunk), base = (key0, key1), or from
// stream(base, SWEEP, fold, chunk) where fold >= 0. pwl_in packs the PWL
// table as icpt[segs], slope[segs], z_lo, z_hi, inv_step; pwl_in ==
// nullptr selects the exact sigmoid. width blocks (a cluster of 1..16,
// each holding a slice of slice_sites(N, width) sites with at least one
// below N, in the budget) run each replica. site_log != nullptr counts
// rows_fetched as the unique rows per step of each group of `group`
// consecutive replicas (site_log (T, R) int32 scratch, group_done (R/group)
// int32 zeros); nullptr counts one row per replica per step. Returns the
// launch's CUDA error (0 on success).
int snowball_sweep_rsa(const float* J, const unsigned* pos,
                       const unsigned* neg, int B, int W, const float* u0,
                       const float* s0, const float* e0, const float* unif,
                       unsigned key0, unsigned key1, int chunk, int fold,
                       const float* temps, const float* pwl_in, int segs,
                       float* u_out, float* s_out, float* e_out,
                       float* be_out, float* bs_out, int* nf_out,
                       int* rf_out, int* site_log, int* group_done,
                       int group, int R, int N, int T, int width,
                       void* stream) {
  const bool planes = J == nullptr;
  if (R <= 0 || N <= 0 || T < 0 || width < 1 || width > kMaxWidth ||
      (pwl_in != nullptr && segs <= 0) ||
      (planes && (pos == nullptr || neg == nullptr || B <= 0 || B > 30 ||
                  W * 32 < N)) ||
      (site_log != nullptr &&
       (group_done == nullptr || group <= 0 || R % group != 0)))
    return (int)cudaErrorInvalidValue;
  const int S = slice_sites(N, width);
  const int sg = pwl_in ? segs : 0;
  const int Bs = planes ? B : 0;
  const int K = ring_slots(S, Bs, sg);
  if ((long long)(width - 1) * S >= N || K == 0)
    return (int)cudaErrorInvalidValue;
  const int vec = planes ? (W % 4 == 0 && aligned16(pos) && aligned16(neg))
                         : (N % 4 == 0 && aligned16(J));
  if (kBulkFill && !vec) return (int)cudaErrorInvalidValue;
  RsaParams p{Store{J, pos, neg, B, W}, u0, s0, e0, unif, key0, key1,
              chunk, fold, temps, pwl_in, sg, u_out, s_out,
              e_out, be_out, bs_out, nf_out, rf_out, site_log, group_done,
              group, R, N, T, width, S, K, vec};
  const size_t smem = layout(S, Bs, sg, K).total;
  cudaStream_t st = (cudaStream_t)stream;
  const bool draw = unif == nullptr;
  if (planes)
    return draw ? dispatch<kPlanes, true>(p, smem, st)
                : dispatch<kPlanes, false>(p, smem, st);
  return draw ? dispatch<kDense, true>(p, smem, st)
              : dispatch<kDense, false>(p, smem, st);
}

}  // extern "C"
