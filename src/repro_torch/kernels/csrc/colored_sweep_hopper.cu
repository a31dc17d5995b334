// Kernel D, the graph-colored block-Gibbs sweep, for Hopper (sm_90a), on a
// dense J or packed planes.
//
// Replaces the TPU kernel repro/kernels/sweep.py: colored_sweep (body
// _colored_kernel) with coupling="dense", "bitplane" and "bitplane_hbm".
// It computes what colored_sweep.cu (the earlier design, run only when
// forced) computes, bitwise, for every variant: PWL and the exact sigmoid,
// the read and the drawn (DRAW) uniforms, the window clamp, the three tiers
// and rows_fetched per group of br replicas. Spins are in color-sorted
// order. Each of the T steps schedules one color class, a (T, 3) int32 row
// (w, offset, size): the class occupies [offset, offset + size) inside the
// window [w, w + S), w clamped into [0, N - S]. Every class member takes
// an independent heat-bath flip off the local fields of the step's start
// (accept iff its uniform < p(dE)), e and num_flips add the accepted dE and
// the accept count, the accepted spins flip, and each accepted slot k, in
// ascending k, applies u <- u - 2*s_old_k*J[w+k, :]. Then best_s takes s
// when e improves.
//
// What bounds it on this card: not the bytes. At the sparse N=16384
// anchor a step accepts ~340 slots a replica and its rows (Σ rows_fetched,
// ~874 rows of 4 KB of B=1 planes a step over R=8) take about a
// microsecond at the HBM rate. The earlier design spent ~40 µs a step
// (clock64 stamps, scripts/colored_variants.py): 33.5 in row words gathered
// by per-thread loads in dependent batches of 32 rows, 3.7 in a cluster
// barrier, 1.3 in a compaction behind three block barriers. The dense J
// streams 64 KB a row a replica.
//
// What the design does about it:
//
// * A cluster of C <= 16 blocks a replica (above 8 the non-portable size),
//   rank q holding the slice [q*ncs, q*ncs + nc) of whole 32-spin words
//   (ncs = ceil(ceil(N / C) / 32) * 32; the last slice shorter), its u, s
//   and best_s in shared memory, word-transposed at an odd pitch as in
//   colored_sweep.cu; 8 warps a block. Any C fits that leaves the last
//   block a spin (the wrapper's rule, kernels/sweep.py: colored_width).
// * Accept pass: warp y % 8 takes the rank's y-th class word (lane = slot),
//   with dE, p (site_probability: the IEEE divide kept off a zero dE,
//   bitwise flip_probability) and the uniform; it writes no state. Lanes
//   k < C send the word's accept and old-sign bits to rank k by one 8-byte
//   st.async into mail[t & 1], and each warp ends the pass by sending its
//   (Σ dE, count) partial the same way, also a warp with no class word.
//   Every rank knows from sched how many words (and so bytes) reach it at
//   step t. No cluster barrier in the step loop.
// * After its mail barrier completes, every warp adds the C × 8 partials in
//   rank, then warp, order (e, best_e and "better" bitwise the same on every
//   rank and as colored_sweep.cu), flips the rank's accepted spins from the
//   mail and, when e improved, copies s into best_s (word z of the slice on
//   warp z % 8, lane = bit, so the flip and the copy of a spin are one
//   thread's, in order).
// * Rows into a shared ring, every warp copying with its cp.async, 16 bytes
//   a copy where the rows are 16-byte aligned (planes: W and the slice's
//   word count multiples of 4, a run rounded up to 16 bytes inside the row;
//   dense: N a multiple of 4), else 4. The step's accepted slots in slot
//   order are a list; a step that the ring's K slots (as many as the shared
//   memory left over holds, 2 to 512) hold is one chunk, a longer one goes
//   in chunks of K / 2, the next chunk's copies issued before the current
//   one is applied. Planes: warp w walks the accept words (lane = word, a
//   prefix of their counts), writes the headers (row, old sign) of the
//   chunk's slots sl with sl % 8 == w, then copies their rows' B x 2 plane
//   runs of the slice's words, a group of lanes a row. Dense: every warp
//   writes its entries of the step's whole list once, then copies its rows
//   of each chunk, lanes over the slice's floats. A block barrier once a
//   chunk's copies landed; another after its apply, before the ring is
//   refilled. (One producer warp issuing cp.async.bulk copies on mbarriers
//   with a group-level flow measured slower: the card took one small bulk
//   copy about every 26 ns an SM; PERF.md §6.)
// * Apply from the ring: each u element belongs to one thread, which walks
//   the chunk's slots in list order, so it sees its rows in ascending slot
//   order (a real-valued dense J stays bitwise). Planes: a thread owns a
//   (word, bit group) item of the slice; it loads its word of 16 slots at
//   once from shared memory, skips a word with no bit in its group, and
//   decodes the bits that are set in plane order, as
//   common.decode_bitplane_rows does. Dense: a thread owns 4-spin quads and
//   loads 8 rows' quads at once. A zero coupling is skipped, as in
//   colored_sweep.cu.
//
// Barriers, and why they are enough. mail[p] and its mbarrier serve steps
// p, p + 2, ...; phase n of mail[t & 1] is step t = 2n + (t & 1). Thread 0
// arms step t (one arrival and 8 bytes a word and a partial) at the start
// of step t, after the block barrier that ended step t - 1, so after every
// thread of the rank waited on step t - 2 there: the arm lands in step t's
// phase. A peer's store for step t may arrive before the arm (the
// transaction count dips below zero) but cannot complete the phase without
// it. No store for step t + 2 can land before this rank has consumed step
// t: a peer sends step t + 2 only after its own step t + 1 phase completed,
// which needs this rank's step t + 1 partials, which this rank sends only
// after the block barrier that ends step t, by which every thread has read
// mail[t & 1] (hence every warp sends its partial every step). Within a
// rank, the block barrier that ends each step orders the apply's u writes
// and the flips before the next accept pass. Cluster barriers remain at the
// start (every rank's mbarriers are initialised before a peer stores into
// them) and before rows_fetched (every rank's accept words are written).
//
// rows_fetched: the reference counts, per group of br replicas and per step,
// one row for each slot that any replica of the group accepted, charged to
// the lowest-index replica that accepted it. The owner of each word writes
// its accept word to a global (T, R, NWm) scratch; after the last step each
// cluster arrives at its replica's rows group (an atomic counter per group,
// which the last arriver counts and leaves at zero for the next launch), and
// the last one counts popc(mine & ~OR(lower replicas' words)), as
// colored_sweep.cu does.
//
// Arithmetic: build with -fmad=false, as colored_sweep.cu; the flip
// probability, dE and the uniforms are the shared device functions of
// snowball_device.cuh. The sums of accepted dE are added in colored_sweep.cu's
// order; with integer J and h they are integers and the order does not
// matter against the reference's sum.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ptx.cuh"
#include "snowball_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;       // accept warps, fillers, owners
constexpr int kMaxCluster = 16;             // blocks; non-portable above 8
constexpr int kMinRing = 2;                 // ring slots, at least
constexpr int kMaxRing = 512;               // and at most
constexpr int kScan = 16;                   // slots an owner reads at once
constexpr int kDenseScan = 8;               // dense rows a quad reads at once
constexpr int kMaxItems = 3;                // plane items of a thread
// Dynamic shared memory a block may take: the 232,448 bytes a block may
// hold less 1,024 kept for the static part (sweep.MAX_SHARED_BYTES).
constexpr size_t kBudget = 232448 - 1024;

// Measurement hook, empty here: scripts/colored_variants.cu defines it to
// stamp clock64() at the step's phase boundaries (threads 0 and 32 of each
// block of replica 0).
#ifndef COLORED_STAMP
#define COLORED_STAMP(phase)
#endif

struct ColoredParams {
  Store st;
  const float* u0;
  const float* s0;
  const float* e0;
  const float* unif;   // (T, R, S), the read variant; nullptr: DRAW
  unsigned key0, key1; // DRAW: the two words of the solve's base key
  int chunk;           // DRAW: the chunk index of stream(base, SWEEP, chunk)
  const float* temps;  // (T, R)
  const int* sched;    // (T, 3)
  const float* pwl;    // icpt[segs], slope[segs], z_lo, z_hi, inv_step
  int segs;
  float* u_out;
  float* s_out;
  float* e_out;
  float* be_out;
  float* bs_out;
  int* nf_out;
  int* rf_out;
  unsigned* masks;     // (T, R, NWm) accept words
  int* arrivals;       // one counter per rows group, zero between launches
  int br;              // replicas per rows group
  int R, N, T, S, C;
  int K;               // ring slots
  int vec;             // rows 16-byte aligned: 16-byte copies
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}
// Spins of a rank's slice: N for one block, else a whole number of words
// (the last rank holds what is left).
__host__ __device__ inline int slice_len(int N, int C) {
  return C == 1 ? N : 32 * (((N + C - 1) / C + 31) / 32);
}
// Words of a slice, and the odd pitch of its word-transposed storage.
__host__ __device__ inline int slice_words(int nc) { return (nc + 31) / 32; }
__host__ __device__ inline int slice_pitch(int nc) {
  return slice_words(nc) | 1;
}
// Mask words of one replica's step: the class's slots [a0, a1) span at
// most ceil(S / 32) + 1 global words.
__host__ __device__ inline int mask_words(int S) { return (S + 31) / 32 + 1; }
// Words of one plane run in a ring slot: the slice's words, rounded up to
// 16 bytes.
__host__ __device__ inline int run_words(int ncs) {
  return (slice_words(ncs) + 3) & ~3;
}
// Bytes of a ring slot: 2B plane runs (B > 0), or a dense row's slice of
// ncs floats rounded up to 16 bytes (B == 0).
__host__ __device__ inline size_t slot_bytes(int ncs, int B) {
  return B == 0 ? 4 * (size_t)((ncs + 3) & ~3)
                : 4 * (size_t)2 * B * run_words(ncs);
}

// Byte offsets of a block's dynamic shared memory: u, s, best_s
// (word-transposed), the PWL table, the two mailboxes ([parity][word]
// accept and sign bits), the partials ([parity][rank][warp] Σ dE and
// count), their two mbarriers, the slots' headers and the ring. B == 0: a
// dense J.
struct Layout {
  size_t state, pwl, mail, part, bars, hdr, ring, total;
};

__host__ __device__ inline Layout layout(int N, int S, int segs, int C,
                                         int B, int K) {
  const int nc = slice_len(N, C);
  Layout l;
  size_t at = 0;
  l.state = at; at += 3 * 32 * (size_t)slice_pitch(nc) * 4;
  l.pwl = at;   at += align16(8 * (size_t)segs);
  l.mail = at;  at += align16(2 * 8 * (size_t)mask_words(S));
  l.part = at;  at += 2 * 8 * (size_t)C * kWarps;
  l.bars = at;  at += 16;
  l.hdr = at;   at += align16(4 * (size_t)(B == 0 ? max(K, S) : K));
  l.ring = at;  at += (size_t)K * slot_bytes(nc, B);
  l.total = at;
  return l;
}

// The ring's slots: as many as the budget leaves room for, at most
// kMaxRing; 0 where not even kMinRing fit.
__host__ __device__ inline int ring_slots(int N, int S, int segs, int C,
                                          int B) {
  const size_t base = layout(N, S, segs, C, B, 0).total;
  if (base >= kBudget) return 0;
  int k = (int)((kBudget - base) / (slot_bytes(slice_len(N, C), B) + 4));
  if (k > kMaxRing) k = kMaxRing;
  while (k >= kMinRing && layout(N, S, segs, C, B, k).total > kBudget) --k;
  return k >= kMinRing ? k : 0;
}

// One 4-byte and one 16-byte shared-memory load at a shared address.
__device__ __forceinline__ unsigned lds32(uint32_t at) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(at));
  return v;
}
__device__ __forceinline__ float4 lds128(uint32_t at) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(at));
  return v;
}

__device__ __forceinline__ int tpos(int i, int P) {
  return (i & 31) * P + (i >> 5);
}

// u - 2 * s_old * v for a slot header (row | old sign << 31): s_old = -1
// for a set sign bit.
__device__ __forceinline__ float apply_value(float u, unsigned hdr,
                                             float v) {
  const float coef = hdr >> 31 ? -2.f : 2.f;
  return __fsub_rn(u, __fmul_rn(coef, v));
}

// rows_fetched of the rows group [r0, r0 + br): replica r0 + m is charged
// every accept bit that no lower replica of the group has at the same
// step and slot.
__device__ void count_rows(const ColoredParams& p, int r0, int nwm) {
  __shared__ int sh_cnt[kWarps][8];
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int total = p.T * nwm;
  for (int m0 = 0; m0 < p.br; m0 += 8) {
    int cnt[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) cnt[k] = 0;
    for (int x = tid; x < total; x += kThreads) {
      const int t = x / nwm, xx = x % nwm;
      const unsigned* base = p.masks + ((size_t)t * p.R + r0) * nwm + xx;
      unsigned lower = 0u;
      for (int m = 0; m < m0; ++m) lower |= __ldcg(base + (size_t)m * nwm);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (m0 + k < p.br) {
          const unsigned w = __ldcg(base + (size_t)(m0 + k) * nwm);
          cnt[k] += __popc(w & ~lower);
          lower |= w;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int c = cnt[k];
      for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
      if (wl == 0) sh_cnt[warp][k] = c;
    }
    __syncthreads();
    if (tid < 8 && m0 + tid < p.br) {
      int sum = 0;
      for (int q = 0; q < kWarps; ++q) sum += sh_cnt[q][tid];
      p.rf_out[r0 + m0 + tid] = sum;
    }
    __syncthreads();
  }
}

template <bool PWL, bool PLANES>
__global__ void __launch_bounds__(kThreads, 1)
    colored_hopper_kernel(const ColoredParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C;
  const int q = (int)cluster.block_rank();
  const int r = blockIdx.x / C;  // the cluster's replica
  const int ncs = slice_len(p.N, C), lo = q * ncs;
  const int nc = min(ncs, p.N - lo);
  const int P = slice_pitch(ncs);
  const int nwm = mask_words(p.S);
  const int nws = slice_words(nc);  // this rank's words
  const int B = PLANES ? p.st.B : 0;
  const int K = p.K;
  const Layout L = layout(p.N, p.S, p.segs, C, B, K);
  const int slot_w = (int)(slot_bytes(ncs, B) / 4);
  const int rw = run_words(ncs);

  extern __shared__ __align__(16) unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem + L.state);
  float* s = u + 32 * P;
  float* bs = s + 32 * P;
  float* pwl_mem = reinterpret_cast<float*>(smem + L.pwl);
  uint2* mail = reinterpret_cast<uint2*>(smem + L.mail);
  uint2* part = reinterpret_cast<uint2*>(smem + L.part);
  uint64_t* bar_mail = reinterpret_cast<uint64_t*>(smem + L.bars);
  unsigned* hdr = reinterpret_cast<unsigned*>(smem + L.hdr);
  unsigned* ring = reinterpret_cast<unsigned*>(smem + L.ring);
  const uint32_t ring_s = shared_u32(ring);
  __shared__ int sh_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)r * p.N + lo;
  for (int i = tid; i < nc; i += kThreads) {
    const int at = tpos(i, P);
    u[at] = p.u0[row0 + i];
    const float si = p.s0[row0 + i];
    s[at] = si;
    bs[at] = si;
  }
  Pwl pwl{pwl_mem, pwl_mem + p.segs, 0.f, 0.f, 0.f, p.segs};
  if (PWL) {
    for (int k = tid; k < 2 * p.segs; k += kThreads) pwl_mem[k] = p.pwl[k];
    pwl.z_lo = p.pwl[2 * p.segs];
    pwl.z_hi = p.pwl[2 * p.segs + 1];
    pwl.inv_step = p.pwl[2 * p.segs + 2];
  }
  const bool draw = p.unif == nullptr;
  const uint2 key = draw ? sweep_chunk_key(p.key0, p.key1, p.chunk)
                         : make_uint2(0u, 0u);
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) mbar_init(&bar_mail[k], 1);
    fence_barrier_init();
  }
  // Every thread keeps the replica's e, best_e and num_flips.
  float e = p.e0[r], be = e;
  int nf = 0;

  // The warp's cp.async copies of a row part: the slice's 2B plane runs
  // (or its nc floats), per_run copies a run of cw words each (16 bytes
  // where the rows are aligned, else 4), cpr copies a row. A row of at most
  // 32 copies takes a group of gsz lanes (cpr rounded up to a power of 2),
  // rpp rows a pass; lane L takes copy ck of its group's row, copy ck_off of
  // run ck_run. A longer row takes the warp, copy o of a run on lane o % 32.
  const int cw = p.vec ? 4 : 1;
  const int per_run = ((PLANES ? nws : nc) + cw - 1) / cw;
  const int cpr = (PLANES ? 2 * B : 1) * per_run;
  int gsz = 1;
  while (gsz < cpr && gsz < 32) gsz <<= 1;
  const int rpp = 32 / gsz, gi = lane / gsz, ck = lane % gsz;
  const int ck_run = ck / per_run, ck_off = ck % per_run;
  // This thread's items of the slice on the plane tiers: (word, bit group)
  // pairs, as many groups a word as 256 threads hold.
  int nitems = 0;
  int item_word[kMaxItems];
  unsigned item_mask[kMaxItems];
  if (PLANES) {
    int groups = 1;
    while (groups < 32 && nws * groups * 2 <= kThreads) groups <<= 1;
    const int kb = 32 / groups, items = nws * groups;
#pragma unroll
    for (int m = 0; m < kMaxItems; ++m) {
      const int it = tid + m * kThreads;
      item_word[m] = it % nws;
      item_mask[m] = it >= items ? 0u
                     : kb == 32  ? kFull
                                 : ((1u << kb) - 1u) << (it / nws * kb);
      nitems += it < items;
    }
  }
  // Every rank has loaded its slice and initialised its barriers before
  // any peer stores into them.
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    COLORED_STAMP(0);
    const int par = t & 1;
    // The reference's dynamic_slice clamps the window into [0, N - S];
    // the slots that can accept are the class's inside the window.
    const int w = min(max(p.sched[3 * t], 0), p.N - p.S);
    const int off = p.sched[3 * t + 1], size = p.sched[3 * t + 2];
    const int a0 = max(w, off), a1 = min(w + p.S, off + size);
    const int gw0 = a0 >> 5;
    const int nwords = a1 > a0 ? ((a1 - 1) >> 5) - gw0 + 1 : 0;
    const int m0 = max(a0, lo), m1 = min(a1, lo + nc);
    const int myw0 = m0 >> 5;
    const int mynw = m1 > m0 ? ((m1 - 1) >> 5) - myw0 + 1 : 0;
    uint2* mw = mail + par * nwm;
    if (tid == 0)  // one arrival and the step's bytes
      mbar_arrive_expect_tx(&bar_mail[par],
                            8u * (unsigned)(nwords + C * kWarps));

    // 1. Accept pass over this rank's class words, one word a warp: dE and
    // p from the u and s of the step's start; the words and the warp's
    // partial go to every rank.
    {
      unsigned* masks = p.masks + ((size_t)t * p.R + r) * nwm;
      if (q == 0)  // the words past the step's range count nothing
        for (int x = nwords + tid; x < nwm; x += kThreads) masks[x] = 0u;
      float wsum = 0.f;
      int wcnt = 0;
      for (int y = warp; y < mynw; y += kWarps) {
        const int gw = myw0 + y, i = gw * 32 + lane;
        bool acc = false, neg = false;
        float part_de = 0.f;
        if (i >= a0 && i < a1) {
          const int at = tpos(i - lo, P);
          const float sold = s[at];
          const float de = delta_e(s, u, at);
          const float pr =
              site_probability<PWL>(de, p.temps[(size_t)t * p.R + r], pwl);
          const unsigned count = ((unsigned)t * p.R + r) * p.S + (i - w);
          const float uv = draw ? uniform_at(key, count) : p.unif[count];
          acc = uv < pr;
          part_de = __fmul_rn(acc ? 1.f : 0.f, de);
          neg = acc && sold < 0.f;
        }
        const unsigned accw = __ballot_sync(kFull, acc);
        const unsigned negw = __ballot_sync(kFull, neg);
        for (int o = 16; o > 0; o >>= 1)
          part_de = __fadd_rn(part_de, __shfl_xor_sync(kFull, part_de, o));
        const int x = gw - gw0;
        if (lane < C)  // lane k posts the word to rank k
          st_async_v2(cluster_addr(&mw[x], lane), accw, negw,
                      cluster_addr(&bar_mail[par], lane));
        if (lane == 0) masks[x] = accw;
        wsum = __fadd_rn(wsum, part_de);
        wcnt += __popc(accw);
      }
      if (lane < C)
        st_async_v2(cluster_addr(&part[(par * C + q) * kWarps + warp], lane),
                    __float_as_uint(wsum), (unsigned)wcnt,
                    cluster_addr(&bar_mail[par], lane));
    }
    COLORED_STAMP(1);
    mbar_wait_cluster(&bar_mail[par], (t >> 1) & 1);
    COLORED_STAMP(2);

    // 2. e, best_e and num_flips from the C × 8 partials in rank, then
    // warp, order: lane k adds rank k's.
    float rs = 0.f;
    int rc = 0;
    if (lane < C)
      for (int k = 0; k < kWarps; ++k) {
        const uint2 v = part[(par * C + lane) * kWarps + k];
        rs = __fadd_rn(rs, __uint_as_float(v.x));
        rc += (int)v.y;
      }
    float sum = 0.f;
    int cnt = 0;
    for (int k = 0; k < C; ++k) {
      sum = __fadd_rn(sum, __shfl_sync(kFull, rs, k));
      cnt += __shfl_sync(kFull, rc, k);
    }
    e = __fadd_rn(e, sum);
    nf += cnt;
    const bool better = e < be;
    if (better) be = e;
    int nacc = 0;
    for (int x = lane; x < nwords; x += 32) nacc += __popc(mw[x].x);
    for (int o = 16; o > 0; o >>= 1) nacc += __shfl_xor_sync(kFull, nacc, o);
    // 3. The rank's accepted spins flip (from the mail), then best_s: word
    // z of the slice on warp z % 8, lane = bit.
    {
      const int zc = myw0 - (lo >> 5);  // the class words, when any
      const int z0 = better ? 0 : zc, z1 = better ? nws : zc + mynw;
      const int first = z0 + ((warp - z0 % kWarps) + kWarps) % kWarps;
      for (int z = first; z < z1; z += kWarps) {
        const int i = z * 32 + lane;
        if (i >= nc) continue;
        const int at = tpos(i, P);
        float sv = s[at];
        const int x = (lo >> 5) + z - gw0;
        if (x >= 0 && x < nwords && ((mw[x].x >> lane) & 1u)) {
          sv = __fmul_rn(sv, __fsub_rn(1.f, __fmul_rn(2.f, 1.f)));
          s[at] = sv;
        }
        if (better) bs[at] = sv;
      }
    }
    COLORED_STAMP(3);

    if constexpr (PLANES) {
      // 4. The step's accepted rows, applied in list order.
      // Planes: every warp copies its share of the rows into the ring, then
      // every thread applies them to its items. A step's rows that the ring
      // holds go in one chunk; more go in chunks of half the ring, the next
      // chunk's copies in flight while the current one is applied.
      const int H = nacc <= K ? K : K / 2;
      // Entries [c0, c0 + n) into the slots sb, sb + 1, ...: this warp's are
      // the slots sb + sl with sl % 8 == warp, their headers first (lane =
      // word, a prefix of the words' counts), then their rows, gsz lanes a
      // row; then one commit group.
      auto fill = [&](int c0, int n, int sb) {
        int base = 0;  // entries of the words before the lane block
        for (int xb = 0; xb < nwords && base < c0 + n; xb += 32) {
          const int x = xb + lane;
          const uint2 mv = x < nwords ? mw[x] : make_uint2(0u, 0u);
          const int cn = __popc(mv.x);
          int incl = cn;
          for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += v;
          }
          int sl = base + incl - cn - c0;
          base += __shfl_sync(kFull, incl, 31);
          for (unsigned m = mv.x; m; m &= m - 1u, ++sl)
            if (sl >= 0 && sl < n && (sl & (kWarps - 1)) == warp) {
              const int b = __ffs(m) - 1;
              hdr[sb + sl] = (unsigned)((gw0 + x) * 32 + b) |
                             (((mv.y >> b) & 1u) << 31);
            }
        }
        __syncwarp();
        const int mine = (n - warp + kWarps - 1) / kWarps;
        if (cpr <= 32) {
          for (int i0 = 0; i0 < mine; i0 += rpp) {
            const int ri = i0 + gi;
            if (ri < mine && ck < cpr) {
              const int sl = sb + warp + kWarps * ri;
              const int j = (int)(hdr[sl] & 0x7fffffffu);
              unsigned* d = ring + sl * slot_w + ck_run * rw + ck_off * cw;
              const unsigned* src =
                  ((ck_run & 1) ? p.st.neg : p.st.pos) +
                  ((size_t)(ck_run >> 1) * p.N + j) * p.st.W + (lo >> 5) +
                  ck_off * cw;
              if (cw == 4)
                cp_async_16(d, src);
              else
                cp_async_4(d, src);
            }
          }
        } else {
          for (int ri = 0; ri < mine; ++ri) {
            const int sl = sb + warp + kWarps * ri;
            const int j = (int)(hdr[sl] & 0x7fffffffu);
            unsigned* dst = ring + sl * slot_w;
            for (int run = 0; run < 2 * B; ++run) {
              const unsigned* src =
                  ((run & 1) ? p.st.neg : p.st.pos) +
                  ((size_t)(run >> 1) * p.N + j) * p.st.W + (lo >> 5);
              unsigned* d = dst + run * rw;
              for (int o = lane; o < per_run; o += 32) {
                if (cw == 4)
                  cp_async_16(d + 4 * o, src + 4 * o);
                else
                  cp_async_4(d + o, src + o);
              }
            }
          }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
      if (nacc > 0) fill(0, min(H, nacc), 0);
      for (int c = 0, c0 = 0; c0 < nacc; ++c, c0 += H) {
        const int n = min(H, nacc - c0), sb = (c & 1) * H;
        if (c0 + H < nacc) {
          fill(c0 + H, min(H, nacc - c0 - H), ((c + 1) & 1) * H);
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();  // the chunk's rows are in
        COLORED_STAMP(4);
        {
#pragma unroll
          for (int m = 0; m < kMaxItems; ++m) {
            if (m >= nitems) break;
            const int word = item_word[m];
            const unsigned gmask = item_mask[m];
            for (int k0 = sb; k0 < sb + n; k0 += kScan) {
              // The words of kScan slots, all loads in flight together.
              const uint32_t at0 = ring_s + 4u * ((k0 * slot_w) + word);
              unsigned nzw[kScan];
#pragma unroll
              for (int k = 0; k < kScan; ++k)
                nzw[k] = k0 + k < sb + n
                             ? lds32(at0 + 4u * k * slot_w) |
                                   lds32(at0 + 4u * (k * slot_w + rw))
                             : 0u;
              for (int b = 1; b < B; ++b)
#pragma unroll
                for (int k = 0; k < kScan; ++k)
                  if (k0 + k < sb + n)
                    nzw[k] |= lds32(at0 + 4u * (k * slot_w + 2 * b * rw)) |
                              lds32(at0 + 4u * (k * slot_w + (2 * b + 1) * rw));
              unsigned hit = 0u;
#pragma unroll
              for (int k = 0; k < kScan; ++k)
                hit |= (nzw[k] & gmask ? 1u : 0u) << k;
              while (hit) {
                const int k = k0 + __ffs(hit) - 1;
                hit &= hit - 1u;
                const unsigned h = hdr[k];
                const unsigned* sw = ring + k * slot_w + word;
                const unsigned pw = sw[0], qw = sw[rw];
                unsigned nz = pw | qw;
                for (int b = 1; b < B; ++b)
                  nz |= sw[2 * b * rw] | sw[(2 * b + 1) * rw];
                nz &= gmask;
                while (nz) {
                  const int bit = __ffs(nz) - 1;
                  nz &= nz - 1u;
                  if (word * 32 + bit >= nc) break;
                  // sum_b 2^b (bit(pos_b) - bit(neg_b)) in plane order.
                  float v = (float)((int)((pw >> bit) & 1u) -
                                    (int)((qw >> bit) & 1u));
                  for (int b = 1; b < B; ++b) {
                    const int d = (int)((sw[2 * b * rw] >> bit) & 1u) -
                                  (int)((sw[(2 * b + 1) * rw] >> bit) & 1u);
                    v = __fadd_rn(v, __fmul_rn((float)(1 << b), (float)d));
                  }
                  if (v != 0.f) {
                    float* ur = u + bit * P + word;
                    *ur = apply_value(*ur, h, v);
                  }
                }
              }
            }
          }
        }
        // The chunk's u writes (and, at the step's last chunk, its flips)
        // before the ring's refill and the next accept pass.
        __syncthreads();
        COLORED_STAMP(5);
      }
      if (nacc == 0) __syncthreads();  // the flips before the next pass
    } else {
      // Dense: the step's list first (every warp its entries a % 8 ==
      // warp), then its rows.
      int base = 0;  // entries of the words before the lane block
      for (int xb = 0; xb < nwords; xb += 32) {
        const int x = xb + lane;
        const uint2 mv = x < nwords ? mw[x] : make_uint2(0u, 0u);
        const int cn = __popc(mv.x);
        int incl = cn;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        int a = base + incl - cn;
        base += __shfl_sync(kFull, incl, 31);
        for (unsigned m = mv.x; m; m &= m - 1u, ++a)
          if ((a & (kWarps - 1)) == warp) {
            const int b = __ffs(m) - 1;
            hdr[a] = (unsigned)((gw0 + x) * 32 + b) |
                     (((mv.y >> b) & 1u) << 31);
          }
      }
      __syncthreads();  // the list
      // Chunks of H rows, double-buffered as on the plane tiers: warp w
      // copies the chunk's rows ri % 8 == w, lanes over their 16-byte (or
      // 4-byte) parts.
      const int H = nacc <= K ? K : K / 2;
      const int ng = (nc + 3) / 4;
      auto fill = [&](int c0, int n, int sb) {
        for (int ri = warp; ri < n; ri += kWarps) {
          const int j = (int)(hdr[c0 + ri] & 0x7fffffffu);
          unsigned* d = ring + (sb + ri) * slot_w;
          const unsigned* src = reinterpret_cast<const unsigned*>(
              p.st.J + (size_t)j * p.N + lo);
          for (int o = lane; o < per_run; o += 32) {
            if (cw == 4)
              cp_async_16(d + 4 * o, src + 4 * o);
            else
              cp_async_4(d + o, src + o);
          }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
      if (nacc > 0) fill(0, min(H, nacc), 0);
      for (int c = 0, c0 = 0; c0 < nacc; ++c, c0 += H) {
        const int n = min(H, nacc - c0), sb = (c & 1) * H;
        if (c0 + H < nacc) {
          fill(c0 + H, min(H, nacc - c0 - H), ((c + 1) & 1) * H);
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();  // the chunk's rows are in
        COLORED_STAMP(4);
        for (int g4 = tid; g4 < ng; g4 += kThreads) {
          const int i = 4 * g4;
          for (int k0 = 0; k0 < n; k0 += kDenseScan) {
            // The quads of kDenseScan rows, all loads in flight together.
            float4 v4[kDenseScan];
#pragma unroll
            for (int k = 0; k < kDenseScan; ++k)
              v4[k] = k0 + k < n ? lds128(ring_s + 4u * ((sb + k0 + k) *
                                                        slot_w + 4 * g4))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int k = 0; k < kDenseScan; ++k) {
              const float v[4] = {v4[k].x, v4[k].y, v4[k].z, v4[k].w};
              if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f || v[3] != 0.f) {
                const unsigned h = hdr[c0 + k0 + k];
#pragma unroll
                for (int m = 0; m < 4; ++m)
                  if (v[m] != 0.f && i + m < nc) {
                    float* ur = u + tpos(i + m, P);
                    *ur = apply_value(*ur, h, v[m]);
                  }
              }
            }
          }
        }
        // The chunk's u writes (and, at the step's last chunk, its flips)
        // before the ring's refill and the next accept pass.
        __syncthreads();
        COLORED_STAMP(5);
      }
      if (nacc == 0) __syncthreads();  // the flips before the next pass
    }
    COLORED_STAMP(6);
  }

  for (int i = tid; i < nc; i += kThreads) {
    const int at = tpos(i, P);
    p.u_out[row0 + i] = u[at];
    p.s_out[row0 + i] = s[at];
    p.bs_out[row0 + i] = bs[at];
  }
  if (q == 0 && tid == 0) {
    p.e_out[r] = e;
    p.be_out[r] = be;
    p.nf_out[r] = nf;
  }

  // rows_fetched: every rank's accept words are written.
  __threadfence();
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
  if (q != 0) return;
  const int g = r / p.br;
  if (tid == 0) {
    int last = 1;
    if (p.br > 1) {
      __threadfence();
      last = atomicAdd(p.arrivals + g, 1) == p.br - 1;
    }
    sh_last = last;
  }
  __syncthreads();
  if (sh_last) {
    __threadfence();
    count_rows(p, g * p.br, nwm);
    if (tid == 0 && p.br > 1) p.arrivals[g] = 0;
  }
}

template <bool PWL, bool PLANES>
int launch(const ColoredParams& p, size_t smem, cudaStream_t stream) {
  auto kernel = colored_hopper_kernel<PWL, PLANES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (p.C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.R * p.C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// C blocks split N into whole words, the last one's slice nonempty.
bool valid_width(int N, int S, int C) {
  return C >= 1 && C <= kMaxCluster &&
         (C == 1 || (C - 1) * slice_len(N, C) < N) && S >= 1 && S <= N &&
         S <= 65536;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// The ring's slots at width C (B == 0: a dense J), 0 where fewer than 2
// fit (sweep.colored_ring mirrors it).
int snowball_colored_hopper_ring(int N, int S, int segs, int C, int B) {
  return ring_slots(N, S, segs, C, B);
}

// Dynamic shared memory of one block, in bytes (the wrapper's size check;
// sweep.colored_shared_bytes mirrors it): u, s and best_s of its slice
// (word-transposed, odd pitch), the PWL table, the mailboxes, the
// partials, the mbarriers, the slots' headers and the ring. Where not even
// 2 slots fit, the size at 2.
size_t snowball_colored_hopper_smem_bytes(int N, int S, int segs, int C,
                                          int B) {
  const int K = ring_slots(N, S, segs, C, B);
  return layout(N, S, segs, C, B, K > 0 ? K : kMinRing).total;
}

// T colored steps for R replicas, with colored_sweep.cu's operands: J !=
// nullptr selects the dense (N, N) f32 store; otherwise pos/neg are (B, N,
// W) uint32 planes. unif != nullptr reads the (T, R, S) uniforms; unif ==
// nullptr draws them from stream(base, SWEEP, chunk), base = (key0, key1).
// temps (T, R), sched (T, 3) int32 rows (w, offset, size); pwl_in packs
// icpt[segs], slope[segs], z_lo, z_hi, inv_step, or nullptr for the exact
// sigmoid. Each replica runs on a cluster of C <= 16 blocks, each holding
// slice_len(N, C) spins (the last what is left, at least one) and a ring of
// at least 2 slots. masks is a (T, R, ceil(S/32)+1) uint32 scratch;
// arrivals holds R/br int32 counters, zero, and is left zero; br (a divisor
// of R) replicas form one rows_fetched group. Returns the launch's CUDA
// error (0 on success).
int snowball_colored_sweep_hopper(
    const float* J, const unsigned* pos, const unsigned* neg, int B, int W,
    const float* u0, const float* s0, const float* e0, const float* unif,
    unsigned key0, unsigned key1, int chunk, const float* temps,
    const int* sched, const float* pwl_in, int segs, float* u_out,
    float* s_out, float* e_out, float* be_out, float* bs_out, int* nf_out,
    int* rf_out, unsigned* masks, int* arrivals, int br, int R, int N, int T,
    int S, int C, void* stream) {
  const bool planes = J == nullptr;
  if (R <= 0 || N <= 0 || T < 0 || !valid_width(N, S, C) || br < 1 ||
      R % br != 0 || arrivals == nullptr ||
      (pwl_in != nullptr && segs <= 0) ||
      (planes && (pos == nullptr || neg == nullptr || B <= 0 || B > 30 ||
                  W * 32 < N)))
    return (int)cudaErrorInvalidValue;
  const int sg = pwl_in ? segs : 0;
  const int Bs = planes ? B : 0;
  const int K = ring_slots(N, S, sg, C, Bs);
  const int ncs = slice_len(N, C);
  if (K < kMinRing || slice_words(ncs) > kMaxItems * kThreads)
    return (int)cudaErrorInvalidValue;
  const int vec =
      planes ? (W % 4 == 0 && (C == 1 || slice_words(ncs) % 4 == 0) &&
                aligned16(pos) && aligned16(neg))
             : (N % 4 == 0 && aligned16(J));
  const size_t smem = layout(N, S, sg, C, Bs, K).total;
  const ColoredParams p{Store{J, pos, neg, B, W}, u0, s0, e0, unif, key0,
                        key1, chunk, temps, sched, pwl_in, sg, u_out, s_out,
                        e_out, be_out, bs_out, nf_out, rf_out, masks,
                        arrivals, br, R, N, T, S, C, K, vec};
  cudaStream_t st = (cudaStream_t)stream;
  if (pwl_in) return planes ? launch<true, true>(p, smem, st)
                            : launch<true, false>(p, smem, st);
  return planes ? launch<false, true>(p, smem, st)
                : launch<false, false>(p, smem, st);
}

}  // extern "C"
