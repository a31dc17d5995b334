// Graph-colored block-Gibbs sweep for Hopper (sm_90a), on a dense J or
// packed planes.
//
// Replaces the TPU kernel repro/kernels/sweep.py: colored_sweep (body
// _colored_kernel) with coupling="dense", "bitplane" and "bitplane_hbm".
// Spins are in color-sorted order. Each of the T steps schedules one color
// class, given as a (T, 3) int32 row (w, offset, size): the class occupies
// [offset, offset + size) inside the static window [w, w + S). Every class
// member takes an independent heat-bath flip off the local fields of the
// step's start (accept iff its uniform < p(dE), p the PWL or exact
// sigmoid), e and num_flips add the accepted dE and the accept count, the
// accepted spins flip, and each accepted slot k, in ascending k, applies
// u <- u - 2*s_old_k*J[w+k, :]. Same-color spins share no coupling, so the
// dE taken at the start of the step stays valid at every member: exact
// block Gibbs. Then best_s takes s when e improves. The kernel takes no
// selection mode: colored trajectories do not depend on rsa/rwa.
//
// What bounds it on this card: the row updates. A step at the N=16384
// anchor accepts ~340 slots per replica; each accepted row is an N-wide
// read (4 KB of B=1 planes, 64 KB of dense f32) and a subtract where the
// row is nonzero. The planes of a sparse J are almost all zero words, so
// on the plane tiers a row costs its loads; the dense J (1 GiB) streams
// from HBM.
//
// What the design does about it:
//
// * One thread-block cluster per replica, its C blocks (C <= 16; above 8
//   the non-portable size) splitting N into slices of a whole number of
//   32-spin words, ceil(ceil(N / C) / 32) of them (the last rank's slice
//   is shorter). Rank q keeps u, s and best_s of its slice in shared
//   memory for the whole chunk. At R replicas the kernel runs R*C blocks,
//   and N reaches C times what one block holds. The wrapper picks C
//   (kernels/sweep.py: colored_width).
// * Accept pass: the rank that holds a class slot decides its accept (one
//   32-slot word per warp, lane = slot), flips its own spin, and pushes
//   the word's accept bits and old-spin sign bits into every rank's
//   mailbox (distributed shared memory), and its dE partial sum and
//   accept count after the pass. The accept uniforms come from a (T, R, S)
//   tensor (the read variant) or are drawn in place (the DRAW variant:
//   element (t*R + r)*S + k of rng.uniform01(stream(base, SWEEP, chunk),
//   (T, R, S)), by the threefry of snowball_device.cuh), only for the
//   class's slots: a slot outside the class is never accepted.
// * One cluster barrier a step. Then every rank adds the C partial sums in
//   rank order (e, best_e and the "better" decision are bitwise the same on
//   every rank) and compacts the accept words, in ascending slot order,
//   into a list of entries (slot, old-spin sign).
// * Apply: each row of the list is read on the rank's slice and
//   subtracted. A zero coupling is skipped (a plane word with no bit set
//   is not decoded): the reference's u - 2*s*0 changes only the sign of a
//   zero. Every u element belongs to one thread, which walks the list in
//   order, so it sees its rows in ascending slot order: a real-valued
//   dense J stays bitwise with the plain version.
//   - Planes: a thread owns a (word, bit group) of the slice; it loads the
//     words of kAhead rows ahead (the loads of several rows in flight) and
//     decodes only the bits that are set.
//   - Dense: a thread owns 4-spin groups of the slice and keeps kRing - 1
//     rows' slices in flight in a private shared-memory ring (cp.async,
//     16 bytes a copy where the rows are aligned), so the tier no longer
//     runs as a chain of dependent misses.
//   u, s and best_s of a slice are stored word-transposed (spin i of the
//   slice at (i % 32) * P + i / 32, P = words | 1, odd): a warp touching 32
//   consecutive spins, or one bit of 32 consecutive words, hits 32 banks.
//
// Barriers, and why one a step is enough. No rank reads another rank's u,
// s or best_s: only the mailboxes cross blocks. Step t writes mailbox
// t & 1 of every rank before the step's barrier, and every rank reads it
// after that barrier and before it arrives at step t+1's. The next write
// into mailbox t & 1 is step t+2's, which a rank reaches only after step
// t+1's barrier, which no rank passes before all have finished reading
// step t's. Each step ends with a block barrier, since the next accept
// pass reads u and s that other threads just updated. With C = 1 the
// cluster barriers are block barriers.
//
// rows_fetched: the reference counts, per group of br replicas (the
// rows-fetched group) and per step, one row for each slot that any replica
// of the group accepted, charged to the lowest-index replica that accepted
// it. The owner of each word writes its accept word to a global
// (T, R, NWm) scratch; after the last step each cluster arrives at its
// replica's rows group (an atomic counter per group, which the last
// arriver counts and leaves at zero for the next launch), and the last one
// counts popc(mine & ~OR(lower replicas' words)).
//
// Arithmetic: build with -fmad=false, as sweep.cu; the flip probability,
// dE and the uniforms are the shared device functions of
// snowball_device.cuh, and a plane row is decoded in plane order as in
// common.decode_bitplane_rows. The sums of accepted dE are added in another
// order than the reference's sum; with integer J and h they are integers
// and the order does not matter.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "snowball_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks of a cluster (16 needs the non-portable cluster size).
constexpr int kMaxCluster = 16;
// Plane rows whose words a thread loads at once (bits of one mask).
constexpr int kAhead = 32;
// Dense row slices in a thread's cp.async ring (kRing - 1 in flight). A
// deeper ring (16 or 32 rows) measured slower at the anchor.
constexpr int kRing = 8;

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
};

__host__ __device__ inline size_t align16(size_t x) {
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

// Byte offsets of a block's dynamic shared memory.
struct Smem {
  size_t state, pwl, mail, part, wpart, list, ring, total;
};

__host__ __device__ inline Smem smem_layout(int N, int S, int segs, int C,
                                            bool dense) {
  const int nc = slice_len(N, C);
  const size_t sp = 32 * (size_t)slice_pitch(nc);
  Smem m;
  size_t at = 0;
  m.state = at;                       // u, s, best_s: 3 * sp f32
  at = align16(at + 3 * sp * 4);
  m.pwl = at;                         // icpt, slope
  at = align16(at + 2 * (size_t)segs * 4);
  m.mail = at;                        // [parity][accept | sign][NWm]
  at = align16(at + 4 * (size_t)mask_words(S) * 4);
  m.part = at;                        // [parity][rank] f32, then int
  at = align16(at + 2 * 2 * (size_t)C * 4);
  m.wpart = at;                       // [warp] f32, then int
  at = align16(at + 2 * (size_t)kWarps * 4);
  m.list = at;                        // <= S entries
  at = align16(at + (size_t)S * 4);
  m.ring = at;                        // dense: kRing row slices
  if (dense) at = align16(at + (size_t)kRing * ((nc + 3) / 4) * 16);
  m.total = at;
  return m;
}

__device__ __forceinline__ int tpos(int i, int P) {
  return (i & 31) * P + (i >> 5);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A barrier of the replica's blocks: the cluster's, or the block's alone.
__device__ __forceinline__ void group_sync(cg::cluster_group& cluster,
                                           int C) {
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
}

// Rank `rank`'s copy of a shared-memory array (this block's for C = 1).
template <typename T>
__device__ __forceinline__ T* at_rank(cg::cluster_group& cluster, T* p,
                                      int rank, int C) {
  return C > 1 ? cluster.map_shared_rank(p, rank) : p;
}

// A list entry: the slot (below 2^16) and whether its old spin was -1.
__device__ __forceinline__ int entry_slot(unsigned e) {
  return (int)(e & 0xffffu);
}
// u - 2 * s_old * v, with s_old = -1 for a set sign bit.
__device__ __forceinline__ float apply_value(float u, unsigned e, float v) {
  const float coef = e >> 16 ? -2.f : 2.f;
  return __fsub_rn(u, __fmul_rn(coef, v));
}

// Plane b's words of row j at global word gw.
__device__ __forceinline__ unsigned plane_bits(const Store& st, int N, int b,
                                               int j, size_t gw,
                                               unsigned* q) {
  const size_t at = ((size_t)b * N + j) * st.W + gw;
  *q = __ldg(st.neg + at);
  return __ldg(st.pos + at);
}

// The list's rows on the plane tiers: thread items (word, bit group). A
// thread loads its word of kAhead rows at once (the loads in flight
// together), notes which rows have a bit in its group, and decodes only
// those, reloading their words (L1 hits).
__device__ void apply_planes(const ColoredParams& p, const unsigned* list,
                             int nacc, int a0, int lo, int nc, float* u,
                             int P) {
  const Store& st = p.st;
  const int nws = slice_words(nc);
  int groups = 1;
  while (groups < 32 && nws * groups < kThreads) groups <<= 1;
  const int kb = 32 / groups;
  const int items = nws * groups;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int word = it % nws, b0 = (it / nws) * kb;
    const unsigned gmask = kb == 32 ? kFull : ((1u << kb) - 1u) << b0;
    const size_t gw = (size_t)(lo >> 5) + word;
    for (int a = 0; a < nacc; a += kAhead) {
      // Unconditional loads (a row past the list repeats the last one), so
      // all 2*kAhead are in flight before the first is used.
      unsigned pw[kAhead], qw[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int j = a0 + entry_slot(list[min(a + k, nacc - 1)]);
        pw[k] = plane_bits(st, p.N, 0, j, gw, &qw[k]);
      }
      unsigned hit = 0u;
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        hit |= ((pw[k] | qw[k]) & gmask ? 1u : 0u) << k;
      for (int b = 1; b < st.B; ++b) {
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          const int j = a0 + entry_slot(list[min(a + k, nacc - 1)]);
          pw[k] = plane_bits(st, p.N, b, j, gw, &qw[k]);
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k)
          hit |= ((pw[k] | qw[k]) & gmask ? 1u : 0u) << k;
      }
      if (nacc - a < kAhead) hit &= (1u << (nacc - a)) - 1u;
      while (hit) {
        const int k = __ffs(hit) - 1;
        hit &= hit - 1;
        const unsigned entry = list[a + k];
        const int j = a0 + entry_slot(entry);
        unsigned qw;
        const unsigned pw = plane_bits(st, p.N, 0, j, gw, &qw);
        unsigned nz = pw | qw;
        for (int b = 1; b < st.B; ++b) {
          unsigned q;
          nz |= plane_bits(st, p.N, b, j, gw, &q);
          nz |= q;
        }
        nz &= gmask;
        while (nz) {
          const int bit = __ffs(nz) - 1;
          nz &= nz - 1;
          if (word * 32 + bit >= nc) break;
          // sum_b 2^b (bit(pos_b) - bit(neg_b)) in plane order.
          float v = (float)((int)((pw >> bit) & 1u) - (int)((qw >> bit) & 1u));
          for (int b = 1; b < st.B; ++b) {
            unsigned q;
            const unsigned pb = plane_bits(st, p.N, b, j, gw, &q);
            const int d = (int)((pb >> bit) & 1u) - (int)((q >> bit) & 1u);
            v = __fadd_rn(v, __fmul_rn((float)(1 << b), (float)d));
          }
          if (v != 0.f) {
            float* ur = u + bit * P + word;
            *ur = apply_value(*ur, entry, v);
          }
        }
      }
    }
  }
}

// The list's rows on the dense tier: thread items are 4-spin groups; the
// row slices stream through the thread's own cp.async ring of kRing rows,
// so no barrier is needed between a copy and its use.
__device__ void apply_dense(const ColoredParams& p, const unsigned* list,
                            int nacc, int a0, int lo, int nc, float* u,
                            int P, float* ring) {
  const int ng = (nc + 3) / 4;
  const int stage = 4 * ng;
  const bool vec = (p.N & 3) == 0;
  auto issue = [&](int a) {
    if (a < nacc) {
      const float* src =
          p.st.J + (size_t)(a0 + entry_slot(list[a])) * p.N + lo;
      float* dst = ring + (a % kRing) * stage;
      for (int g4 = threadIdx.x; g4 < ng; g4 += kThreads) {
        const int i = 4 * g4;
        if (vec && i + 4 <= nc) {
          cp_async16(dst + i, src + i);
        } else {
          for (int k = 0; k < 4; ++k)
            if (i + k < nc) cp_async4(dst + i + k, src + i + k);
        }
      }
    }
    cp_async_commit();  // possibly empty: one group per row, always
  };
  for (int a = 0; a < kRing - 1; ++a) issue(a);
  for (int a = 0; a < nacc; ++a) {
    // Slot (a - 1) % kRing was last read by this thread in iteration a-1.
    issue(a + kRing - 1);
    cp_async_wait<kRing - 1>();  // row a's copies (this thread's) are done
    const unsigned entry = list[a];
    const float* row = ring + (a % kRing) * stage;
    for (int g4 = threadIdx.x; g4 < ng; g4 += kThreads) {
      const float4 v4 = *reinterpret_cast<const float4*>(row + 4 * g4);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      const int i = 4 * g4;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (v[k] != 0.f && i + k < nc) {
          float* ur = u + tpos(i + k, P);
          *ur = apply_value(*ur, entry, v[k]);
        }
    }
  }
  cp_async_wait<0>();
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
__global__ void __launch_bounds__(kThreads)
    colored_kernel(const ColoredParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C;
  const int q = C > 1 ? (int)cluster.block_rank() : 0;
  const int r = blockIdx.x / C;  // the cluster's replica
  const int ncs = slice_len(p.N, C), lo = q * ncs;
  const int nc = min(ncs, p.N - lo);
  const int P = slice_pitch(ncs);
  const int nwm = mask_words(p.S);
  const Smem L = smem_layout(p.N, p.S, p.segs, C, !PLANES);

  extern __shared__ __align__(16) unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem + L.state);
  float* s = u + 32 * P;
  float* bs = s + 32 * P;
  float* pwl_mem = reinterpret_cast<float*>(smem + L.pwl);
  unsigned* mail = reinterpret_cast<unsigned*>(smem + L.mail);
  float* partf = reinterpret_cast<float*>(smem + L.part);
  int* parti = reinterpret_cast<int*>(partf + 2 * C);
  float* wpartf = reinterpret_cast<float*>(smem + L.wpart);
  int* wparti = reinterpret_cast<int*>(wpartf + kWarps);
  unsigned* list = reinterpret_cast<unsigned*>(smem + L.list);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  __shared__ int sh_scan[kWarps];
  __shared__ int sh_nacc, sh_better, sh_last;

  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
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
  // Thread 0 keeps the replica's e, best_e and num_flips.
  float e = 0.f, be = 0.f;
  int nf = 0;
  if (tid == 0) {
    e = p.e0[r];
    be = e;
  }
  // Every block of the cluster runs before any writes to a peer's memory.
  group_sync(cluster, C);

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
    unsigned* masks = p.masks + ((size_t)t * p.R + r) * nwm;

    // 1. Accept pass over this rank's class words, one word a warp: dE and
    // p from the u and s of the step's start.
    if (wl == 0) {
      wpartf[warp] = 0.f;
      wparti[warp] = 0;
    }
    if (q == 0)  // the words past the step's range count nothing
      for (int x = nwords + tid; x < nwm; x += kThreads) masks[x] = 0u;
    for (int y = warp; y < mynw; y += kWarps) {
      const int gw = myw0 + y, i = gw * 32 + wl;
      bool acc = false, neg = false;
      float part = 0.f;
      if (i >= a0 && i < a1) {
        const int at = tpos(i - lo, P);
        const float sold = s[at];
        const float de = delta_e(s, u, at);
        const float pr =
            flip_probability<PWL>(de, p.temps[(size_t)t * p.R + r], pwl);
        const unsigned count = ((unsigned)t * p.R + r) * p.S + (i - w);
        const float uv = draw ? uniform_at(key, count) : p.unif[count];
        acc = uv < pr;
        const float af = acc ? 1.f : 0.f;
        part = __fmul_rn(af, de);
        if (acc) {
          s[at] = __fmul_rn(sold, __fsub_rn(1.f, __fmul_rn(2.f, af)));
          neg = sold < 0.f;
        }
      }
      const unsigned accw = __ballot_sync(kFull, acc);
      const unsigned negw = __ballot_sync(kFull, neg);
      for (int o = 16; o > 0; o >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(kFull, part, o));
      const int x = gw - gw0;
      if (wl < C) {  // lane k posts the word to rank k
        unsigned* mb = at_rank(cluster, mail, wl, C);
        mb[(par * 2) * nwm + x] = accw;
        mb[(par * 2 + 1) * nwm + x] = negw;
      }
      if (wl == 0) {
        masks[x] = accw;
        wpartf[warp] = __fadd_rn(wpartf[warp], part);
        wparti[warp] += __popc(accw);
      }
    }
    __syncthreads();
    COLORED_STAMP(1);
    // This rank's partial sums (added in warp order) to every rank.
    if (tid < C) {
      float sum = 0.f;
      int cnt = 0;
      for (int k = 0; k < kWarps; ++k) {
        sum = __fadd_rn(sum, wpartf[k]);
        cnt += wparti[k];
      }
      at_rank(cluster, partf, tid, C)[par * C + q] = sum;
      at_rank(cluster, parti, tid, C)[par * C + q] = cnt;
    }
    group_sync(cluster, C);  // the step's mailboxes are full on every rank
    COLORED_STAMP(2);

    // 2. e, best_e and num_flips from the C partial sums in rank order.
    if (tid == 0) {
      float sum = 0.f;
      int cnt = 0;
      for (int k = 0; k < C; ++k) {
        sum = __fadd_rn(sum, partf[par * C + k]);
        cnt += parti[par * C + k];
      }
      e = __fadd_rn(e, sum);
      nf += cnt;
      const bool better = e < be;
      if (better) be = e;
      sh_better = better;
    }
    // 3. The accepted slots, compacted in ascending slot order: thread tid
    // owns words [tid*per, (tid+1)*per).
    const unsigned* macc = mail + (par * 2) * nwm;
    const unsigned* msgn = mail + (par * 2 + 1) * nwm;
    const int per = (nwords + kThreads - 1) / kThreads;
    const int xlo = min(nwords, tid * per), xhi = min(nwords, xlo + per);
    int mine = 0;
    for (int x = xlo; x < xhi; ++x) mine += __popc(macc[x]);
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (wl >= o) incl += v;
    }
    if (wl == 31) sh_scan[warp] = incl;
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int k = 0; k < kWarps; ++k) {
        const int v = sh_scan[k];
        sh_scan[k] = run;
        run += v;
      }
      sh_nacc = run;
    }
    __syncthreads();
    {
      int at = sh_scan[warp] + incl - mine;
      for (int x = xlo; x < xhi; ++x) {
        const unsigned sg = msgn[x];
        for (unsigned any = macc[x]; any; any &= any - 1) {
          const int b = __ffs(any) - 1;
          const int slot = (gw0 + x) * 32 + b - a0;
          list[at++] = (unsigned)slot | (((sg >> b) & 1u) << 16);
        }
      }
    }
    __syncthreads();
    COLORED_STAMP(3);

    // 4. Apply the list to this rank's slice, then best_s.
    const int nacc = sh_nacc;
    if (nacc > 0) {
      if constexpr (PLANES)
        apply_planes(p, list, nacc, a0, lo, nc, u, P);
      else
        apply_dense(p, list, nacc, a0, lo, nc, u, P, ring);
    }
    COLORED_STAMP(4);
    if (sh_better)
      for (int i = tid; i < nc; i += kThreads) {
        const int at = tpos(i, P);
        bs[at] = s[at];
      }
    COLORED_STAMP(5);
    __syncthreads();
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
  group_sync(cluster, C);
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
  auto kernel = colored_kernel<PWL, PLANES>;
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

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes (the wrapper's size check):
// u, s and best_s of its slice (word-transposed, odd pitch), the PWL
// table, the mailboxes, the partial sums, the list and, on the dense tier,
// the cp.async ring.
size_t snowball_colored_smem_bytes(int N, int S, int segs, int C,
                                   int dense) {
  return smem_layout(N, S, segs, C, dense != 0).total;
}

// T colored steps for R replicas. J != nullptr selects the dense (N, N)
// f32 store; otherwise pos/neg are (B, N, W) uint32 planes. unif != nullptr
// reads the (T, R, S) uniforms; unif == nullptr draws them from
// stream(base, SWEEP, chunk), base = (key0, key1). temps (T, R), sched
// (T, 3) int32 rows (w, offset, size); pwl_in packs icpt[segs],
// slope[segs], z_lo, z_hi, inv_step, or nullptr for the exact sigmoid.
// Each replica runs on a cluster of C <= 16 blocks, each holding
// slice_len(N, C) spins (the last what is left, at least one). masks is a
// (T, R, ceil(S/32)+1) uint32 scratch; arrivals holds R/br int32 counters,
// zero, and is left zero; br (a divisor of R) replicas form one
// rows_fetched group. Returns the launch's CUDA error (0 on success).
int snowball_colored_sweep(const float* J, const unsigned* pos,
                           const unsigned* neg, int B, int W, const float* u0,
                           const float* s0, const float* e0,
                           const float* unif, unsigned key0, unsigned key1,
                           int chunk, const float* temps, const int* sched,
                           const float* pwl_in, int segs, float* u_out,
                           float* s_out, float* e_out, float* be_out,
                           float* bs_out, int* nf_out, int* rf_out,
                           unsigned* masks, int* arrivals, int br, int R,
                           int N, int T, int S, int C, void* stream) {
  const bool planes = J == nullptr;
  if (R <= 0 || N <= 0 || T < 0 || !valid_width(N, S, C) || br < 1 ||
      R % br != 0 || arrivals == nullptr ||
      (pwl_in != nullptr && segs <= 0) ||
      (planes && (pos == nullptr || neg == nullptr || B <= 0 || B > 30 ||
                  W * 32 < N)))
    return (int)cudaErrorInvalidValue;
  const int sg = pwl_in ? segs : 0;
  const size_t smem = smem_layout(N, S, sg, C, !planes).total;
  const ColoredParams p{Store{J, pos, neg, B, W}, u0, s0, e0, unif, key0,
                        key1, chunk, temps, sched, pwl_in, sg, u_out, s_out,
                        e_out, be_out, bs_out, nf_out, rf_out, masks,
                        arrivals, br, R, N, T, S, C};
  cudaStream_t st = (cudaStream_t)stream;
  if (pwl_in) return planes ? launch<true, true>(p, smem, st)
                            : launch<true, false>(p, smem, st);
  return planes ? launch<false, true>(p, smem, st)
                : launch<false, false>(p, smem, st);
}

}  // extern "C"
