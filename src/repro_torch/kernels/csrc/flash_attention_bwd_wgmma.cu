// Flash-attention backward for Hopper (sm_90a) at head dims 64 and 128,
// bf16: the VJP of flash_attention.cu's bf16 forward on warpgroup matrix
// products (wgmma) fed by TMA, with warp specialisation. One C entry, three
// kernels: Δ (flash_bwd_common.cuh), dK/dV, dQ. Other head dims, and f32,
// stay on flash_attention_bwd.cu's entries (kernels/flash_attention.py
// routes by dtype and head dim).
//
// Replaces repro/kernels/flash_attention.py: _flash_bwd, as
// flash_attention_bwd.cu does, and computes the same function with the
// same cast points: q, k, v and dO enter the products as bf16; S and dP
// accumulate in f32; P = 2^(S·scale·log2 e − lse) from the forward's saved
// lse; P is rounded to bf16 as the operand of dV += Pᵀ·dO; dS = P ∘ (dP − Δ)
// in f32 is rounded to bf16 as the operand of dK += dSᵀ·Q and dQ += dS·K,
// which accumulate in f32; the scale multiplies the f32 dK and dQ at the
// end; dq, dk, dv are written in bf16, rounded to nearest even. The causal
// mask is the forward's (key <= the row's position, top-left aligned).
//
// What bounds it on this card: operations. The five products over the kept
// pairs are 2.5× the forward's flop, at granite-moe's (2, 16/8, 4096, 64)
// 1.72e11 flop, 0.174 ms at 989 TFLOP/s bf16, against 101 MB (0.030 ms at
// 3.35 TB/s). The design below runs seven products (S and dP in both
// passes). mma.sync, which flash_attention_bwd.cu uses, cannot reach the
// tensor cores' rate on Hopper, and there every warp read the whole Q and dO
// tile from shared memory by ldmatrix. So:
//   * every product is a wgmma.m64n64k16 of a warpgroup (64 rows), its B
//     operand (and its A where not in registers) read from shared memory
//     once per warpgroup, not once per warp;
//   * tiles come by TMA (cp.async.bulk.tensor, 128-byte swizzle, the layout
//     wgmma reads) into a ring of 3 stages, completing on mbarriers: one
//     producer warp keeps them in flight while two consumer warpgroups
//     compute, and setmaxnreg moves the producer's registers to the
//     consumers (24 / 240);
//   * Pᵀ and dSᵀ (dK/dV) and dS (dQ) pass from the accumulators straight
//     into the A registers of the next products; the second products use B
//     MN-major through the descriptor's transpose flag, so nothing is
//     transposed through shared memory;
//   * within a warpgroup the elementwise work of one product overlaps the
//     next product in flight (P while dP runs, dS while dV runs);
//   * causal blocks are launched heaviest first, so the tail does not idle
//     the SMs.
//
// Deterministic: no atomics; each output is written once, and each sum runs
// in a fixed order.
//   dK/dV: one CTA per (batch, KV head, 128 keys), heaviest (first keys)
//     first. Each consumer warpgroup owns 64 keys, their K and V (loaded
//     once) and their dK and dV (64 × D, f32) in registers. The walk runs
//     over the query tiles (64 positions of one q head) from the causal
//     frontier on, position-major and then the rep q heads in order, so the
//     GQA group's sums meet in the registers: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ (A and
//     B from shared memory, K-major), then dV += Pᵀ·dO, dK += dSᵀ·Q (A from
//     registers, B MN-major). A warpgroup skips the product of a tile that
//     lies wholly above its keys' diagonal.
//   dQ: one CTA per (batch, q head, 128 rows), heaviest (last rows) first;
//     each consumer warpgroup owns 64 rows, their Q and dO (loaded once) and
//     their dQ in registers, over a ring of K and V tiles of 64 keys up to
//     the frontier: S = Q·Kᵀ, dP = dO·Vᵀ, then dQ += dS·K (K MN-major).
// Tiles are boxes of a 3-D tensor map over (heads, positions, D), so rows
// past a head's sequence read as zero; only tiles that cross the diagonal or
// a sequence edge are masked.
//
// Built without -fmad=false, as the other flash sources.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_bwd_common.cuh"
#include "flash_mma.cuh"
#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBox = 64;                   // rows (and columns) of a box
constexpr int kBoxElems = kBox * kBox;     // bf16 elements of a box
constexpr int kBoxBytes = 2 * kBoxElems;   // 8 KB
constexpr int kStages = 3;
constexpr int kThreads = 384;   // the producer warpgroup, then two consumers
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kConsumerWarps = 8;

template <int D>
struct WgShape {
  static constexpr int kNC = D / 64;   // 64-column halves of a row
  static constexpr int kPair = 2 * kNC * kBoxBytes;   // two 64-row tiles
  // dK/dV: K, V (128 keys), stages of Q, dO (64 rows), their lse and Δ.
  static constexpr int kKvLds = 2 * kPair;
  static constexpr int kKvSmem =
      1024 + kKvLds + kStages * kPair + kStages * 2 * kBox * 4 + 256;
  // dQ: Q, dO (128 rows), stages of K, V (64 keys).
  static constexpr int kQSmem = 1024 + 2 * kPair + kStages * kPair + 256;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  const uint32_t a = shared_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// k16 step kk of a K-major operand: rows of the tile set `t` (kNC boxes of
// 64 rows × 64 columns), reduced over the columns.
__device__ __forceinline__ uint64_t kmajor_desc(const bf16* t, int kk) {
  return smem_desc(t + (kk >> 2) * kBoxElems + (kk & 3) * 16, 16, 1024);
}
// k16 step kk of an MN-major operand: rows 16·kk.. of box `ch` (columns
// 64·ch..), reduced over the rows.
__device__ __forceinline__ uint64_t mnmajor_desc(const bf16* t, int kk,
                                                 int ch) {
  return smem_desc(t + ch * kBoxElems + kk * 16 * kBox, kBoxBytes, 1024);
}

__device__ __forceinline__ void zero(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int B, int Hkv, int rep, int Sq, int Skv,
                            float scale, float scale_log2, int causal) {
  using S = WgShape<D>;
  constexpr int NC = S::kNC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(base);          // [2][NC] boxes
  bf16* Vs = Ks + 2 * NC * kBoxElems;                // [2][NC]
  bf16* Qs = Vs + 2 * NC * kBoxElems;                // [stage][NC]
  bf16* Gs = Qs + kStages * NC * kBoxElems;          // dO, [stage][NC]
  float* Ls = reinterpret_cast<float*>(Gs + kStages * NC * kBoxElems);
  float* Ds = Ls + kStages * kBox;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Ds + kStages * kBox);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int groups = B * Hkv;
  const int kb = blockIdx.x / groups, bkv = blockIdx.x % groups;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int c0 = kb * 2 * kBox;
  const int Hq = Hkv * rep;
  const int q_plane0 = b * Hq + kvh * rep;
  // Causal: positions before c0 see none of these keys.
  const int p_begin = causal ? c0 : 0;
  const int n_pos = Sq > p_begin ? (Sq - p_begin + kBox - 1) / kBox : 0;
  const int n_tiles = n_pos * rep;

  if (threadIdx.x == 0) {
    prefetch_map(&tm_q);
    prefetch_map(&tm_do);
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  if (wg == 0) {
    // Producer: warp 0 keeps the ring full.
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * S::kPair);
      for (int rb = 0; rb < 2; ++rb)
        for (int ch = 0; ch < NC; ++ch) {
          tma_load_3d(Ks + (rb * NC + ch) * kBoxElems, &tm_k, kv_full,
                      ch * kBox, c0 + rb * kBox, bkv);
          tma_load_3d(Vs + (rb * NC + ch) * kBoxElems, &tm_v, kv_full,
                      ch * kBox, c0 + rb * kBox, bkv);
        }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      const int p0 = p_begin + (it / rep) * kBox, plane = q_plane0 + it % rep;
      const size_t row0 = (size_t)plane * Sq;
#pragma unroll
      for (int i = lane; i < kBox; i += 32) {
        const bool ok = p0 + i < Sq;
        Ls[s * kBox + i] = ok ? lse[row0 + p0 + i] : 0.f;
        Ds[s * kBox + i] = ok ? delta[row0 + p0 + i] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], S::kPair);
        for (int ch = 0; ch < NC; ++ch) {
          tma_load_3d(Qs + (s * NC + ch) * kBoxElems, &tm_q, &full[s],
                      ch * kBox, p0, plane);
          tma_load_3d(Gs + (s * NC + ch) * kBoxElems, &tm_do, &full[s],
                      ch * kBox, p0, plane);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // Consumers: warpgroup cw owns keys c0 + 64·cw ..
    regs_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int w = (threadIdx.x / 32) & 3, g = lane >> 2, t4 = lane & 3;
    const int k0 = c0 + cw * kBox;
    const bf16* Kw = Ks + cw * NC * kBoxElems;
    const bf16* Vw = Vs + cw * NC * kBoxElems;

    float dka[NC][8][4], dva[NC][8][4];
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      zero(dka[ch]);
      zero(dva[ch]);
    }
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int p0 = p_begin + (it / rep) * kBox;
      mbar_wait(&full[s], (it / kStages) & 1);
      // Skip a tile wholly above this warpgroup's diagonal, or one whose
      // keys are all past the sequence (never stored).
      const bool live = k0 < Skv && !(causal && p0 + kBox - 1 < k0);
      if (live) {
        const bf16* Q = Qs + s * NC * kBoxElems;
        const bf16* G = Gs + s * NC * kBoxElems;
        float st[8][4], dpt[8][4];
        // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ: 64 keys × 64 rows, reduced over D.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0>(st, kmajor_desc(Kw, kk), kmajor_desc(Q, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0>(dpt, kmajor_desc(Vw, kk), kmajor_desc(G, kk), kk > 0);
        wgmma_commit();

        const bool masked = p0 + kBox > Sq || (causal && k0 + kBox - 1 > p0);
        const float* L = Ls + s * kBox;
        const float* Dl = Ds + s * kBox;
        wgmma_wait<1>();
        fence_acc(st);
        // Pᵀ, masked where the tile crosses the diagonal or the edge.
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(L + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(st[j][e] * scale_log2 -
                                  ((e & 1) ? l2.y : l2.x));
            if (masked) {
              const int pos = p0 + 8 * j + 2 * t4 + (e & 1);
              const int key = k0 + 16 * w + g + 8 * (e >> 1);
              if (pos >= Sq || (causal && key > pos)) p = 0.f;
            }
            st[j][e] = p;
          }
        }
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a<8>(pa[kk], st, kk);
        // dV += Pᵀ·dO while dSᵀ is formed.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int ch = 0; ch < NC; ++ch)
            wgmma_rs<1>(dva[ch], pa[kk], mnmajor_desc(G, kk, ch), 1);
        wgmma_commit();

        wgmma_wait<1>();
        fence_acc(dpt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(Dl + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[j][e] = st[j][e] * (dpt[j][e] - ((e & 1) ? d2.y : d2.x));
        }
        uint32_t sa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a<8>(sa[kk], dpt, kk);
        // dK += dSᵀ·Q.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int ch = 0; ch < NC; ++ch)
            wgmma_rs<1>(dka[ch], sa[kk], mnmajor_desc(Q, kk, ch), 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int ch = 0; ch < NC; ++ch) {
          fence_acc(dka[ch]);
          fence_acc(dva[ch]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + 16 * w + g + 8 * h;
      if (key >= Skv) continue;
      const size_t off = ((size_t)bkv * Skv + key) * D + 2 * t4;
#pragma unroll
      for (int ch = 0; ch < NC; ++ch)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = ch * 64 + 8 * j;
          *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
              __floats2bfloat162_rn(dka[ch][j][2 * h] * scale,
                                    dka[ch][j][2 * h + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
              __floats2bfloat162_rn(dva[ch][j][2 * h], dva[ch][j][2 * h + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int B, int Hq, int rep,
                          int Sq, int Skv, float scale, float scale_log2,
                          int causal) {
  using S = WgShape<D>;
  constexpr int NC = S::kNC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(base);   // [2][NC] boxes
  bf16* Gs = Qs + 2 * NC * kBoxElems;         // dO, [2][NC]
  bf16* Ks = Gs + 2 * NC * kBoxElems;         // [stage][NC]
  bf16* Vs = Ks + kStages * NC * kBoxElems;   // [stage][NC]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * NC * kBoxElems);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int planes = B * Hq;
  const int n_rb = (Sq + 2 * kBox - 1) / (2 * kBox);
  const int rb = n_rb - 1 - (int)(blockIdx.x / planes);   // heaviest first
  const int plane = blockIdx.x % planes;
  const int kv_plane = (plane / Hq) * (Hq / rep) + (plane % Hq) / rep;
  const int r0 = rb * 2 * kBox;
  const int last = (r0 + 2 * kBox < Sq ? r0 + 2 * kBox : Sq) - 1;
  const int kv_end = causal ? (last + 1 < Skv ? last + 1 : Skv) : Skv;
  const int n_tiles = (kv_end + kBox - 1) / kBox;

  if (threadIdx.x == 0) {
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  if (wg == 0) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x != 0) return;
    mbar_arrive_expect_tx(q_full, 2 * S::kPair);
    for (int h = 0; h < 2; ++h)
      for (int ch = 0; ch < NC; ++ch) {
        tma_load_3d(Qs + (h * NC + ch) * kBoxElems, &tm_q, q_full, ch * kBox,
                    r0 + h * kBox, plane);
        tma_load_3d(Gs + (h * NC + ch) * kBoxElems, &tm_do, q_full,
                    ch * kBox, r0 + h * kBox, plane);
      }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], S::kPair);
      for (int ch = 0; ch < NC; ++ch) {
        tma_load_3d(Ks + (s * NC + ch) * kBoxElems, &tm_k, &full[s],
                    ch * kBox, it * kBox, kv_plane);
        tma_load_3d(Vs + (s * NC + ch) * kBoxElems, &tm_v, &full[s],
                    ch * kBox, it * kBox, kv_plane);
      }
    }
  } else {
    // Consumers: warpgroup cw owns rows r0 + 64·cw ..
    regs_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int w = (threadIdx.x / 32) & 3, g = lane >> 2, t4 = lane & 3;
    const int q0 = r0 + cw * kBox;
    const bf16* Qw = Qs + cw * NC * kBoxElems;
    const bf16* Gw = Gs + cw * NC * kBoxElems;
    // This thread's two rows. A row past the sequence gets lse = Δ = 0: its
    // q and dO read as zero, it is never stored.
    int pos[2];
    float lr[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pos[h] = q0 + 16 * w + g + 8 * h;
      const bool ok = pos[h] < Sq;
      lr[h] = ok ? lse[(size_t)plane * Sq + pos[h]] : 0.f;
      dl[h] = ok ? delta[(size_t)plane * Sq + pos[h]] : 0.f;
    }
    // This warpgroup's frontier: tiles from it on are wholly masked.
    const int wg_last = (q0 + kBox < Sq ? q0 + kBox : Sq) - 1;
    const int wg_end = q0 >= Sq ? 0
                       : causal ? (wg_last + 1 < Skv ? wg_last + 1 : Skv)
                                : Skv;

    float dqa[NC][8][4];
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) zero(dqa[ch]);
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int c0 = it * kBox;
      mbar_wait(&full[s], (it / kStages) & 1);
      if (c0 < wg_end) {
        const bf16* K = Ks + s * NC * kBoxElems;
        const bf16* V = Vs + s * NC * kBoxElems;
        float sc[8][4], dp[8][4];
        // S = Q·Kᵀ, dP = dO·Vᵀ: 64 rows × 64 keys, reduced over D.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0>(sc, kmajor_desc(Qw, kk), kmajor_desc(K, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0>(dp, kmajor_desc(Gw, kk), kmajor_desc(V, kk), kk > 0);
        wgmma_commit();

        const bool masked = c0 + kBox > Skv || (causal && c0 + kBox - 1 > q0);
        wgmma_wait<1>();
        fence_acc(sc);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(sc[j][e] * scale_log2 - lr[e >> 1]);
            if (masked) {
              const int key = c0 + 8 * j + 2 * t4 + (e & 1);
              if (key >= Skv || (causal && key > pos[e >> 1])) p = 0.f;
            }
            sc[j][e] = p;
          }
        wgmma_wait<0>();
        fence_acc(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[j][e] = sc[j][e] * (dp[j][e] - dl[e >> 1]);
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a<8>(a[kk], sc, kk);
        // dQ += dS·K.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int ch = 0; ch < NC; ++ch)
            wgmma_rs<1>(dqa[ch], a[kk], mnmajor_desc(K, kk, ch), 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int ch = 0; ch < NC; ++ch) fence_acc(dqa[ch]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (pos[h] >= Sq) continue;
      bf16* out = dq + ((size_t)plane * Sq + pos[h]) * D + 2 * t4;
#pragma unroll
      for (int ch = 0; ch < NC; ++ch)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + ch * 64 + 8 * j) =
              __floats2bfloat162_rn(dqa[ch][j][2 * h] * scale,
                                    dqa[ch][j][2 * h + 1] * scale);
    }
  }
}

template <int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* lse, const void* dout,
                     void* dq, void* dk, void* dv, void* delta, int B, int Hq,
                     int Hkv, int Sq, int Skv, float scale, int causal,
                     cudaStream_t stream) {
  using S = WgShape<D>;
  const int rep = Hq / Hkv;
  const float scale_log2 = scale * kLog2e;   // as the forward folds it
  // Δ first: its launch also makes the runtime's context current on this
  // thread (autograd runs the backward on a thread of its own), which
  // cuTensorMapEncodeTiled needs.
  int err = launch_delta<bf16>(o, dout, delta, (long)B * Hq * Sq, D, stream);
  if (err) return err;
  CUtensorMap tq, tk, tv, tg;
  if (!bf16_rows_map(&tq, q, D, Sq, B * Hq) ||
      !bf16_rows_map(&tk, k, D, Skv, B * Hkv) ||
      !bf16_rows_map(&tv, v, D, Skv, B * Hkv) ||
      !bf16_rows_map(&tg, dout, D, Sq, B * Hq))
    return (int)cudaErrorNotSupported;

  auto kv = flash_bwd_dkdv_wgmma_kernel<D>;
  err = (int)cudaFuncSetAttribute(
      kv, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kKvSmem);
  if (err) return err;
  const long kv_blocks = (long)((Skv + 2 * kBox - 1) / (2 * kBox)) * B * Hkv;
  kv<<<(unsigned)kv_blocks, kThreads, S::kKvSmem, stream>>>(
      tq, tk, tv, tg, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, Hkv, rep, Sq, Skv, scale, scale_log2,
      causal);
  err = (int)cudaGetLastError();
  if (err) return err;

  auto kq = flash_bwd_dq_wgmma_kernel<D>;
  err = (int)cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kQSmem);
  if (err) return err;
  const long q_blocks = (long)((Sq + 2 * kBox - 1) / (2 * kBox)) * B * Hq;
  kq<<<(unsigned)q_blocks, kThreads, S::kQSmem, stream>>>(
      tq, tk, tv, tg, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), B, Hq, rep,
      Sq, Skv, scale, scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// The gradients of flash_attention_forward_bf16 at D = 64 or 128: the
// arguments of flash_attention_bwd.cu's flash_attention_backward_bf16 (q,
// out, dout, dq (B, Hq, Sq, D), k, v, dk, dv (B, Hkv, Skv, D), contiguous
// bf16, 16-byte aligned; lse (B, Hq, Sq) f32 as the forward wrote it; delta
// (B, Hq, Sq) f32 scratch). Launches Δ, dK/dV and dQ on `stream`. Returns a
// cudaError_t (0 on good launches): cudaErrorInvalidValue for another D or a
// shape the forward refuses, cudaErrorNotSupported where
// cuTensorMapEncodeTiled is missing or refuses a map.
extern "C" int flash_attention_backward_bf16_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int B, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
    int causal, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Skv, D) || (D != 64 && D != 128) || !lse ||
      !delta ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) %
          16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 64 ? launch_bwd_wgmma<64>(q, k, v, o, lse, dout, dq, dk, dv,
                                        delta, B, Hq, Hkv, Sq, Skv, scale,
                                        causal, s)
                 : launch_bwd_wgmma<128>(q, k, v, o, lse, dout, dq, dk, dv,
                                         delta, B, Hq, Hkv, Sq, Skv, scale,
                                         causal, s);
}
