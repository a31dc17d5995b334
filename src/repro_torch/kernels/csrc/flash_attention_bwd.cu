// Flash-attention backward (causal or bidirectional, GQA-native) for Hopper
// (sm_90a): the VJP of flash_attention.cu's forward. A bf16 entry on the
// tensor cores and an f32 entry on the CUDA cores, each three kernels in one
// C call. The wrapper (kernels/flash_attention.py) sends bf16 at head dims
// 64 and 128 to flash_attention_bwd_wgmma.cu instead, and every other head
// dim here. Pass (a) and the shape check are flash_bwd_common.cuh's.
//
// Replaces repro/kernels/flash_attention.py: _flash_bwd, which recomputes
// the attention through the jnp chunked path and differentiates it; its
// docstring names the Pallas backward it stands in for (streaming KV
// blocks, dq/dk/dv accumulators on chip). This computes the same
// gradients from the forward's saved row log-sum-exp, FlashAttention-2's
// backward.
//
// What bounds it on this card: operations. The five products (S = Q·Kᵀ,
// dP = dO·Vᵀ, dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K) over the kept pairs are
// 2.5× the forward's 4·B·Hq·D·S(S+1)/2 flop (causal): at granite-moe's
// (2, 16/8, 4096, 64) 1.72e11 flop, 0.174 ms at the bf16 tensor-core rate,
// against 101 MB of q, k, v, out, dO, dq, dk, dv, lse and Δ (0.030 ms at
// 3.35 TB/s). This design recomputes S and dP in both passes below, seven
// products where five would do, so it cannot pass 5/7 of that rate.
//
// Deterministic: no atomics. Three passes, each output written once:
//   (a) Δ = rowsum(dO ∘ O) in f32 (O as the forward wrote it), a warp a row;
//   (b) dK, dV: one block per (batch, KV head, 64 keys); each warp owns 16
//       keys and keeps their dK and dV (16 × D, f32) in registers over a
//       loop on the query rows of the GQA group (row = position·rep + head,
//       the forward's order, so the rep heads' sums meet in the registers)
//       from the causal frontier on: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ come out of
//       the tensor cores with keys as rows, so Pᵀ and dSᵀ pass from the
//       accumulators straight into the A fragments of dV += Pᵀ·dO and
//       dK += dSᵀ·Q, whose B operands (dO, Q) are read by ldmatrix.trans.
//       Above D = 128 two warps share a key group, each accumulating half
//       of the columns (registers). Q, dO, lse and Δ of the next 64 (D ≤ 64)
//       or 32 rows load by cp.async while the current ones are used;
//   (c) dQ: one block of 8 warps per (batch, KV head, 128 query rows), laid
//       out as the forward; each warp owns 16 rows and their dQ (16 × D,
//       f32) over a loop on key tiles (64 keys, 32 above D = 128) up to the
//       frontier; the next K and V tiles load while the current ones are
//       used; dS goes from the accumulator into the A fragment of dQ += dS·K
//       (K by ldmatrix.trans).
// Each pass takes P = 2^(S·scale·log2 e − lse) from the saved lse (the
// forward's units, flash_attention.cu's header) and dS = P ∘ (dP − Δ). Only
// tiles that cross the diagonal or a sequence edge are masked; tiles above
// the frontier are skipped. The causal mask is the forward's: key <= the
// row's position (top-left aligned when Sq != Skv).
//
// Cast points of the bf16 entry, those of the forward's tensor-core kernel:
//   * q, k, v and dO enter the products as their bf16 values; S and dP
//     accumulate in f32;
//   * the scale multiplies the f32 S (folded with log2 e);
//   * P (f32) is rounded to bf16 as the operand of dV += Pᵀ·dO;
//   * dS = P ∘ (dP − Δ) in f32 is rounded to bf16 as the operand of
//     dQ += dS·K and dK += dSᵀ·Q, which accumulate in f32; the scale
//     multiplies the f32 dQ and dK at the end;
//   * dq, dk and dv are written in bf16, rounded to nearest even.
// The f32 entry runs the same passes on the CUDA cores, all in f32 (no
// TF32), as the forward's f32 kernel: S = (q·scale)·k, dK = dSᵀ·(q·scale),
// dQ = (dS·K)·scale; 32 keys (dK, dV) or 32 query rows (dQ) a block of 256
// threads, staged through shared memory. It is simple and slow.
//
// Built without -fmad=false, as the forward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_bwd_common.cuh"
#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kInf = __builtin_huge_valf();

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: (b) dK, dV and (c) dQ
// ---------------------------------------------------------------------------

constexpr int kQWarps = 8;
constexpr int kQRows = 16 * kQWarps;   // query rows of a dQ block
constexpr int kQThreads = 32 * kQWarps;

template <int D>
struct BwdShape {
  static constexpr int kStride = D + 8;   // smem row, bf16
  static constexpr int kNC = D / 16;      // 16-column chunks of a row
  // dK/dV: 64 keys a block, 16 a warp; two warps a key group above 128.
  static constexpr int kKeys = 64;
  static constexpr int kSplit = D <= 128 ? 1 : 2;
  static constexpr int kKvThreads = 32 * (kKeys / 16) * kSplit;
  static constexpr int kNCW = (kNC + kSplit - 1) / kSplit;   // chunks a warp
  static constexpr int kRows = D <= 64 ? 64 : 32;            // rows a step
  static constexpr int kKvSmem =
      (2 * kKeys + 4 * kRows) * kStride * 2 + 4 * kRows * 4;
  // dQ: keys a step, as the forward.
  static constexpr int kCols = D <= 128 ? 64 : 32;
  static constexpr int kQSmem = (2 * kQRows + 4 * kCols) * kStride * 2;
};

// Rows [r0, r0 + N) of one head's (S, D) K or V into a padded smem tile;
// rows at or past `limit` are zero.
template <int D, int N, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int limit) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < N * kChunks; idx += THREADS) {
    const int row = idx / kChunks, ch = idx % kChunks;
    const bool ok = r0 + row < limit;
    cp_async16(dst + row * BwdShape<D>::kStride + ch * 8,
               ok ? src + (size_t)(r0 + row) * D + ch * 8 : src, ok);
  }
}

// Rows [rho0, rho0 + N) of a GQA group (row = position·rep + head) of q or
// dO, `src` at the group's first head, into a padded smem tile; rows at or
// past rep·Sq are zero.
template <int D, int N, int THREADS>
__device__ __forceinline__ void load_group_rows(bf16* dst, const bf16* src,
                                                int rho0, int rep, int Sq) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < N * kChunks; idx += THREADS) {
    const int row = idx / kChunks, ch = idx % kChunks;
    const int rho = rho0 + row;
    const bool ok = rho < rep * Sq;
    const bf16* s = src;
    if (ok) s = src + ((size_t)(rho % rep) * Sq + rho / rep) * D + ch * 8;
    cp_async16(dst + row * BwdShape<D>::kStride + ch * 8, s, ok);
  }
}

// The same for one float a row (lse, Δ).
template <int N, int THREADS>
__device__ __forceinline__ void load_group_floats(float* dst,
                                                  const float* src, int rho0,
                                                  int rep, int Sq) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const int rho = rho0 + i;
    const bool ok = rho < rep * Sq;
    cp_async4(dst + i, ok ? src + (size_t)(rho % rep) * Sq + rho / rep : src,
              ok);
  }
}

template <int D>
__global__ void __launch_bounds__(BwdShape<D>::kKvThreads, D <= 64 ? 3 : 1)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Hkv, int rep, int Sq,
                      int Skv, float scale, float scale_log2, int causal) {
  using S = BwdShape<D>;
  constexpr int ST = S::kStride, BC = S::kKeys, BR = S::kRows;
  constexpr int TH = S::kKvThreads;
  constexpr int NR = BR / 8;   // n8 tiles of Sᵀ (query rows)
  constexpr int NCW = S::kNCW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BC * ST;
  bf16* Qs = Vs + BC * ST;       // [2][BR][ST]
  bf16* Gs = Qs + 2 * BR * ST;   // dO, [2][BR][ST]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BR * ST);   // [2][BR]
  float* Ds = Ls + 2 * BR;                                  // [2][BR]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = warp % (BC / 16);
  const int half = S::kSplit == 1 ? 0 : warp / (BC / 16);
  const int c0 = blockIdx.x * BC, kvh = blockIdx.y, b = blockIdx.z;
  const int Hq = Hkv * rep, rows_total = rep * Sq;
  const size_t kv_off = (size_t)(b * Hkv + kvh) * Skv * D;
  const size_t q_off = (size_t)(b * Hq + kvh * rep) * Sq;   // in rows

  load_rows<D, BC, TH>(Ks, k + kv_off, c0, Skv);
  load_rows<D, BC, TH>(Vs, v + kv_off, c0, Skv);
  // Causal: rows before position c0 see none of these keys.
  const long first_row = causal ? (long)c0 * rep : 0;
  const int row_begin =
      first_row < rows_total ? (int)(first_row / BR) * BR : rows_total;
  const int n_steps = (rows_total - row_begin + BR - 1) / BR;

  auto load_step = [&](int step, int buf) {
    const int r0 = row_begin + step * BR;
    load_group_rows<D, BR, TH>(Qs + buf * BR * ST, q + q_off * D, r0, rep, Sq);
    load_group_rows<D, BR, TH>(Gs + buf * BR * ST, dout + q_off * D, r0, rep,
                               Sq);
    load_group_floats<BR, TH>(Ls + buf * BR, lse + q_off, r0, rep, Sq);
    load_group_floats<BR, TH>(Ds + buf * BR, delta + q_off, r0, rep, Sq);
  };
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dka[2 * NCW][4], dva[2 * NCW][4];
#pragma unroll
  for (int n = 0; n < 2 * NCW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    const int r0 = row_begin + step * BR;
    if (step + 1 < n_steps) load_step(step + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();   // this step's rows (and K, V) landed
    const bf16* Q = Qs + buf * BR * ST;
    const bf16* G = Gs + buf * BR * ST;
    const float* L = Ls + buf * BR;
    const float* Dl = Ds + buf * BR;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys × BR rows a warp.
    float st[NR][4], dpt[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldmatrix_x4(ak, a_frag_addr<ST>(Ks, kw * 16, kk * 16, lane));
      ldmatrix_x4(av, a_frag_addr<ST>(Vs, kw * 16, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < NR / 2; ++j) {
        uint32_t bq[4], bg[4];
        ldmatrix_x4(bq, b_frag_addr<ST>(Q, j * 16, kk * 16, lane));
        mma_bf16(st[2 * j], ak, bq[0], bq[1]);
        mma_bf16(st[2 * j + 1], ak, bq[2], bq[3]);
        ldmatrix_x4(bg, b_frag_addr<ST>(G, j * 16, kk * 16, lane));
        mma_bf16(dpt[2 * j], av, bg[0], bg[1]);
        mma_bf16(dpt[2 * j + 1], av, bg[2], bg[3]);
      }
    }

    // Pᵀ and dSᵀ, masked where the tile crosses the diagonal or an edge.
    const bool masked = r0 + BR > rows_total || c0 + BC > Skv ||
                        (causal && c0 + BC - 1 > r0 / rep);
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = j * 8 + 2 * t4 + (e & 1);
        float p = exp2_approx(st[j][e] * scale_log2 - L[rr]);
        if (masked) {
          const int rho = r0 + rr, key = c0 + kw * 16 + g + 8 * (e >> 1);
          if (rho >= rows_total || key >= Skv ||
              (causal && key > rho / rep))
            p = 0.f;
        }
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - Dl[rr]);
      }

    // dV += Pᵀ·dO, dK += dSᵀ·Q over this warp's column chunks.
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t ap[4], as[4];
      acc_to_a<NR>(ap, st, kk);
      acc_to_a<NR>(as, dpt, kk);
#pragma unroll
      for (int n = 0; n < NCW; ++n) {
        const int cn = half * NCW + n;
        if (cn < S::kNC) {
          uint32_t bg[4], bq[4];
          ldmatrix_x4_trans(bg, bt_frag_addr<ST>(G, kk * 16, cn * 16, lane));
          mma_bf16(dva[2 * n], ap, bg[0], bg[1]);
          mma_bf16(dva[2 * n + 1], ap, bg[2], bg[3]);
          ldmatrix_x4_trans(bq, bt_frag_addr<ST>(Q, kk * 16, cn * 16, lane));
          mma_bf16(dka[2 * n], as, bq[0], bq[1]);
          mma_bf16(dka[2 * n + 1], as, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this step's buffer
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = c0 + kw * 16 + g + 8 * h;
    if (key >= Skv) continue;
    bf16* dkp = dk + kv_off + (size_t)key * D + 2 * t4;
    bf16* dvp = dv + kv_off + (size_t)key * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NCW; ++n) {
      const int cn = half * NCW + n;
      if (cn >= S::kNC) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = cn * 16 + u * 8;
        *reinterpret_cast<__nv_bfloat162*>(dkp + col) = __floats2bfloat162_rn(
            dka[2 * n + u][2 * h] * scale, dka[2 * n + u][2 * h + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + col) = __floats2bfloat162_rn(
            dva[2 * n + u][2 * h], dva[2 * n + u][2 * h + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kQThreads, D <= 64 ? 2 : 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Hkv, int rep, int Sq, int Skv, float scale,
                    float scale_log2, int causal) {
  using S = BwdShape<D>;
  constexpr int ST = S::kStride, BC = S::kCols;
  constexpr int NS = BC / 8;   // n8 tiles of S
  constexpr int NO = D / 8;    // n8 tiles of dQ
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + kQRows * ST;   // dO
  bf16* Ks = Gs + kQRows * ST;   // [2][BC][ST]
  bf16* Vs = Ks + 2 * BC * ST;   // [2][BC][ST]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int Hq = Hkv * rep, rows_total = rep * Sq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kQRows;   // heaviest first
  const int row_end =
      row0 + kQRows < rows_total ? row0 + kQRows : rows_total;
  const size_t kv_off = (size_t)(b * Hkv + kvh) * Skv * D;
  const size_t q_off = (size_t)(b * Hq + kvh * rep) * Sq;   // in rows

  load_group_rows<D, kQRows, kQThreads>(Qs, q + q_off * D, row0, rep, Sq);
  load_group_rows<D, kQRows, kQThreads>(Gs, dout + q_off * D, row0, rep, Sq);
  load_rows<D, BC, kQThreads>(Ks, k + kv_off, 0, Skv);
  load_rows<D, BC, kQThreads>(Vs, v + kv_off, 0, Skv);
  cp_async_commit();

  // This thread's two rows: warp·16 + g and + 8. A padding row takes the
  // last real row's position and lse = inf, so its p is 0; it is never
  // stored.
  int pos[2];
  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = row0 + warp * 16 + g + 8 * h;
    const bool ok = rho < rows_total;
    const int rc = ok ? rho : rows_total - 1;
    pos[h] = rc / rep;
    const size_t idx = q_off + (size_t)(rc % rep) * Sq + rc / rep;
    lr[h] = ok ? lse[idx] : kInf;
    dl[h] = ok ? delta[idx] : 0.f;
  }
  const int first = row0 / rep, last = (row_end - 1) / rep;
  const int kv_end = causal ? (last + 1 < Skv ? last + 1 : Skv) : Skv;
  const int n_tiles = (kv_end + BC - 1) / BC;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1, c0 = tile * BC;
    if (tile + 1 < n_tiles) {
      load_rows<D, BC, kQThreads>(Ks + (buf ^ 1) * BC * ST, k + kv_off,
                                  c0 + BC, Skv);
      load_rows<D, BC, kQThreads>(Vs + (buf ^ 1) * BC * ST, v + kv_off,
                                  c0 + BC, Skv);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();   // this tile's K and V (and Q, dO) landed
    const bf16* K = Ks + buf * BC * ST;
    const bf16* V = Vs + buf * BC * ST;

    // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows × BC keys a warp.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      ldmatrix_x4(aq, a_frag_addr<ST>(Qs, warp * 16, kk * 16, lane));
      ldmatrix_x4(ag, a_frag_addr<ST>(Gs, warp * 16, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, b_frag_addr<ST>(K, j * 16, kk * 16, lane));
        mma_bf16(s[2 * j], aq, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
        ldmatrix_x4(bv, b_frag_addr<ST>(V, j * 16, kk * 16, lane));
        mma_bf16(dp[2 * j], ag, bv[0], bv[1]);
        mma_bf16(dp[2 * j + 1], ag, bv[2], bv[3]);
      }
    }

    // dS = P ∘ (dP − Δ), into s.
    const bool masked = c0 + BC > Skv || (causal && c0 + BC - 1 > first);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(s[j][e] * scale_log2 - lr[e >> 1]);
        if (masked) {
          const int col = c0 + j * 8 + 2 * t4 + (e & 1);
          if (col >= Skv || (causal && col > pos[e >> 1])) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }

    // dQ += dS·K.
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t a[4];
      acc_to_a<NS>(a, s, kk);
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, bt_frag_addr<ST>(K, kk * 16, n * 16, lane));
        mma_bf16(acc[2 * n], a, bk[0], bk[1]);
        mma_bf16(acc[2 * n + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();   // every warp is done with this tile's buffer
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = row0 + warp * 16 + g + 8 * h;
    if (rho >= rows_total) continue;
    bf16* out =
        dq + (q_off + (size_t)(rho % rep) * Sq + rho / rep) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

template <int D>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                  const void* lse, const void* dout, void* dq, void* dk,
                  void* dv, void* delta, int B, int Hq, int Hkv, int Sq,
                  int Skv, float scale, int causal, cudaStream_t stream) {
  using S = BwdShape<D>;
  const int rep = Hq / Hkv;
  const float scale_log2 = scale * kLog2e;   // as the forward folds it
  int err = launch_delta<bf16>(o, dout, delta, (long)B * Hq * Sq, D, stream);
  if (err) return err;
  auto kv = flash_bwd_dkdv_kernel<D>;
  err = (int)cudaFuncSetAttribute(
      kv, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kKvSmem);
  if (err) return err;
  dim3 grid_kv((unsigned)((Skv + S::kKeys - 1) / S::kKeys), Hkv, B);
  kv<<<grid_kv, S::kKvThreads, S::kKvSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Hkv, rep, Sq, Skv,
      scale, scale_log2, causal);
  err = (int)cudaGetLastError();
  if (err) return err;
  auto kq = flash_bwd_dq_kernel<D>;
  err = (int)cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kQSmem);
  if (err) return err;
  dim3 grid_q((unsigned)(((long)rep * Sq + kQRows - 1) / kQRows), Hkv, B);
  kq<<<grid_q, kQThreads, S::kQSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Hkv, rep, Sq, Skv, scale, scale_log2, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Tile = 32;   // keys (dK/dV) or query rows (dQ) a block
constexpr int kF32Threads = 256;

// Shared memory: four [32][D + 1] f32 tiles, two [32][33], two [32].
__host__ __device__ constexpr int f32_smem_bytes(int d) {
  return (4 * kF32Tile * (d + 1) + 2 * kF32Tile * (kF32Tile + 1) +
          2 * kF32Tile) * 4;
}

template <int ND>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Hkv, int rep, int Sq, int Skv, float scale,
                          int causal) {
  constexpr int D = 16 * ND, PS = D + 1, T = kF32Tile, TS = T + 1;
  constexpr int NJ = D / 8;   // columns of dK and dV a thread
  extern __shared__ float smf[];
  float* Ks = smf;
  float* Vs = Ks + T * PS;
  float* Qs = Vs + T * PS;   // q·scale
  float* Gs = Qs + T * PS;   // dO
  float* Ps = Gs + T * PS;   // Pᵀ [key][row]
  float* Ss = Ps + T * TS;   // dSᵀ [key][row]
  float* Ls = Ss + T * TS;
  float* Ds = Ls + T;

  const int tid = threadIdx.x, kr = tid >> 3, cg = tid & 7;
  const int c0 = blockIdx.x * T, kvh = blockIdx.y, b = blockIdx.z;
  const int Hq = Hkv * rep, rows_total = rep * Sq;
  const size_t kv_off = (size_t)(b * Hkv + kvh) * Skv * D;
  const size_t q_off = (size_t)(b * Hq + kvh * rep) * Sq;
  for (int idx = tid; idx < T * D; idx += kF32Threads) {
    const int r = idx / D, d = idx % D;
    const bool ok = c0 + r < Skv;
    Ks[r * PS + d] = ok ? k[kv_off + (size_t)(c0 + r) * D + d] : 0.f;
    Vs[r * PS + d] = ok ? v[kv_off + (size_t)(c0 + r) * D + d] : 0.f;
  }
  float dka[NJ], dva[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dka[j] = dva[j] = 0.f;
  const int key = c0 + kr;
  const long first_row = causal ? (long)c0 * rep : 0;

  for (long r0l = first_row; r0l < rows_total; r0l += T) {
    const int r0 = (int)r0l;
    __syncthreads();   // the last step is done with Qs, Gs, Ps, Ss
    for (int idx = tid; idx < T * D; idx += kF32Threads) {
      const int r = idx / D, d = idx % D, rho = r0 + r;
      const bool ok = rho < rows_total;
      const size_t off =
          ok ? (q_off + (size_t)(rho % rep) * Sq + rho / rep) * D + d : 0;
      Qs[r * PS + d] = ok ? q[off] * scale : 0.f;
      Gs[r * PS + d] = ok ? dout[off] : 0.f;
    }
    if (tid < T) {
      const int rho = r0 + tid;
      const bool ok = rho < rows_total;
      const size_t idx = ok ? q_off + (size_t)(rho % rep) * Sq + rho / rep : 0;
      Ls[tid] = ok ? lse[idx] : 0.f;
      Ds[tid] = ok ? delta[idx] : 0.f;
    }
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float kd = Ks[kr * PS + d], vd = Vs[kr * PS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = fmaf(kd, Qs[(cg * 4 + i) * PS + d], s[i]);
        dp[i] = fmaf(vd, Gs[(cg * 4 + i) * PS + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = cg * 4 + i, rho = r0 + rr;
      const bool ok = rho < rows_total && key < Skv &&
                      (!causal || key <= rho / rep);
      const float p = ok ? exp2f(s[i] * kLog2e - Ls[rr]) : 0.f;
      Ps[kr * TS + rr] = p;
      Ss[kr * TS + rr] = p * (dp[i] - Ds[rr]);
    }
    __syncthreads();
    for (int rr = 0; rr < T; ++rr) {
      const float p = Ps[kr * TS + rr], ds = Ss[kr * TS + rr];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dva[j] = fmaf(p, Gs[rr * PS + cg + 8 * j], dva[j]);
        dka[j] = fmaf(ds, Qs[rr * PS + cg + 8 * j], dka[j]);
      }
    }
  }
  if (key < Skv) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[kv_off + (size_t)key * D + cg + 8 * j] = dka[j];
      dv[kv_off + (size_t)key * D + cg + 8 * j] = dva[j];
    }
  }
}

template <int ND>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Hkv, int rep, int Sq,
                        int Skv, float scale, int causal) {
  constexpr int D = 16 * ND, PS = D + 1, T = kF32Tile, TS = T + 1;
  constexpr int NJ = D / 8;   // columns of dQ a thread
  extern __shared__ float smf[];
  float* Qs = smf;           // q·scale
  float* Gs = Qs + T * PS;   // dO
  float* Ks = Gs + T * PS;
  float* Vs = Ks + T * PS;
  float* Ss = Vs + T * PS;   // dS [row][key]

  const int tid = threadIdx.x, qr = tid >> 3, cg = tid & 7;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int Hq = Hkv * rep, rows_total = rep * Sq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * T;   // heaviest first
  const int row_end = row0 + T < rows_total ? row0 + T : rows_total;
  const size_t kv_off = (size_t)(b * Hkv + kvh) * Skv * D;
  const size_t q_off = (size_t)(b * Hq + kvh * rep) * Sq;
  for (int idx = tid; idx < T * D; idx += kF32Threads) {
    const int r = idx / D, d = idx % D, rho = row0 + r;
    const bool ok = rho < rows_total;
    const size_t off =
        ok ? (q_off + (size_t)(rho % rep) * Sq + rho / rep) * D + d : 0;
    Qs[r * PS + d] = ok ? q[off] * scale : 0.f;
    Gs[r * PS + d] = ok ? dout[off] : 0.f;
  }
  const int rho = row0 + qr;
  const bool row_ok = rho < rows_total;
  const size_t ridx =
      row_ok ? q_off + (size_t)(rho % rep) * Sq + rho / rep : 0;
  const int pos = row_ok ? rho / rep : 0;
  const float lr = row_ok ? lse[ridx] : 0.f, dl = row_ok ? delta[ridx] : 0.f;
  const int last = (row_end - 1) / rep;
  const int kv_end = causal ? (last + 1 < Skv ? last + 1 : Skv) : Skv;

  float dqa[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dqa[j] = 0.f;
  for (int c0 = 0; c0 < kv_end; c0 += T) {
    __syncthreads();   // Q, dO landed; the last tile is done with Ks, Ss
    for (int idx = tid; idx < T * D; idx += kF32Threads) {
      const int c = idx / D, d = idx % D;
      const bool ok = c0 + c < Skv;
      Ks[c * PS + d] = ok ? k[kv_off + (size_t)(c0 + c) * D + d] : 0.f;
      Vs[c * PS + d] = ok ? v[kv_off + (size_t)(c0 + c) * D + d] : 0.f;
    }
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[qr * PS + d], gd = Gs[qr * PS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = fmaf(Ks[(cg * 4 + i) * PS + d], qd, s[i]);
        dp[i] = fmaf(Vs[(cg * 4 + i) * PS + d], gd, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = c0 + cg * 4 + i;
      const bool ok = row_ok && col < Skv && (!causal || col <= pos);
      const float p = ok ? exp2f(s[i] * kLog2e - lr) : 0.f;
      Ss[qr * TS + cg * 4 + i] = p * (dp[i] - dl);
    }
    __syncthreads();
    for (int c = 0; c < T; ++c) {
      const float ds = Ss[qr * TS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dqa[j] = fmaf(ds, Ks[c * PS + cg + 8 * j], dqa[j]);
    }
  }
  if (row_ok) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dq[ridx * D + cg + 8 * j] = dqa[j] * scale;
  }
}

template <int ND>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                   const void* lse, const void* dout, void* dq, void* dk,
                   void* dv, void* delta, int B, int Hq, int Hkv, int Sq,
                   int Skv, float scale, int causal, cudaStream_t stream) {
  constexpr int D = 16 * ND;
  constexpr int smem = f32_smem_bytes(D);
  const int rep = Hq / Hkv;
  int err = launch_delta<float>(o, dout, delta, (long)B * Hq * Sq, D, stream);
  if (err) return err;
  auto kv = flash_bwd_dkdv_f32_kernel<ND>;
  err = (int)cudaFuncSetAttribute(
      kv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  dim3 grid_kv((unsigned)((Skv + kF32Tile - 1) / kF32Tile), Hkv, B);
  kv<<<grid_kv, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Hkv, rep, Sq, Skv,
      scale, causal);
  err = (int)cudaGetLastError();
  if (err) return err;
  auto kq = flash_bwd_dq_f32_kernel<ND>;
  err = (int)cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  dim3 grid_q((unsigned)(((long)rep * Sq + kF32Tile - 1) / kF32Tile), Hkv, B);
  kq<<<grid_q, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), Hkv, rep, Sq, Skv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

#define FLASH_DIMS(X)                                                       \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) \
  X(15) X(16)

// The gradients of flash_attention_forward_bf16: q, out, dout and dq (B, Hq,
// Sq, D), k, v, dk and dv (B, Hkv, Skv, D), contiguous bfloat16, each base
// 16-byte aligned; lse (B, Hq, Sq) float32 as the forward wrote it; delta
// (B, Hq, Sq) float32 scratch. Launches (a), (b) and (c) on `stream`.
// Returns a cudaError_t (0 on good launches).
extern "C" int flash_attention_backward_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int B, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
    int causal, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Skv, D) || !lse || !delta ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) %
          16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TC_CASE(ND)                                                       \
  case ND:                                                                \
    return launch_bwd_tc<16 * ND>(q, k, v, o, lse, dout, dq, dk, dv,      \
                                  delta, B, Hq, Hkv, Sq, Skv, scale,      \
                                  causal, s);
  switch (D / 16) { FLASH_DIMS(TC_CASE) }
#undef TC_CASE
  return (int)cudaErrorInvalidValue;
}

// The same for contiguous float32 tensors, on the CUDA cores.
extern "C" int flash_attention_backward_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int B, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
    int causal, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Skv, D) || !lse || !delta)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define F32_CASE(ND)                                                      \
  case ND:                                                                \
    return launch_bwd_f32<ND>(q, k, v, o, lse, dout, dq, dk, dv, delta,   \
                              B, Hq, Hkv, Sq, Skv, scale, causal, s);
  switch (D / 16) { FLASH_DIMS(F32_CASE) }
#undef F32_CASE
  return (int)cudaErrorInvalidValue;
}
