// Flash-attention forward for Hopper (sm_90a) at head dims 64 and 128,
// bf16: flash_attention.cu's bf16 entry on warpgroup matrix products
// (wgmma) fed by TMA, with warp specialisation. Other head dims, and f32,
// stay on flash_attention.cu's entries (kernels/flash_attention.py routes
// by dtype and head dim).
//
// Replaces repro/kernels/flash_attention.py: flash_attention, as
// flash_attention.cu does, and computes what its bf16 entry computes, with
// the same cast points: q and k enter the products as bf16; S = q·kᵀ
// accumulates in f32; the scale is folded with log2 e, p = exp2(S·scale·
// log2 e − m) (one multiply-add), m the running max in the same units over
// key tiles of 64 (D 128) or 128 (D 64) keys; p is rounded to bf16 as the
// A operand of P·V, which accumulates in f32; the row sum l adds the f32 p;
// out = acc / max(l, 1e-30) is written in bf16, rounded to nearest even.
// The causal mask is key <= the row's position, top-left aligned (Sq != Skv
// allowed). Given a non-null lse it writes each row's m + log2 l (log2
// units, the scale folded in; f32, (B, Hq, Sq)), what the backward's
// p = 2^(x − lse) reads; a row that sees no key writes out 0 and lse +inf,
// as the mma.sync kernel does. The running max moves at other points than
// the mma.sync kernel's at D 64, and the max and the sum of a tile's row go
// by halves, so the two differ in the last bits of out and lse; both stay
// within the plain version's bounds.
//
// What bounds it on this card: operations. At qwen2-7b's prefill layer
// (B=4, Hq=28, Hkv=4, S=4096, D=128) the causal forward is 4.8e11 flop,
// 0.49 ms at 989 TFLOP/s bf16, against 268 MB (0.08 ms at 3.35 TB/s).
// flash_attention.cu's mma.sync kernel reaches a quarter of that: mma.sync
// cannot run the tensor cores at their rate on Hopper, and every warp reads
// its K and V fragments from shared memory by ldmatrix. At D 64 the
// exponentials weigh as much as the products: 16 a clock per SM, one per
// score, against 4,096 flop a clock per SM of tensor cores, 128 a score.
// So:
//   * every product is a warpgroup's wgmma (64 rows): S = Q·Kᵀ, m64n64k16
//     (D 128) or m64n128k16 (D 64), with Q in registers (loaded once from
//     its TMA tile by ldmatrix) and K from shared memory, K-major; O += P·V,
//     m64n64k16 per 64 columns of O, with P passed from the S accumulator
//     straight into A registers and V MN-major through the descriptor's
//     transpose flag, so nothing is transposed through shared memory and
//     each product reads only its B operand there;
//   * K and V tiles come by TMA (cp.async.bulk.tensor, 128-byte swizzle, the
//     layout wgmma reads) into a ring of stages (3 at D 128, 4 at D 64),
//     completing on mbarriers: one producer warp keeps them in flight while
//     two consumer warpgroups of 64 rows compute, and setmaxnreg moves the
//     producer's registers to the consumers (24 / 240);
//   * the two consumer warpgroups take turns to issue their products (two
//     named barriers, FlashAttention-3's ping-pong), so one's softmax runs
//     while the other's products hold the tensor cores;
//   * at D 128 a warpgroup also issues the next tile's S = Q·Kᵀ before this
//     tile's P·V, so that its softmax runs while P·V is in flight (FA-3's
//     intra-warpgroup pipelining); at D 64 that order made ptxas serialize
//     the products (C7513) and ran slower on the card than P·V first;
//   * 128-key tiles at D 64 halve the softmax's fixed work a key (the row
//     max's shuffles, the rescale of O, the turns and barrier waits); at
//     D 128 the second S accumulator and P would not fit beside O;
//   * the max and the sum over a tile's row go by halves, not in a chain;
//   * one CTA per (batch, q head, 128 query rows), launched heaviest first
//     (the last rows under causal), so the tail does not idle the SMs; the
//     GQA group's q heads are neighbouring CTAs and share K and V through
//     L2.
// Tiles are boxes of a 3-D tensor map over (heads, positions, D), so rows
// past a head's sequence read as zero; only tiles that cross the diagonal or
// the key edge are masked.
//
// Deterministic: no atomics; each row's sums run in a fixed order and each
// output is written once.
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

constexpr float kInf = __builtin_huge_valf();
constexpr int kBox = 64;                   // rows (and columns) of a box
constexpr int kBoxElems = kBox * kBox;     // bf16 elements of a box
constexpr int kBoxBytes = 2 * kBoxElems;   // 8 KB
constexpr int kThreads = 384;   // the producer warpgroup, then two consumers
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kConsumerWarps = 8;

template <int D>
struct FwdShape {
  static constexpr int kNC = D / 64;           // 64-column boxes of a row
  static constexpr int kN = D == 64 ? 128 : 64;   // keys a tile
  // S of the next tile in flight during this tile's softmax (D 128 only:
  // at D 64 that order makes ptxas serialize the products, C7513).
  static constexpr bool kOverlap = D == 128;
  static constexpr int kRB = kN / 64;          // 64-row boxes of a K/V tile
  static constexpr int kStages = D == 64 ? 4 : 3;   // K and V tiles in flight
  static constexpr int kQBytes = kNC * kBoxBytes;          // 64 rows of Q
  static constexpr int kKvBytes = kRB * kNC * kBoxBytes;   // a K or V tile
  // Q (128 rows), then the stages of K and V.
  static constexpr int kSmem = 1024 + 2 * kQBytes + kStages * 2 * kKvBytes +
                               256;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  const uint32_t a = shared_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// A K or V tile in shared memory: boxes [column box ch][row box rb], so the
// rows of one column box are contiguous (8-row groups 1024 bytes apart).
// k16 step kk of K as the K-major B operand (rows = keys, reduced over D).
template <int RB>
__device__ __forceinline__ uint64_t kmajor_desc(const bf16* t, int kk) {
  return smem_desc(t + (kk >> 2) * RB * kBoxElems + (kk & 3) * 16, 16, 1024);
}
// k16 step kk of V as the MN-major B operand (keys 16·kk.. down the rows,
// columns 64·ch..).
template <int RB>
__device__ __forceinline__ uint64_t mnmajor_desc(const bf16* t, int kk,
                                                 int ch) {
  return smem_desc(t + ch * RB * kBoxElems + kk * 16 * kBox, kBoxBytes, 1024);
}

// The lane's ldmatrix_x4 address for the A fragment of rows 16w..16w+15 and
// k16 step kk of Q's swizzled boxes (chunk c of row r at c ^ (r % 8)).
__device__ __forceinline__ const bf16* swizzled_a_addr(const bf16* t, int w,
                                                       int kk, int lane) {
  const int r = 16 * w + (lane & 15);
  const int c = 2 * (kk & 3) + (lane >> 4);
  return t + (kk >> 2) * kBoxElems + r * kBox + ((c ^ (r & 7)) << 3);
}

// Pins the definitions of a product's register operands before the
// wgmma.fence that issues it: a plain register op the compiler sank past the
// fence would make ptxas serialize the warpgroup's products.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}
// P·V reads the A registers until its wait; this use after the wait keeps
// the next tile's P out of them.
template <int N>
__device__ __forceinline__ void keep_live(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" ::"r"(a[i][r]) : "memory");
}

// S (64 rows × 64 or 128 keys) k16 step of Q·Kᵀ.
__device__ __forceinline__ void wgmma_s(float (&s)[8][4],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int accumulate) {
  wgmma_rs<0>(s, a, desc, accumulate);
}
__device__ __forceinline__ void wgmma_s(float (&s)[16][4],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int accumulate) {
  wgmma_rs_n128<0>(s, a, desc, accumulate);
}

// S = Q·Kᵀ, reduced over D, without its fence.
template <int D, int NS>
__device__ __forceinline__ void wgmma_qk(float (&s)[NS][4],
                                         uint32_t (&qa)[D / 16][4],
                                         const bf16* K) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_s(s, qa[kk], kmajor_desc<NS / 8>(K, kk), kk > 0);
}

// O += P·V (P the bf16 A fragments of KS k16 steps), without its fence.
template <int NC, int KS>
__device__ __forceinline__ void wgmma_pv(float (&o)[NC][8][4],
                                         uint32_t (&pa)[KS][4],
                                         const bf16* V) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int ch = 0; ch < NC; ++ch)
      wgmma_rs<1>(o[ch], pa[kk], mnmajor_desc<KS / 4>(V, kk, ch), 1);
}

// Max (ADD = 0) or sum (ADD = 1) of t[0..2W) by halves.
template <int W, int ADD>
__device__ __forceinline__ float fold(float* t) {
#pragma unroll
  for (int j = 0; j < W; ++j)
    t[j] = ADD ? t[j] + t[j + W] : fmaxf(t[j], t[j + W]);
  if constexpr (W > 1) {
    return fold<W / 2, ADD>(t);
  } else {
    return t[0];
  }
}

// The online softmax of one S tile (keys c0..) for this thread's two rows:
// masks where the tile crosses the diagonal or the key edge, moves the
// running max m (log2 units: the max of S times scale·log2 e, the rounding
// being monotonic), returns each row's correction of the older terms in
// corr (l already corrected), forms p = exp2(S·scale·log2 e − m) with one
// multiply-add, adds p to l and packs p (bf16) into the A fragments of P·V.
// The max and the sum of a row's p go by halves, not in a chain.
template <int NS>
__device__ __forceinline__ void online_softmax(
    float (&s)[NS][4], uint32_t (&pa)[NS / 2][4], float (&m)[2],
    float (&l)[2], float (&corr)[2], const int (&pos)[2], int c0,
    bool masked, int Skv, int causal, float scale_log2, int t4) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * j + 2 * t4 + (e & 1);
        if (col >= Skv || (causal && col > pos[e >> 1])) s[j][e] = -kInf;
      }
  }
  float nbase[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) t[j] = fmaxf(s[j][2 * h], s[j][2 * h + 1]);
    float mx = fold<NS / 2, 0>(t);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * scale_log2);
    const float base = m_new == -kInf ? 0.f : m_new;
    corr[h] = exp2_approx(m[h] - base);
    m[h] = m_new;
    nbase[h] = -base;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = exp2_approx(fmaf(s[j][e], scale_log2, nbase[e >> 1]));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) t[j] = s[j][2 * h] + s[j][2 * h + 1];
    // this thread's part; the quad sums at the end
    l[h] = l[h] * corr[h] + fold<NS / 2, 1>(t);
  }
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) acc_to_a<NS>(pa[kk], s, kk);
}

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, FlashAttention-3's ping-pong), so one's softmax runs
// while the other's products hold the tensor cores.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       bf16* __restrict__ o, float* __restrict__ lse, int B,
                       int Hq, int rep, int Sq, int Skv, float scale_log2,
                       int causal) {
  using S = FwdShape<D>;
  constexpr int NC = S::kNC, kN = S::kN, RB = S::kRB;
  constexpr int NS = kN / 8, KS = kN / 16;   // n8 tiles of S, k16 steps of P
  constexpr int kStages = S::kStages;
  constexpr int kKvElems = S::kKvBytes / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(base);   // [2 halves][NC] boxes
  bf16* Ks = Qs + 2 * NC * kBoxElems;         // [stage][NC][RB]
  bf16* Vs = Ks + kStages * kKvElems;         // [stage][NC][RB]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * kKvElems);
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
  const int n_tiles = (kv_end + kN - 1) / kN;

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
    // Producer: thread 0 loads Q once, then keeps the ring full. A half of
    // Q wholly past the sequence is not loaded (its warpgroup reads none).
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x != 0) return;
    const int halves = r0 + kBox < Sq ? 2 : 1;
    mbar_arrive_expect_tx(q_full, halves * S::kQBytes);
    for (int h = 0; h < halves; ++h)
      for (int ch = 0; ch < NC; ++ch)
        tma_load_3d(Qs + (h * NC + ch) * kBoxElems, &tm_q, q_full, ch * kBox,
                    r0 + h * kBox, plane);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], 2 * S::kKvBytes);
      for (int ch = 0; ch < NC; ++ch)
        for (int r = 0; r < RB; ++r) {
          const int box = s * NC * RB + ch * RB + r;
          tma_load_3d(Ks + box * kBoxElems, &tm_k, &full[s], ch * kBox,
                      it * kN + r * kBox, kv_plane);
          tma_load_3d(Vs + box * kBoxElems, &tm_v, &full[s], ch * kBox,
                      it * kN + r * kBox, kv_plane);
        }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows r0 + 64·cw ..
  regs_alloc<kConsumerRegs>();
  const int cw = wg - 1;
  const int w = (threadIdx.x / 32) & 3, g = lane >> 2, t4 = lane & 3;
  const int q0 = r0 + cw * kBox;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = q0 + 16 * w + g + 8 * h;
  float acc[NC][8][4];
#pragma unroll
  for (int ch = 0; ch < NC; ++ch)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ch][j][e] = 0.f;
  float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f};

  // Both warpgroups run every tile of the CTA (a tile above a warpgroup's
  // diagonal is all masked: it adds 0), so that their turns pair up. A
  // warpgroup wholly past the sequence computes on rows it never stores.
  mbar_wait(q_full, 0);
  uint32_t qa[D / 16][4];
  const bf16* Qw = Qs + cw * NC * kBoxElems;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], swizzled_a_addr(Qw, w, kk, lane));

  auto is_masked = [&](int c0) {
    return c0 + kN > Skv || (causal && c0 + kN - 1 > q0);
  };
  float corr[2];
  uint32_t pa[KS][4];
  if (cw == 1) turn_pass(cw);   // warpgroup 0 goes first
  {
    mbar_wait(&full[0], 0);
    float s[NS][4];
    turn_wait(cw);
    fence_regs<D / 16>(qa);
    fence_acc(s);
    wgmma_fence();
    wgmma_qk<D>(s, qa, Ks);
    wgmma_commit();
    if (!(cw == 1 && n_tiles == 1)) turn_pass(cw);
    wgmma_wait<0>();
    fence_acc(s);
    online_softmax<NS>(s, pa, m, l, corr, pos, 0, is_masked(0), Skv,
                       causal, scale_log2, t4);
  }
  for (int it = 1; it < n_tiles; ++it) {
    const int s_cur = it % kStages, s_prev = (it - 1) % kStages;
    mbar_wait(&full[s_cur], (it / kStages) & 1);
    // S of this tile and P·V of the one before: at D 128 S first, so that
    // this tile's softmax runs while P·V is in flight; at D 64 P·V first.
    float s[NS][4];
    turn_wait(cw);
    fence_regs<D / 16>(qa);
    fence_acc(s);
    fence_regs<KS>(pa);
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) fence_acc(acc[ch]);
    wgmma_fence();
    if constexpr (S::kOverlap) {
      wgmma_qk<D>(s, qa, Ks + s_cur * kKvElems);
      wgmma_commit();
      wgmma_pv<NC, KS>(acc, pa, Vs + s_prev * kKvElems);
      wgmma_commit();
    } else {
      wgmma_pv<NC, KS>(acc, pa, Vs + s_prev * kKvElems);
      wgmma_commit();
      wgmma_qk<D>(s, qa, Ks + s_cur * kKvElems);
      wgmma_commit();
    }
    if (!(cw == 1 && it == n_tiles - 1)) turn_pass(cw);
    wgmma_wait<S::kOverlap ? 1 : 0>();
    fence_acc(s);
    uint32_t pn[KS][4];
    online_softmax<NS>(s, pn, m, l, corr, pos, it * kN, is_masked(it * kN),
                       Skv, causal, scale_log2, t4);
    wgmma_wait<0>();
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) fence_acc(acc[ch]);
    keep_live<KS>(pa);
    release(&empty[s_prev], lane);
#pragma unroll
    for (int ch = 0; ch < NC; ++ch)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ch][j][e] *= corr[e >> 1];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pn[kk][r];
  }
  const int s_last = (n_tiles - 1) % kStages;
  fence_regs<KS>(pa);
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) fence_acc(acc[ch]);
  wgmma_fence();
  wgmma_pv<NC, KS>(acc, pa, Vs + s_last * kKvElems);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) fence_acc(acc[ch]);
  release(&empty[s_last], lane);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (pos[h] >= Sq) continue;
    const size_t row = (size_t)plane * Sq + pos[h];
    if (lse != nullptr && t4 == 0)
      lse[row] = l[h] > 0.f ? m[h] + log2f(l[h]) : kInf;
    bf16* out = o + row * D + 2 * t4;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int ch = 0; ch < NC; ++ch)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + ch * 64 + 8 * j) =
            __floats2bfloat162_rn(acc[ch][j][2 * h] / den,
                                  acc[ch][j][2 * h + 1] / den);
  }
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                     float scale, int causal, cudaStream_t stream) {
  using S = FwdShape<D>;
  auto kern = flash_fwd_wgmma_kernel<D>;
  // First: a runtime call makes the runtime's context current on this
  // thread (autograd runs the remat recompute on a thread of its own),
  // which cuTensorMapEncodeTiled needs.
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err) return err;
  CUtensorMap tq, tk, tv;
  if (!bf16_rows_map(&tq, q, D, Sq, B * Hq) ||
      !bf16_rows_map(&tk, k, D, Skv, B * Hkv) ||
      !bf16_rows_map(&tv, v, D, Skv, B * Hkv))
    return (int)cudaErrorNotSupported;
  const long blocks = (long)((Sq + 2 * kBox - 1) / (2 * kBox)) * B * Hq;
  kern<<<(unsigned)blocks, kThreads, S::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), B, Hq,
      Hq / Hkv, Sq, Skv, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// flash_attention.cu's flash_attention_forward_bf16 at D = 64 or 128, with
// its arguments: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out like q,
// contiguous bf16, each base 16-byte aligned; lse null or f32 (B, Hq, Sq).
// Returns a cudaError_t (0 on a good launch): cudaErrorInvalidValue for
// another D or a shape it refuses, cudaErrorNotSupported where
// cuTensorMapEncodeTiled is missing or refuses a map.
extern "C" int flash_attention_forward_bf16_wgmma(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, float scale, int causal,
    void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Skv, D) || (D != 64 && D != 128) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 64 ? launch_fwd_wgmma<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                        scale, causal, s)
                 : launch_fwd_wgmma<128>(q, k, v, o, lse, B, Hq, Hkv, Sq,
                                         Skv, scale, causal, s);
}
