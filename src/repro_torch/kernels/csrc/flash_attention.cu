// Flash-attention forward (causal or bidirectional, GQA-native) for Hopper
// (sm_90a): a bf16 kernel on the tensor cores and an f32 kernel on the CUDA
// cores, one C entry each.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py: flash_attention
// (body _kernel): q·scale against K blocks with f32 scores, the causal mask
// row >= col on absolute positions (top-left aligned), an online max and sum
// in f32, P·V accumulated in f32, out = acc / max(l, 1e-30) cast to q's
// dtype with round-to-nearest-even.
//
// What bounds it on this card: operations. At the qwen2-7b prefill layer
// (B=4, Hq=28, Hkv=4, S=4096, D=128) the causal forward is
// 4·B·Hq·D·S(S+1)/2 = 4.8e11 flop against 268 MB of q, k, v and out: 0.49 ms
// at the bf16 tensor-core rate (989 TFLOP/s), 0.08 ms of bytes at 3.35 TB/s.
// A kernel on the CUDA cores cannot go below 7.2 ms there (67 TFLOP/s f32).
//
// bf16 kernel (flash_tc_kernel). The products run on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), fed by ldmatrix from shared
// memory, in the FlashAttention-2 shape. At D 64 and 128 the wrapper sends
// bf16 to flash_attention_wgmma.cu instead (warpgroup wgmma on TMA-fed
// tiles, warp-specialised, about twice as fast on the card); this kernel
// keeps every other D, and those two only when the mma.sync route is forced
// to time it beside the other. Cast points, the only places it departs
// from the TPU kernel's all-f32 body:
//   * q and k enter the tensor cores as their bf16 values (their products
//     are exact) and S = q·kᵀ accumulates in f32;
//   * the scale is applied to S in f32, folded with log2(e) so that
//     p = exp2(S·scale·log2 e − m), m the running max in the same units;
//   * p is rounded to bf16 as the A operand of P·V, which accumulates in
//     f32; the row sum l adds the f32 p (JAX's chunked path rounds p to v's
//     dtype at the same point).
// Design: one block of 8 warps per (batch, KV head, tile of 128 query rows).
// The rows are the GQA group's rep query heads at consecutive positions,
// position-major (row = position·rep + head), so the rep heads share every
// K and V tile, loaded once for all 128 rows. Each warp owns 16 rows: its S
// tile and the output accumulator (16 × D, f32) stay in registers, the row
// max and sum reduce over the 4 threads of a quad with shuffles, and P goes
// from the S accumulator straight into the A fragments of P·V (no round
// trip through shared memory). Q, K and V are copied by cp.async (16 bytes
// a thread, rows padded by 16 bytes so ldmatrix is free of bank conflicts)
// in the order of FlashAttention-2: the V tile loads while S = Q·Kᵀ and the
// softmax run, and the next K tile while P·V runs, with two __syncthreads a
// key tile. The key tile is 64 keys for D ≤ 128 and 32 above (the output
// accumulator takes D/2 registers a thread); for D ≤ 128 two blocks share
// an SM (at most 128 registers a thread, 69,632 B of shared memory at
// D=128), which hides one block's softmax behind the other's products.
// The KV loop stops at the block's causal frontier (its last position + 1);
// only tiles that cross the frontier or the key edge are masked; the
// heaviest tiles (the latest positions) are scheduled first.
//
// f32 kernel (flash_f32_kernel): all of the TPU kernel's arithmetic in f32
// on the CUDA cores (no TF32: its callers hold it to 2e-5). 64 query rows a
// block in the same row order; each of the 256 threads owns a 4×4 score
// tile and 4 rows × D/16 columns of the output; K and V are staged in f32
// through one shared buffer.
//
// The row log-sum-exp for the backward (flash_attention_bwd.cu): given a
// non-null lse, each entry also writes, for every query row, in log2 units
// with the scale folded in,
//   lse = log2 Σ_j 2^(x_j),  x_j = (q·k_j)·scale·log2 e,
// f32, (B, Hq, Sq); the backward's p_j = 2^(x_j − lse). The bf16 kernel
// writes m + log2 l from its running max m and sum l (already in those
// units), the f32 kernel (m + ln l)·log2 e. A null lse writes nothing, and
// out is the same either way.
//
// Built without -fmad=false: the softmax's multiply-adds may contract.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kInf = __builtin_huge_valf();

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 8;
constexpr int kTcRows = 16 * kTcWarps;   // query rows per block
constexpr int kTcThreads = 32 * kTcWarps;

template <int D>
struct TcShape {
  static constexpr int kCols = D <= 128 ? 64 : 32;   // keys per tile
  static constexpr int kStride = D + 8;               // smem row, bf16
  static constexpr int kSmemBytes = (kTcRows + 2 * kCols) * kStride * 2;
};

// Rows [c0, c0 + kCols) of one head's K or V into a padded smem tile; rows
// past Skv are zero (their p is 0, and 0 · garbage could be NaN).
template <int D>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src, int c0,
                                             int Skv) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  constexpr int kCols = TcShape<D>::kCols;
  for (int idx = threadIdx.x; idx < kCols * kChunks; idx += kTcThreads) {
    const int row = idx / kChunks, ch = idx % kChunks;
    const bool ok = c0 + row < Skv;
    cp_async16(dst + row * TcShape<D>::kStride + ch * 8,
               ok ? src + (size_t)(c0 + row) * D + ch * 8 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 128 ? 2 : 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int Hkv, int rep, int Sq, int Skv, float scale_log2,
                int causal) {
  constexpr int kCols = TcShape<D>::kCols;
  constexpr int ST = TcShape<D>::kStride;
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  constexpr int NS = kCols / 8;    // n8 tiles of S
  constexpr int NO = D / 8;        // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTcRows * ST;
  __nv_bfloat16* Vs = Ks + kCols * ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row / column pair
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int Hq = Hkv * rep;
  const long rows_total = (long)rep * Sq;
  const long row0 = (long)(gridDim.x - 1 - blockIdx.x) * kTcRows;
  const long row_end = row0 + kTcRows < rows_total ? row0 + kTcRows
                                                   : rows_total;
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + kvh) * Skv * D;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + kvh) * Skv * D;

  for (int idx = tid; idx < kTcRows * kChunks; idx += kTcThreads) {
    const int row = idx / kChunks, ch = idx % kChunks;
    const long rho = row0 + row;
    const bool ok = rho < rows_total;
    const __nv_bfloat16* src = q;
    if (ok) {
      const int p = (int)(rho / rep), r = (int)(rho % rep);
      src = q + ((size_t)(b * Hq + kvh * rep + r) * Sq + p) * D + ch * 8;
    }
    cp_async16(Qs + row * ST + ch * 8, src, ok);
  }
  cp_async_commit();
  load_kv_tile<D>(Ks, kb, 0, Skv);
  cp_async_commit();

  // This thread's two rows: warp·16 + g and + 8 (padding rows take the
  // last real row's position; they are never stored).
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long rho = row0 + warp * 16 + g + 8 * h;
    pos[h] = (int)((rho < rows_total ? rho : rows_total - 1) / rep);
  }
  const int first = (int)(row0 / rep);
  const int last = (int)((row_end - 1) / rep);
  const int kv_end = causal ? (last + 1 < Skv ? last + 1 : Skv) : Skv;
  const int n_tiles = (kv_end + kCols - 1) / kCols;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * kCols;
    cp_async_wait_all();
    __syncthreads();   // K (and Q) landed; every warp is done with V
    load_kv_tile<D>(Vs, vb, c0, Skv);
    cp_async_commit();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_frag_addr<ST>(Qs, warp * 16, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t bk[4];
        ldmatrix_x4(bk, b_frag_addr<ST>(Ks, j * 16, kk * 16, lane));
        mma_bf16(s[2 * j], a, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // Scale (log2 units), mask, and the online softmax.
    const bool masked =
        c0 + kCols > Skv || (causal && c0 + kCols - 1 > first);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int col = c0 + j * 8 + 2 * t4 + (e & 1);
          if (col >= Skv || (causal && col > pos[e >> 1])) x = -kInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      base[h] = mx[h] == -kInf ? 0.f : mx[h];
      const float corr = exp2_approx(m[h] - base[h]);
      m[h] = mx[h];
      l[h] *= corr;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * h] *= corr;
        acc[n][2 * h + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(s[j][e] - base[e >> 1]);
        l[e >> 1] += s[j][e];   // this thread's part; the quad sums at the end
      }

    cp_async_wait_all();
    __syncthreads();   // V landed; every warp is done with K
    if (tile + 1 < n_tiles) {
      load_kv_tile<D>(Ks, kb, c0 + kCols, Skv);
      cp_async_commit();
    }

    // acc += P V: the S accumulator of n8 tiles 2kk and 2kk+1 is the A
    // fragment of the 16-key step kk.
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      uint32_t a[4];
      acc_to_a<NS>(a, s, kk);
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, bt_frag_addr<ST>(Vs, kk * 16, n * 16, lane));
        mma_bf16(acc[2 * n], a, bv[0], bv[1]);
        mma_bf16(acc[2 * n + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const long rho = row0 + warp * 16 + g + 8 * h;
    if (rho >= rows_total) continue;
    const int p = (int)(rho / rep), r = (int)(rho % rep);
    const size_t row = (size_t)(b * Hq + kvh * rep + r) * Sq + p;
    if (lse != nullptr && t4 == 0)
      lse[row] = l[h] > 0.f ? m[h] + log2f(l[h]) : kInf;
    __nv_bfloat16* out = o + row * D + 2 * t4;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int Hq, int Hkv, int Sq, int Skv, float scale,
              int causal, cudaStream_t stream) {
  constexpr int smem = TcShape<D>::kSmemBytes;
  auto kern = flash_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)(Hq / Hkv) * Sq;
  dim3 grid((unsigned)((rows + kTcRows - 1) / kTcRows), Hkv, B);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Hkv, Hq / Hkv, Sq, Skv,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;     // query rows per block
constexpr int kCols = 64;     // keys per KV tile
constexpr int kThreads = 256;
constexpr int kPad = 4;       // keeps float4 rows aligned and spreads banks

__host__ __device__ constexpr int kv_floats(int d) {
  return d * (kCols + kPad) > kCols * (d + kPad) ? d * (kCols + kPad)
                                                  : kCols * (d + kPad);
}

__host__ __device__ constexpr int smem_floats(int d) {
  return d * (kRows + kPad) + kv_floats(d) + kCols * (kRows + kPad);
}

template <int ND>
__global__ void __launch_bounds__(kThreads, ND <= 8 ? 2 : 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Hkv, int rep, int Sq, int Skv,
                 float scale, int causal) {
  constexpr int D = 16 * ND;
  constexpr int QS = kRows + kPad;   // row stride of Qt and Pt
  constexpr int KS = kCols + kPad;   // row stride of Kt
  constexpr int VS = D + kPad;       // row stride of Vs
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][QS]: q·scale, transposed
  float* KV = Qt + D * QS;                       // Kt [D][KS] or Vs [kCols][VS]
  float* Pt = KV + kv_floats(D);                 // [kCols][QS]: p, transposed

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int Hq = Hkv * rep;
  const long rows_total = (long)rep * Sq;
  const long row0 = (long)(gridDim.x - 1 - blockIdx.x) * kRows;
  const long row_end = row0 + kRows < rows_total ? row0 + kRows : rows_total;
  const float* kb = k + (size_t)(b * Hkv + kvh) * Skv * D;
  const float* vb = v + (size_t)(b * Hkv + kvh) * Skv * D;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int row = idx / D, d = idx % D;
    const long rho = row0 + row;
    float x = 0.f;
    if (rho < rows_total) {
      const int p = (int)(rho / rep), r = (int)(rho % rep);
      x = q[((size_t)(b * Hq + kvh * rep + r) * Sq + p) * D + d] * scale;
    }
    Qt[d * QS + row] = x;
  }

  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    long rho = row0 + ty * 4 + i;
    pos[i] = (int)((rho < rows_total ? rho : rows_total - 1) / rep);
  }
  const int last = (int)((row_end - 1) / rep);
  const int kv_end = causal ? (last + 1 < Skv ? last + 1 : Skv) : Skv;

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < kv_end; c0 += kCols) {
    __syncthreads();   // the last tile's P·V is done with KV and Pt
    for (int idx = tid; idx < kCols * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      KV[d * KS + c] = c0 + c < Skv ? kb[(size_t)(c0 + c) * D + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * QS + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&KV[d * KS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(av[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + tx * 4 + c;
        ok[c] = col < Skv && (!causal || col <= pos[i]);
        s[i][c] = ok[c] ? s[i][c] : kNegInf;
        mt = fmaxf(mt, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        ls += s[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
      const float c1 = expf(m[i] - m_new);
      l[i] = l[i] * c1 + ls;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= c1;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + c) * QS + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();   // every thread is done with Kt; Pt is written

    for (int idx = tid; idx < kCols * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      KV[c * VS + d] = c0 + c < Skv ? vb[(size_t)(c0 + c) * D + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kCols; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[c * QS + ty * 4]);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float vv = KV[c * VS + tx + 16 * j];
        acc[0][j] = fmaf(p.x, vv, acc[0][j]);
        acc[1][j] = fmaf(p.y, vv, acc[1][j]);
        acc[2][j] = fmaf(p.z, vv, acc[2][j]);
        acc[3][j] = fmaf(p.w, vv, acc[3][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long rho = row0 + ty * 4 + i;
    if (rho >= rows_total) continue;
    const int p = (int)(rho / rep), r = (int)(rho % rep);
    const size_t row = (size_t)(b * Hq + kvh * rep + r) * Sq + p;
    if (lse != nullptr && tx == 0)
      lse[row] = l[i] > 0.f ? (m[i] + logf(l[i])) * 1.4426950408889634f
                            : kInf;
    float* out = o + row * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j) out[tx + 16 * j] = acc[i][j] / den;
  }
}

template <int ND>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
               float scale, int causal, cudaStream_t stream) {
  const int smem = smem_floats(16 * ND) * (int)sizeof(float);
  auto kern = flash_f32_kernel<ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)(Hq / Hkv) * Sq;
  dim3 grid((unsigned)((rows + kRows - 1) / kRows), Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Hkv, Hq / Hkv, Sq, Skv, scale, causal);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Hq, int Hkv, int Sq, int Skv, int D) {
  return B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 ||
         D <= 0 || D % 16 || D > 256 || B > 65535 || Hkv > 65535;
}

}  // namespace

#define FLASH_DIMS(X)                                                       \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) \
  X(15) X(16)

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out like q; contiguous
// bfloat16, each base 16-byte aligned. D a multiple of 16 up to 256, Hq a
// multiple of Hkv. lse: null, or float32 (B, Hq, Sq) that receives each
// row's log-sum-exp in log2 units (the header). Returns a cudaError_t (0 on
// a good launch).
extern "C" int flash_attention_forward_bf16(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int B, int Hq, int Hkv, int Sq,
                                            int Skv, int D, float scale,
                                            int causal, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Skv, D) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TC_CASE(ND)                                                        \
  case ND:                                                                 \
    return launch_tc<16 * ND>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, scale, \
                              causal, s);
  switch (D / 16) { FLASH_DIMS(TC_CASE) }
#undef TC_CASE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 kernel's block at head dim D (0 for a
// D it does not take).
extern "C" int flash_attention_bf16_smem_bytes(int D) {
#define SMEM_CASE(ND) \
  case ND:            \
    return TcShape<16 * ND>::kSmemBytes;
  switch (D % 16 || D <= 0 ? 0 : D / 16) { FLASH_DIMS(SMEM_CASE) }
#undef SMEM_CASE
  return 0;
}

// The same for contiguous float32 q, k, v and out, on the CUDA cores.
extern "C" int flash_attention_forward_f32(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int Hq, int Hkv, int Sq,
                                           int Skv, int D, float scale,
                                           int causal, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define F32_CASE(ND)                                                       \
  case ND:                                                                 \
    return launch_f32<ND>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, scale,     \
                          causal, s);
  switch (D / 16) { FLASH_DIMS(F32_CASE) }
#undef F32_CASE
  return (int)cudaErrorInvalidValue;
}
