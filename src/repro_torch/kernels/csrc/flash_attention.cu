// Flash-attention forward (causal or bidirectional, GQA-native) for Hopper
// (sm_90a).
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
// This kernel computes in f32 on the CUDA cores, as the TPU kernel's body
// does, so its own ceiling is the f32 rate (67 TFLOP/s): 7.2 ms.
//
// What the design does about it: one block per (batch, KV head, tile of 64
// query rows). The rows are the GQA group's rep query heads at consecutive
// positions, position-major (row = position·rep + head), so the rep heads
// share every K and V tile, which is staged once in shared memory (in f32)
// for all 64 rows. Each of the 256 threads owns a 4×4 tile of the 64×64
// scores (float4 reads of the transposed Q and K tiles) and 4 rows × D/16
// columns of the output accumulator in registers; the row max and sum of
// the online softmax are reduced over the 16 threads of a row with warp
// shuffles, and P goes through shared memory into P·V. The KV loop stops at
// the block's causal frontier (its last position + 1), so the masked
// triangle is skipped but for the diagonal tile; ragged row and key edges
// are masked in the kernel; the heaviest tiles (the latest positions) are
// scheduled first. K and V share one shared-memory buffer, which keeps two
// blocks on an SM at D ≤ 128. No tensor cores, TMA or warp specialisation:
// those, and bf16 operands for the tensor cores, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;     // query rows per block
constexpr int kCols = 64;     // keys per KV tile
constexpr int kThreads = 256;
constexpr int kPad = 4;       // keeps float4 rows aligned and spreads banks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int kv_floats(int d) {
  return d * (kCols + kPad) > kCols * (d + kPad) ? d * (kCols + kPad)
                                                  : kCols * (d + kPad);
}

__host__ __device__ constexpr int smem_floats(int d) {
  return d * (kRows + kPad) + kv_floats(d) + kCols * (kRows + kPad);
}

template <int ND, typename T>
__global__ void __launch_bounds__(kThreads, ND <= 8 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hkv, int rep,
                 int Sq, int Skv, float scale, int causal) {
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
  const T* kb = k + (size_t)(b * Hkv + kvh) * Skv * D;
  const T* vb = v + (size_t)(b * Hkv + kvh) * Skv * D;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int row = idx / D, d = idx % D;
    const long rho = row0 + row;
    float x = 0.f;
    if (rho < rows_total) {
      const int p = (int)(rho / rep), r = (int)(rho % rep);
      x = to_f32(q[((size_t)(b * Hq + kvh * rep + r) * Sq + p) * D + d]) * scale;
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
      KV[d * KS + c] = c0 + c < Skv ? to_f32(kb[(size_t)(c0 + c) * D + d]) : 0.f;
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
      KV[c * VS + d] = c0 + c < Skv ? to_f32(vb[(size_t)(c0 + c) * D + d]) : 0.f;
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
    T* out = o + ((size_t)(b * Hq + kvh * rep + r) * Sq + p) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j) store(&out[tx + 16 * j], acc[i][j] / den);
  }
}

template <int ND, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, float scale, int causal,
           cudaStream_t stream) {
  const int smem = smem_floats(16 * ND) * (int)sizeof(float);
  auto kern = flash_fwd_kernel<ND, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)(Hq / Hkv) * Sq;
  dim3 grid((unsigned)((rows + kRows - 1) / kRows), Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hkv, Hq / Hkv, Sq, Skv,
      scale, causal);
  return (int)cudaGetLastError();
}

template <int ND>
int dispatch(int bf16, const void* q, const void* k, const void* v, void* o,
             int B, int Hq, int Hkv, int Sq, int Skv, float scale, int causal,
             cudaStream_t stream) {
  return bf16 ? launch<ND, __nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                          scale, causal, stream)
              : launch<ND, float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale,
                                  causal, stream);
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out like q; contiguous, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1). D a multiple of 16 up to
// 256, Hq a multiple of Hkv. Returns a cudaError_t (0 on a good launch).
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int B, int Hq,
                                       int Hkv, int Sq, int Skv, int D,
                                       float scale, int causal, int bf16,
                                       void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 ||
      D <= 0 || D % 16 || D > 256 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(ND)                                                     \
  case ND:                                                                 \
    return dispatch<ND>(bf16, q, k, v, o, B, Hq, Hkv, Sq, Skv, scale,      \
                        causal, s);
  switch (D / 16) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
    FLASH_CASE(9) FLASH_CASE(10) FLASH_CASE(11) FLASH_CASE(12)
    FLASH_CASE(13) FLASH_CASE(14) FLASH_CASE(15) FLASH_CASE(16)
  }
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}
