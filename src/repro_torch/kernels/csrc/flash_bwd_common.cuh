// What the two flash-attention backward sources (flash_attention_bwd.cu on
// mma.sync, flash_attention_bwd_wgmma.cu on wgmma) share: the shape check
// of their C entries and pass (a), Δ = rowsum(dO ∘ O) in f32 (O as the
// forward wrote it), a warp a row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

constexpr int kDeltaWarps = 8;

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return make_float2(p[0], p[1]);
}

template <typename T>
__global__ void __launch_bounds__(32 * kDeltaWarps)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long rows, int D) {
  const long row = (long)blockIdx.x * kDeltaWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;   // the whole warp
  const T* op = o + row * D;
  const T* gp = dout + row * D;
  float acc = 0.f;
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 a = load_pair(op + d), g = load_pair(gp + d);
    acc = fmaf(a.x, g.x, acc);
    acc = fmaf(a.y, g.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
int launch_delta(const void* o, const void* dout, void* delta, long rows,
                 int D, cudaStream_t stream) {
  const long blocks = (rows + kDeltaWarps - 1) / kDeltaWarps;
  flash_bwd_delta_kernel<T><<<(unsigned)blocks, 32 * kDeltaWarps, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows, D);
  return (int)cudaGetLastError();
}

// The forward's refusals, and a GQA group's rows must count in an int.
inline bool bad_shape(int B, int Hq, int Hkv, int Sq, int Skv, int D) {
  return B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 ||
         D <= 0 || D % 16 || D > 256 || B > 65535 || Hkv > 65535 ||
         (long)(Hq / Hkv) * Sq >= (1L << 31);
}

}  // namespace
