// Local-field initialisation u[r, i] = sum_k J[i, k] * s[r, k] + h[i] for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/local_field.py: local_field_init
// (body _kernel), the MXU matmul that gives the fused solve its u0.
//
// What bounds it on this card: the bytes of J. At K2000 (R=8, N=2000) the
// product reads 16 MB of J once for 64 MFLOP, 4 flop per byte, far below the
// f32 rate's balance point, so the bound is J over the memory rate (about
// 5 us at 3.35 TB/s). A design that runs one thread per output through a
// serial chain of N dependent adds is bound by latency instead, and one
// with fewer blocks than SMs leaves the memory rate unused.
//
// What the design does about it: a skinny product streamed at the memory
// rate. One warp per row i of J, 16 rows per block (125 blocks at K2000,
// about one per SM; every block copies the spins from L2 once, so fewer,
// larger blocks copy less). The warp reads its row in 1024-column tiles,
// coalesced, 16-byte loads a lane where every row is 16-byte aligned (N a
// multiple of 4) and 4-byte loads otherwise, each lane holding 32 columns
// of the tile in registers so that 128 bytes a lane are in flight; the
// loads are issued before the block stages the matching tile of 8
// replicas' spins in shared memory, so each J element is read from device
// memory once and used for all 8 replicas. Each lane
// sums its columns per replica, the warp reduces the 8 partial sums with
// butterfly shuffles (every lane ends with the same value) and adds h once.
// More than 8 replicas take further blocks in grid.y, 8 at a time. There
// is no TF32 and no tensor core, and every multiply and add rounds on its
// own (-fmad=false).
//
// Exactness: for integer J and h with every partial sum below 2^24 in
// magnitude, f32 sums are exact in any order, so the result equals the
// plain version bitwise. Otherwise each product passes through its
// multiply, at most ceil(N/32) + 4 adds in its lane, 5 shuffle adds and the
// add of h: |u - u_exact| <= (ceil(N/32) + 11) * 2^-24 * (sum_k |J_ik s_rk|
// + |h_i|) to first order (kernels/local_field.py: order_error_bound).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 16;             // rows of J per block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kTileR = 8;              // replicas per block
constexpr int kTileK = 1024;           // columns per tile
constexpr int kPerLane = kTileK / 32;  // tile columns a lane holds
constexpr unsigned kFull = 0xffffffffu;

template <bool kVec>
__global__ void __launch_bounds__(kThreads) local_field_kernel(
    const float* __restrict__ s, const float* __restrict__ J,
    const float* __restrict__ h, float* __restrict__ u, int R, int N) {
  __shared__ __align__(16) float Ss[kTileR][kTileK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  const int r0 = blockIdx.y * kTileR;
  const float* row = J + (size_t)(i < N ? i : 0) * N;
  float acc[kTileR];
#pragma unroll
  for (int r = 0; r < kTileR; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTileK) {
    const int kn = min(kTileK, N - k0);
    // This lane's columns of the tile: 4·lane + 128·q + {0..3} (kVec) or
    // lane + 32·q.
    float jr[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) jr[q] = 0.f;
    if (i < N) {
      if (kVec) {
#pragma unroll
        for (int q = 0; q < kPerLane; q += 4) {
          const int c = 4 * lane + 32 * q;
          if (c < kn) {
            const float4 x =
                __ldg(reinterpret_cast<const float4*>(row + k0 + c));
            jr[q] = x.x;
            jr[q + 1] = x.y;
            jr[q + 2] = x.z;
            jr[q + 3] = x.w;
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int c = lane + 32 * q;
          if (c < kn) jr[q] = __ldg(row + k0 + c);
        }
      }
    }
    __syncthreads();   // every warp is done with the last spin tile
    if (kVec) {
      for (int idx = threadIdx.x; idx < kTileR * kTileK / 4;
           idx += kThreads) {
        const int r = idx / (kTileK / 4), c = 4 * (idx % (kTileK / 4));
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < R && c < kn)
          x = __ldg(reinterpret_cast<const float4*>(
              s + (size_t)(r0 + r) * N + k0 + c));
        *reinterpret_cast<float4*>(&Ss[r][c]) = x;
      }
    } else {
      for (int idx = threadIdx.x; idx < kTileR * kTileK; idx += kThreads) {
        const int r = idx / kTileK, c = idx % kTileK;
        Ss[r][c] = r0 + r < R && c < kn ? s[(size_t)(r0 + r) * N + k0 + c]
                                        : 0.f;
      }
    }
    __syncthreads();
    if (i < N) {
      if (kVec) {
#pragma unroll
        for (int q = 0; q < kPerLane; q += 4) {
          const int c = 4 * lane + 32 * q;
          if (c >= kn) break;
#pragma unroll
          for (int r = 0; r < kTileR; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(&Ss[r][c]);
            acc[r] = __fadd_rn(acc[r], __fmul_rn(jr[q], x.x));
            acc[r] = __fadd_rn(acc[r], __fmul_rn(jr[q + 1], x.y));
            acc[r] = __fadd_rn(acc[r], __fmul_rn(jr[q + 2], x.z));
            acc[r] = __fadd_rn(acc[r], __fmul_rn(jr[q + 3], x.w));
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int c = lane + 32 * q;
          if (c >= kn) break;
#pragma unroll
          for (int r = 0; r < kTileR; ++r)
            acc[r] = __fadd_rn(acc[r], __fmul_rn(jr[q], Ss[r][c]));
        }
      }
    }
  }

  float mine = 0.f;   // lane r keeps replica r's sum
#pragma unroll
  for (int r = 0; r < kTileR; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(kFull, acc[r], off));
    if (lane == r) mine = acc[r];
  }
  if (i < N && lane < kTileR && r0 + lane < R)
    u[(size_t)(r0 + lane) * N + i] = __fadd_rn(mine, h[i]);
}

}  // namespace

// s (R, N), J (N, N), h (N,), u (R, N); contiguous float32. Returns a
// cudaError_t (0 on a good launch).
extern "C" int snowball_local_field_init(const float* s, const float* J,
                                         const float* h, float* u, int R,
                                         int N, void* stream) {
  if (R <= 0 || N <= 0 || (R + kTileR - 1) / kTileR > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + kWarps - 1) / kWarps, (R + kTileR - 1) / kTileR);
  const bool vec = N % 4 == 0 && ((uintptr_t)s | (uintptr_t)J) % 16 == 0;
  if (vec)
    local_field_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        s, J, h, u, R, N);
  else
    local_field_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        s, J, h, u, R, N);
  return (int)cudaGetLastError();
}
