// Local-field initialisation u[r, i] = sum_k J[i, k] * s[r, k] + h[i] for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/local_field.py: local_field_init
// (body _kernel), the MXU matmul that gives the fused solve its u0.
//
// What bounds it on this card: the bytes of J. At K2000 (R=8, N=2000) the
// product reads 16 MB of J once for 64 MFLOP, 4 flop per byte, far below the
// f32 rate's balance point, so the bound is J over the memory rate (about
// 5 us at 3.35 TB/s).
//
// What the design does about it: each block owns 16 rows of J (16 outputs
// per replica) and streams them once through shared memory in 64-wide K
// tiles, together with the matching tile of 8 replicas' spins, so every J
// element is read from device memory once and reused for all 8 replicas.
// Ragged edges (N=2000 is no multiple of the tiles) are masked in the
// loads and the store. There is no TF32 and no tensor core: the sum is
// plain f32 in k order, which for integer J and +-1 spins is exact, so the
// result equals the plain version bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 16;   // outputs (rows of J) per block
constexpr int kTileR = 8;    // replicas per block
constexpr int kTileK = 64;   // K tile staged in shared memory
constexpr int kThreads = kTileN * kTileR;

__global__ void __launch_bounds__(kThreads) local_field_kernel(
    const float* __restrict__ s, const float* __restrict__ J,
    const float* __restrict__ h, float* __restrict__ u, int R, int N) {
  __shared__ float Js[kTileN][kTileK + 1];
  __shared__ float Ss[kTileR][kTileK + 1];
  const int tn = threadIdx.x % kTileN;
  const int tr = threadIdx.x / kTileN;
  const int n0 = blockIdx.x * kTileN;
  const int r0 = blockIdx.y * kTileR;
  float acc = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTileK) {
    for (int idx = threadIdx.x; idx < kTileN * kTileK; idx += kThreads) {
      int row = idx / kTileK, col = idx % kTileK;
      int gr = n0 + row, gc = k0 + col;
      Js[row][col] = (gr < N && gc < N) ? J[(size_t)gr * N + gc] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kTileR * kTileK; idx += kThreads) {
      int row = idx / kTileK, col = idx % kTileK;
      int gr = r0 + row, gc = k0 + col;
      Ss[row][col] = (gr < R && gc < N) ? s[(size_t)gr * N + gc] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kTileK, N - k0);
    for (int k = 0; k < kmax; ++k)
      acc = __fadd_rn(acc, __fmul_rn(Ss[tr][k], Js[tn][k]));
    __syncthreads();
  }
  const int n = n0 + tn, r = r0 + tr;
  if (n < N && r < R) u[(size_t)r * N + n] = __fadd_rn(acc, h[n]);
}

}  // namespace

extern "C" int snowball_local_field_init(const float* s, const float* J,
                                         const float* h, float* u, int R,
                                         int N, void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kTileN - 1) / kTileN, (R + kTileR - 1) / kTileR);
  local_field_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(s, J, h, u,
                                                                  R, N);
  return (int)cudaGetLastError();
}
