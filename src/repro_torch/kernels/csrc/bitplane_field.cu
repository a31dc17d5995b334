// Local-field initialisation from packed signed bit-planes for Hopper
// (sm_90a):
//   u[r, i] = sum_b 2^b * [(2*popc(pos_b[i] & x_r) - popc(pos_b[i]))
//                          - (2*popc(neg_b[i] & x_r) - popc(neg_b[i]))]
// summed over the W words of row i (paper Eq. 14-16).
//
// Replaces the TPU kernel repro/kernels/bitplane_field.py:
// bitplane_field_init (body _kernel), the popcount init of the fused solve
// on the plane tiers.
//
// What bounds it on this card: the bytes of the planes. At N=16384, B=1,
// W=512 the planes are 64 MiB, read once (about 20 us at 3.35 TB/s); the
// work is R*2*B*N*W AND+popcount+add triples (about 400 M integer ops at
// R=8), a few us at the f32 issue rate and under 10 us even with popcount at
// a quarter of it.
//
// What the design does about it: one warp per output row i. The lanes stride
// over the row's W words, so each plane row is read once, coalesced, and
// reused for a chunk of up to 8 replicas whose spin words sit in shared
// memory (8*W words, 16 KiB at W=512; lane k reads word k, so the reads are
// conflict-free). Per-lane integer sums are reduced with shuffles. Each
// plane's integer contribution is then added in f32 in plane order; the
// values are exact integers, so the result equals the plain version bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;      // output rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRChunk = 8;     // replicas whose spin words share a pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) bitplane_field_kernel(
    const unsigned* __restrict__ pos, const unsigned* __restrict__ neg,
    const unsigned* __restrict__ x, float* __restrict__ out, int B, int N,
    int W, int R) {
  extern __shared__ unsigned xs[];  // kRChunk * W spin words
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  for (int r0 = 0; r0 < R; r0 += kRChunk) {
    const int rc = min(kRChunk, R - r0);
    __syncthreads();
    for (int k = threadIdx.x; k < kRChunk * W; k += kThreads)
      xs[k] = k < rc * W ? x[(size_t)r0 * W + k] : 0u;
    __syncthreads();
    if (i >= N) continue;
    float acc[kRChunk];
#pragma unroll
    for (int rr = 0; rr < kRChunk; ++rr) acc[rr] = 0.f;
    for (int b = 0; b < B; ++b) {
      const unsigned* prow = pos + ((size_t)b * N + i) * W;
      const unsigned* nrow = neg + ((size_t)b * N + i) * W;
      int m = 0;
      int o[kRChunk];
#pragma unroll
      for (int rr = 0; rr < kRChunk; ++rr) o[rr] = 0;
      for (int w = lane; w < W; w += 32) {
        const unsigned p = __ldg(prow + w), q = __ldg(nrow + w);
        m += __popc(p) - __popc(q);
#pragma unroll
        for (int rr = 0; rr < kRChunk; ++rr) {
          const unsigned xv = xs[rr * W + w];
          o[rr] += __popc(p & xv) - __popc(q & xv);
        }
      }
      m = warp_sum(m);
#pragma unroll
      for (int rr = 0; rr < kRChunk; ++rr) {
        const int contrib = 2 * warp_sum(o[rr]) - m;
        acc[rr] = __fadd_rn(acc[rr],
                            __fmul_rn((float)(1 << b), (float)contrib));
      }
    }
    if (lane == 0)
      for (int rr = 0; rr < rc; ++rr) out[(size_t)(r0 + rr) * N + i] = acc[rr];
  }
}

}  // namespace

extern "C" {

// pos/neg (B, N, W) and x (R, W) uint32 words; out (R, N) f32.
// Returns cudaGetLastError() of the launch (0 on success).
int snowball_bitplane_field_init(const unsigned* pos, const unsigned* neg,
                                 const unsigned* x, float* out, int B, int N,
                                 int W, int R, void* stream) {
  if (B <= 0 || B > 30 || N <= 0 || W <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kRChunk * W * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      bitplane_field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kWarps - 1) / kWarps;
  bitplane_field_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      pos, neg, x, out, B, N, W, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
