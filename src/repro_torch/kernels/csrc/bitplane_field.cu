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
// What bounds it on this card: two limits of about the same size. The
// planes' bytes, read once: 2*B*N*W words, 64 MiB at N=16384, B=1, W=512,
// about 20 us at 3.35 TB/s. And the popcounts: POPC issues 16 a clock per
// SM on compute capability 9.0, a quarter of the integer add rate, so
// (R+2)*B*N*W popcounts (83.9 M at R=8, N=16384) take about 20 us at
// 1.98 GHz on 132 SMs. Above R=8 the popcounts bound it alone. The
// select's LOP3 and the sums' IADD3 issue beside them on the integer
// units, so the kernel stays some way above the larger term (PERF.md).
//
// What the design does about it:
// - One popcount per replica and word. For any words p, q and x the sets
//   p & x and q & ~x share no bit, so
//     (2*popc(p&x) - popc(p)) - (2*popc(q&x) - popc(q))
//       = 2*popc((p & x) | (q & ~x)) - popc(p) - popc(q),
//   with no assumption that p and q are disjoint. The select is one LOP3;
//   popc(p) + popc(q) is taken once a word for all replicas: (R+2)
//   popcounts a word instead of 2*(R+1).
// - The planes read once for up to 32 replicas. One warp per row: each
//   lane loads 16 bytes of the pos row and of the neg row at a time (four
//   words, neighbouring lanes on neighbouring words; 4-byte loads where a
//   row or a replica's spin words are not 16-byte aligned), the next
//   vector's loads issued before this one's popcounts, and the replicas
//   loop inside while the words stay in registers, 8 at a time: a group's
//   spin words are loaded together, ahead of its popcounts (a branch per
//   replica would put each load behind its own and serialise them). Above
//   32 replicas the planes are read once per 32: there the popcounts (at
//   least 34 a word) outweigh the bytes more than threefold.
// - No shared memory. The spin words (R*W*4 bytes, 16 KiB at R=8, W=512)
//   are read through L1/L2 by every warp; nothing grows with W, so every
//   W the plane tiers and the colored sweep take fits, and no attribute
//   needs setting before a launch.
// - One reduction per row and plane for all replicas: per lane
//   2*o_r - m, then a transposed butterfly (each shuffle step trades half
//   of a lane's values with its partner), RC - 1 + 5 - log2(RC) shuffles
//   for RC replicas (9 at RC=8) instead of 5 a value.
// - Unchanged arithmetic at the end: each plane's integer contribution is
//   added in f32 in plane order (__fmul_rn, __fadd_rn). The values are
//   exact integers, so the result equals the plain version bitwise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;        // rows per block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = 32;    // replicas per read of the planes
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint4 load_plane(const uint4* p) {
  return __ldcs(p);   // streamed once: evict first
}
__device__ __forceinline__ unsigned load_plane(const unsigned* p) {
  return __ldcs(p);
}
__device__ __forceinline__ void zero(uint4& v) { v = make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ void zero(unsigned& v) { v = 0u; }

__device__ __forceinline__ int popc_sum(uint4 p, uint4 q) {
  return __popc(p.x) + __popc(p.y) + __popc(p.z) + __popc(p.w) +
         __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w);
}
__device__ __forceinline__ int popc_sum(unsigned p, unsigned q) {
  return __popc(p) + __popc(q);
}

// popc((p & x) | (q & ~x)) over the vector's words.
__device__ __forceinline__ int popc_select(uint4 p, uint4 q, uint4 x) {
  return __popc((p.x & x.x) | (q.x & ~x.x)) +
         __popc((p.y & x.y) | (q.y & ~x.y)) +
         __popc((p.z & x.z) | (q.z & ~x.z)) +
         __popc((p.w & x.w) | (q.w & ~x.w));
}
__device__ __forceinline__ int popc_select(unsigned p, unsigned q,
                                           unsigned x) {
  return __popc((p & x) | (q & ~x));
}

// Sums v[k] over the warp's lanes for every k < RC at once. Each step
// halves the values a lane holds: the lower lane of a pair keeps the lower
// half, the upper lane the upper half, and each adds what its partner
// sends. Lane L returns the sum of v[L / (32 / RC)].
template <int RC>
__device__ __forceinline__ int warp_sums(int (&v)[RC], int lane) {
#pragma unroll
  for (int half = RC / 2, off = 16; half >= 1; half >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const int send = upper ? v[k] : v[k + half];
      const int keep = upper ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  int s = v[0];
#pragma unroll
  for (int off = 16 / RC; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// V is uint4 (16-byte loads: W a multiple of 4, every base 16-byte
// aligned) or unsigned; RC replicas a pass, a power of two up to 32.
template <int RC, typename V>
__global__ void __launch_bounds__(kThreads) bitplane_field_kernel(
    const unsigned* __restrict__ pos, const unsigned* __restrict__ neg,
    const unsigned* __restrict__ x, float* __restrict__ out, int B, int N,
    int W, int R) {
  constexpr int kVec = sizeof(V) / sizeof(unsigned);
  constexpr int kGroup = RC < 8 ? RC : 8;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= N) return;   // the whole warp: no shuffle is left waiting
  const int wv = W / kVec;   // vectors per row
  const V* xv = reinterpret_cast<const V*>(x);
  for (int r0 = 0; r0 < R; r0 += RC) {
    const int rc = min(RC, R - r0);
    float acc = 0.f;
    for (int b = 0; b < B; ++b) {
      const V* prow =
          reinterpret_cast<const V*>(pos + ((size_t)b * N + i) * W);
      const V* nrow =
          reinterpret_cast<const V*>(neg + ((size_t)b * N + i) * W);
      int m = 0;
      int o[RC];
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) o[rr] = 0;
      V p, q;
      zero(p);
      zero(q);
      if (lane < wv) {
        p = load_plane(prow + lane);
        q = load_plane(nrow + lane);
      }
      for (int k = lane; k < wv; k += 32) {
        V pn, qn;
        zero(pn);
        zero(qn);
        if (k + 32 < wv) {
          pn = load_plane(prow + k + 32);
          qn = load_plane(nrow + k + 32);
        }
        m += popc_sum(p, q);
        // Replicas in groups of kGroup: the group's spin words are loaded
        // together, ahead of its popcounts (a replica past R loads the
        // last one's words and its sums are never written).
#pragma unroll
        for (int g = 0; g < RC; g += kGroup) {
          if (g < rc) {
            V xg[kGroup];
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
              xg[j] = __ldg(xv + (size_t)(r0 + min(g + j, rc - 1)) * wv + k);
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
              o[g + j] += popc_select(p, q, xg[j]);
          }
        }
        p = pn;
        q = qn;
      }
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) o[rr] = 2 * o[rr] - m;
      const int contrib = warp_sums<RC>(o, lane);
      acc = __fadd_rn(acc, __fmul_rn((float)(1 << b), (float)contrib));
    }
    const int rr = lane / (32 / RC);
    if (lane % (32 / RC) == 0 && rr < rc)
      out[(size_t)(r0 + rr) * N + i] = acc;
  }
}

template <typename V>
cudaError_t launch(int rc, const unsigned* pos, const unsigned* neg,
                   const unsigned* x, float* out, int B, int N, int W, int R,
                   cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
#define SNOWBALL_FIELD_CASE(C)                                          \
  case C:                                                               \
    bitplane_field_kernel<C, V><<<blocks, kThreads, 0, stream>>>(       \
        pos, neg, x, out, B, N, W, R);                                  \
    break;
  switch (rc) {
    SNOWBALL_FIELD_CASE(1)
    SNOWBALL_FIELD_CASE(2)
    SNOWBALL_FIELD_CASE(4)
    SNOWBALL_FIELD_CASE(8)
    SNOWBALL_FIELD_CASE(16)
    SNOWBALL_FIELD_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef SNOWBALL_FIELD_CASE
  return cudaGetLastError();
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
  int rc = 1;   // the least power of two >= min(R, 32)
  while (rc < R && rc < kMaxChunk) rc *= 2;
  const bool vec = W % 4 == 0 &&
                   ((uintptr_t)pos | (uintptr_t)neg | (uintptr_t)x) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec ? launch<uint4>(rc, pos, neg, x, out, B, N, W, R, s)
                   : launch<unsigned>(rc, pos, neg, x, out, B, N, W, R, s));
}

}  // extern "C"
