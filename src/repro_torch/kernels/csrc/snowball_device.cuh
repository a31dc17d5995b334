// Device functions shared by the sweep kernels (sweep.cu, sweep_rwa.cu,
// sweep_rsa.cu, colored_sweep.cu): the coupling store, the plane-row
// decode, the site of a uniform, the coalesced tier's row count, the flip
// probability, dE, the int8 spin words and the threefry uniforms of a
// sweep chunk.
// The kernels repeat the float operations of kernels/common.py in the same
// order, so they agree bitwise with the plain versions where that is
// claimed; build with -fmad=false (see sweep.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The couplings: a dense (N, N) f32 J (pos == neg == nullptr), or (B, N, W)
// uint32 pos/neg planes (J == nullptr).
struct Store {
  const float* J;
  const unsigned* pos;
  const unsigned* neg;
  int B, W;
};

// Adds plane b's part of a row to row[k], k = 0..31: p and q are the words
// this lane loaded (word w0+lane of the plane's pos and neg row), and a
// shuffle hands word w0+k to every lane, so lane L adds
// 2^b (bit(pos) - bit(neg)) of spin 32*(w0+k) + L.
__device__ __forceinline__ void decode_plane_words(unsigned p, unsigned q,
                                                   float scale,
                                                   float row[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int d = (int)((__shfl_sync(kFull, p, k) >> lane) & 1u) -
                  (int)((__shfl_sync(kFull, q, k) >> lane) & 1u);
    row[k] = __fadd_rn(row[k], __fmul_rn(scale, (float)d));
  }
}

// Plane b's words of row j for this lane (word w0+lane; 0 past N).
__device__ __forceinline__ void load_plane_words(const Store& st, int b, int j,
                                                 int N, int w0, unsigned* p,
                                                 unsigned* q) {
  const int w = w0 + (threadIdx.x & 31);
  const bool valid = w * 32 < N;
  const size_t at = ((size_t)b * N + j) * st.W + w;
  *p = valid ? __ldg(st.pos + at) : 0u;
  *q = valid ? __ldg(st.neg + at) : 0u;
}

// Row j's couplings to the 32 spins of words w0 .. w0+31, decoded in
// registers by one warp: lane L loads word w0+L of each plane and sign (one
// coalesced load per warp), and a shuffle hands word w0+k to every lane, so
// lane L gets J[j, 32*(w0+k) + L] in row[k] — sum_b 2^b (bit(pos_b) -
// bit(neg_b)), added in plane order like common.decode_bitplane_rows.
__device__ __forceinline__ void plane_couplings(const Store& st, int j, int N,
                                                int w0, float row[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) row[k] = 0.f;
  for (int b = 0; b < st.B; ++b) {
    unsigned p, q;
    load_plane_words(st, b, j, N, w0, &p, &q);
    decode_plane_words(p, q, (float)(1 << b), row);
  }
}

__device__ __forceinline__ int site_from_uniform(float u, int n) {
  return min((int)__fmul_rn(u, (float)n), n - 1);
}

// The coalesced tier's count, by the last cluster of a group to finish
// (its `warps` warps): replica r0 + k is charged one row at step t unless
// a lower replica of its group chose the same site
// (common.rows_fetched_step). site_log is the (T, R) log of every
// replica's sites.
__device__ inline void count_group_rows(const int* site_log, int* rf_out,
                                        int R, int T, int group, int r0,
                                        int warps) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int k = warp; k < group; k += warps) {
    int mine = 0;
    for (int t = wl; t < T; t += 32) {
      const int* row = site_log + (size_t)t * R + r0;
      const int j = __ldcg(row + k);
      bool dup = false;
      for (int m = 0; m < k && !dup; ++m) dup = __ldcg(row + m) == j;
      mine += !dup;
    }
    for (int off = 16; off > 0; off >>= 1)
      mine += __shfl_xor_sync(kFull, mine, off);
    if (wl == 0) rf_out[r0 + k] = mine;
  }
}

struct Pwl {
  const float* icpt;   // (S,) in shared memory
  const float* slope;  // (S,) in shared memory
  float z_lo, z_hi, inv_step;
  int segs;
};

// The flip probability at z = -dE/T for T > 0: PWL or the exact sigmoid.
template <bool PWL>
__device__ __forceinline__ float probability_at(float z, const Pwl& pwl) {
  if (PWL) {
    float zc = fminf(fmaxf(z, pwl.z_lo), pwl.z_hi);
    int seg = (int)__fmul_rn(__fsub_rn(zc, pwl.z_lo), pwl.inv_step);
    seg = min(max(seg, 0), pwl.segs - 1);
    return __fmaf_rn(pwl.slope[seg], zc, pwl.icpt[seg]);
  }
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
}

template <bool PWL>
__device__ __forceinline__ float flip_probability(float de, float t,
                                                  const Pwl& pwl) {
  if (!(t > 0.f)) return de < 0.f ? 1.f : (de == 0.f ? 0.5f : 0.f);
  return probability_at<PWL>(__fdiv_rn(-de, t), pwl);
}

__device__ __forceinline__ float delta_e(const float* s, const float* u,
                                         int i) {
  return __fmul_rn(__fmul_rn(2.f, s[i]), u[i]);
}

// flip_probability with the IEEE divide kept off a zero dE: -dE/T is then
// exactly -dE (a signed zero), and a zero dividend would send __fdiv_rn
// down its slow path, as a sparse instance's zero fields do on most steps.
// Bitwise flip_probability.
template <bool PWL>
__device__ __forceinline__ float site_probability(float de, float t,
                                                  const Pwl& pwl) {
  if (!(t > 0.f)) return flip_probability<PWL>(de, t, pwl);
  const float q = __fdiv_rn(de == 0.f ? 1.f : -de, t);
  return probability_at<PWL>(de == 0.f ? -de : q, pwl);
}

// Component m of a float4, and the float4 with it set.
__device__ __forceinline__ float comp(const float4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_comp(float4& v, int m, float x) {
  if (m == 0) v.x = x;
  else if (m == 1) v.y = x;
  else if (m == 2) v.z = x;
  else v.w = x;
}

// Spin m (+-1) of a word of four int8 spins, and the word with it set.
__device__ __forceinline__ float spin(unsigned w, int m) {
  return (float)(signed char)(w >> (8 * m));
}

__device__ __forceinline__ unsigned with_spin(unsigned w, int m, float s) {
  const unsigned byte = (unsigned)(unsigned char)(signed char)s;
  return (w & ~(0xFFu << (8 * m))) | (byte << (8 * m));
}

// Threefry-2x32 (20 rounds) in uint32 arithmetic, bit-equal to
// core/rng.threefry2x32 and so to jax.random's partitionable threefry.
__device__ __forceinline__ void threefry_mix4(unsigned& x1, unsigned& x2,
                                              int a, int b, int c, int d) {
  x1 += x2; x2 = __funnelshift_l(x2, x2, a) ^ x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, b) ^ x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, c) ^ x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, d) ^ x1;
}

__device__ __forceinline__ uint2 threefry2x32(unsigned k1, unsigned k2,
                                              unsigned x1, unsigned x2) {
  const unsigned k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x1 += k1;
  x2 += k2;
  threefry_mix4(x1, x2, 13, 15, 26, 6);
  x1 += k2; x2 += k3 + 1u;
  threefry_mix4(x1, x2, 17, 29, 16, 24);
  x1 += k3; x2 += k1 + 2u;
  threefry_mix4(x1, x2, 13, 15, 26, 6);
  x1 += k1; x2 += k2 + 3u;
  threefry_mix4(x1, x2, 17, 29, 16, 24);
  x1 += k2; x2 += k3 + 4u;
  threefry_mix4(x1, x2, 13, 15, 26, 6);
  x1 += k3; x2 += k1 + 5u;
  return make_uint2(x1, x2);
}

// jax.random.fold_in: the count pair (0, data) hashed under the key.
__device__ __forceinline__ uint2 fold_in(uint2 key, unsigned data) {
  return threefry2x32(key.x, key.y, 0u, data);
}

// The key of a sweep chunk: stream(base, Salt.SWEEP = 7, chunk), or with
// a device fold (fold >= 0) stream(base, SWEEP, fold, chunk), the key of
// one rank's replicas in the replica-parallel solve.
__device__ __forceinline__ uint2 sweep_chunk_key(unsigned base0,
                                                 unsigned base1, int chunk,
                                                 int fold = -1) {
  uint2 key = fold_in(make_uint2(base0, base1), 7u);
  if (fold >= 0) key = fold_in(key, (unsigned)fold);
  return fold_in(key, (unsigned)chunk);
}

// Element `count` of rng.uniform01(key, shape): the bits o1 ^ o2 of the
// count pair (0, count), rounded to f32 and scaled by 2^-32 (exact).
__device__ __forceinline__ float uniform_at(uint2 key, unsigned count) {
  const uint2 o = threefry2x32(key.x, key.y, 0u, count);
  return __fmul_rn(__uint2float_rn(o.x ^ o.y), __int_as_float(0x2F800000));
}

}  // namespace
