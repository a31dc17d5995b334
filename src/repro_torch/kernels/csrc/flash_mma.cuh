// What the flash-attention kernels (flash_attention.cu, the forward, and
// flash_attention_bwd.cu, the backward) share: cp.async copies, ldmatrix,
// the bf16 mma.sync.m16n8k16 tile product, the approximate exp2 and bf16
// packing.
//
// mma.sync.m16n8k16 fragments (g = lane / 4, t4 = lane % 4):
//   A (16×16, row-major) a0 (g, 2t4..+1), a1 (g+8, 2t4..), a2 (g, 8+2t4..),
//     a3 (g+8, 8+2t4..), each two bf16;
//   B (16×8, k × n) b0 (k = 2t4..+1, n = g), b1 (k = 8+2t4..+1, n = g);
//   C (16×8, f32) c0, c1 (g, 2t4..+1), c2, c3 (g+8, 2t4..+1).
// So the accumulator of two neighbouring n8 tiles, packed to bf16, is the
// A fragment of one k16 step of the next product. ldmatrix.x4 of a
// row-major [row][k] tile gives an A fragment; of a [n][k] tile two B
// fragment pairs; ldmatrix.x4.trans of a [k][n] tile two B fragment pairs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src must still be a
// mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Every committed group but the newest has landed.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The lane's address for ldmatrix_x4 of the A fragment of rows
// [r0, r0 + 16) and columns [c0, c0 + 16) of a row-major tile.
template <int ST, typename T>
__device__ __forceinline__ const T* a_frag_addr(const T* tile, int r0, int c0,
                                                int lane) {
  return tile + (r0 + (lane & 15)) * ST + c0 + (lane >> 4) * 8;
}
// ... of two B fragment pairs (n8 tiles n0 and n0 + 8; k16 step at k0)
// from a [n][k] tile: r[0], r[1] are n0's b0, b1; r[2], r[3] n0 + 8's.
template <int ST, typename T>
__device__ __forceinline__ const T* b_frag_addr(const T* tile, int n0, int k0,
                                                int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ST + k0 +
         ((lane >> 3) & 1) * 8;
}
// ... of two B fragment pairs from a [k][n] tile, for ldmatrix_x4_trans.
template <int ST, typename T>
__device__ __forceinline__ const T* bt_frag_addr(const T* tile, int k0, int n0,
                                                 int lane) {
  return tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ST + n0 +
         (lane >> 4) * 8;
}

// c (16×8, f32) += a (16×16, bf16, row) · b (16×8, bf16, col).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (about 2 ulp; results below 2^-126
// flush to 0, far under what a bf16 p or the f32 sum l can hold beside the
// row's max term, which is 1).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k16 step kk from an accumulator of n8 tiles.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c[N][4],
                                         int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

}  // namespace
