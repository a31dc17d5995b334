// Hopper's asynchronous machinery as inline PTX (sm_90a): mbarriers, TMA
// tile loads, stores into a peer block's shared memory that complete on
// its mbarrier (st.async), warpgroup matrix products (wgmma) and register
// hand-over (setmaxnreg), and the host's cuTensorMapEncodeTiled, looked up
// at run time (no -lcuda), and the per-thread copies from global into
// shared memory (cp.async) with their mbarrier arrival. Used by
// flash_attention_wgmma.cu (the forward), flash_attention_bwd_wgmma.cu (the
// backward), sweep_rwa.cu (kernel A's RWA step), sweep_rsa.cu (its RSA
// step) and colored_sweep_hopper.cu (kernel D).
//
// wgmma.m64n64k16 fragments, per warpgroup of 128 threads (w = warp in the
// group, g = lane / 4, t4 = lane % 4):
//   accumulator d[j][e], j = 0..7: row 16w + g + 8(e >> 1), column
//     8j + 2t4 + (e & 1) (the mma.sync C fragment of each n8 tile);
//   A from registers a[0..3]: the mma.sync A fragment of rows 16w..16w+15
//     (flash_mma.cuh), so acc_to_a<8>(a, d, kk) turns an accumulator into
//     the A operand of k16 step kk of the next product.
// wgmma.m64n128k16 (wgmma_rs_n128) has the same fragments with j = 0..15.
// Shared-memory operands are tiles of 64 rows × 64 bf16 (128 bytes a row,
// 8 KB), each 1024-byte aligned and laid out by TMA's 128-byte swizzle
// (16-byte chunk c of row r at chunk c ^ (r % 8)). Their descriptors:
//   K-major (the reduced dim runs along a row): SBO 1024 bytes (the next 8
//     rows); k16 step kk of a tile starts 32·kk bytes in;
//   MN-major (the reduced dim runs down the rows; trans flag 1): SBO 1024
//     bytes (the next 8 reduced rows), LBO the next 64 columns; k16 step kk
//     starts 2048·kk bytes in.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the entry comes at run time
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   shared_u32(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          shared_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(shared_u32(bar)),
      "r"(parity)
      : "memory");
}

// Returns once the phase of parity `parity` has completed, acquiring at
// cluster scope what peers wrote with st.async before completing it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(shared_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// Distributed shared memory: stores into a peer block of the cluster
// ---------------------------------------------------------------------------

// The shared::cluster address of `p` (in this block's shared memory) in
// the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(shared_u32(p)), "r"(rank));
  return out;
}

// Stores 4 bytes at a peer's address and completes them on that peer's
// mbarrier (its transaction count falls by 4); release at cluster scope.
__device__ __forceinline__ void st_async_b32(uint32_t addr, uint32_t v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

// The same for 8 bytes (addr 8-byte aligned).
__device__ __forceinline__ void st_async_v2(uint32_t addr, uint32_t a,
                                            uint32_t b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "r"(a), "r"(b), "r"(bar)
      : "memory");
}

// The same for 16 bytes (addr 16-byte aligned).
__device__ __forceinline__ void st_async_v4(uint32_t addr, int4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// Arrives on a peer's mbarrier (`addr` from cluster_addr), releasing at
// cluster scope what this thread wrote before.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// ---------------------------------------------------------------------------
// Per-thread asynchronous copies from global into shared memory
// ---------------------------------------------------------------------------

// One thread's asynchronous 16-byte (both addresses 16-byte aligned; L2
// only) or 4-byte copy.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_u32(dst)),
               "l"(src)
               : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed;
// the arrival is one of the count the barrier was initialised with.
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   shared_u32(bar))
               : "memory");
}

// One 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into this block's shared memory, completing on
// `bar`'s transaction count.
__device__ __forceinline__ void cp_async_bulk_1d(void* dst, const void* src,
                                                 uint32_t bytes,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(shared_u32(bar))
      : "memory");
}

// Orders the block's earlier generic accesses to shared memory (made
// visible to this thread by a barrier) before this thread's later
// async-proxy writes there (a bulk copy into a slot just read).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(shared_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(shared_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// Register hand-over between warpgroups
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory operand descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = shared_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Orders this thread's register and shared-memory writes before the
// warpgroup's next wgmma reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// At most N committed groups still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The accumulator's registers are not touched until the wait; this keeps
// the compiler from moving their uses across it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

#define WGMMA_ROW(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WGMMA_D32(d)                                                    \
  WGMMA_ROW(d, 0), WGMMA_ROW(d, 1), WGMMA_ROW(d, 2), WGMMA_ROW(d, 3),   \
      WGMMA_ROW(d, 4), WGMMA_ROW(d, 5), WGMMA_ROW(d, 6), WGMMA_ROW(d, 7)
#define WGMMA_D64(d)                                                    \
  WGMMA_D32(d), WGMMA_ROW(d, 8), WGMMA_ROW(d, 9), WGMMA_ROW(d, 10),     \
      WGMMA_ROW(d, 11), WGMMA_ROW(d, 12), WGMMA_ROW(d, 13),             \
      WGMMA_ROW(d, 14), WGMMA_ROW(d, 15)

// d (64×64, f32) = (accumulate ? d : 0) + A·B, A and B from shared memory
// (A K-major; B K-major, or MN-major with TRANS_B).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : WGMMA_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// The same with A (64×16 bf16) from registers.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

// d (64×128, f32; d[j] the n8 tile j = 0..15) = (accumulate ? d : 0) + A·B,
// A (64×16 bf16) from registers, B 128 rows (K-major) or columns (MN-major,
// TRANS_B) from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : WGMMA_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

#undef WGMMA_D64
#undef WGMMA_D32
#undef WGMMA_ROW

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup; null
// where there is none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (planes, rows, D) bf16 tensor, contiguous, as boxes of 64 rows × 64
// columns of one plane, 128-byte swizzled; rows past `rows` read as zero.
inline bool bf16_rows_map(CUtensorMap* map, const void* base, int D, int rows,
                          int planes) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
