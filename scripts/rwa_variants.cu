// Measurement variants of kernel A's RWA step, built by
// scripts/rwa_variants.py from src/repro_torch/kernels/csrc/sweep_rwa.cu
// with -I on that directory. Never part of the solve.
//
// -DSNOWBALL_RWA_THREADS=n  the kernel at n threads a block;
// -DRWA_STAMPS              thread 0 of each block of replica 0 adds the
//                           SM clocks of each phase of every step into
//                           g_stamp[rank][phase] (read back by
//                           rwa_read_stamps);
// -DRWA_TEST_WAIT           the mbarrier waits spin on test_wait in place
//                           of try_wait.
// Every build also exports snowball_rwa_floor: the latency floor of a step,
// the kernel's two exchanges (a 4-byte sum into every rank, the 16-byte
// decision from the rank holding the step's site) and its row read (row j
// added into u), with no flip probability, sum or descent; and
// snowball_rwa_floor_bulk, the same on planes with the rank's words of row
// j brought into shared memory by one cp.async.bulk per sign in place of
// the warps' loads (bitplane_hbm: its rows are 512-byte aligned).
#include <cstdint>

#ifdef RWA_STAMPS
// Clocks accumulate in shared memory (a few cycles a stamp) and reach
// g_stamp once, after the last step.
__device__ unsigned long long g_stamp[16][8];
__device__ int g_sink;
__shared__ long long s_acc[8];
__shared__ long long s_prev;
#define RWA_STAMPER (blockIdx.x < (unsigned)p.width && threadIdx.x == 0)
#define RWA_STAMP(k)                                                   \
  do {                                                                 \
    if (RWA_STAMPER) {                                                 \
      const long long now = clock64();                                 \
      if ((k) == 0 && t == 0)                                          \
        for (int i_ = 0; i_ < 8; ++i_) s_acc[i_] = 0;                  \
      if ((k) > 0) s_acc[(k)] += now - s_prev;                         \
      s_prev = now;                                                    \
      if ((k) == 7 && t == p.T - 1)                                    \
        for (int i_ = 1; i_ < 8; ++i_)                                 \
          g_stamp[blockIdx.x][i_] += s_acc[i_];                        \
    }                                                                  \
  } while (0)
// A use of the row's first value, so the stamp waits for the load.
#define RWA_STAMP_ROWS(x)                                              \
  do {                                                                 \
    if (__float_as_uint(x) == 0x7fc00001u) g_sink = 1;                 \
    if (RWA_STAMPER) {                                                 \
      const long long now = clock64();                                 \
      s_acc[4] += now - s_prev;                                        \
      s_prev = now;                                                    \
    }                                                                  \
  } while (0)
#endif

#ifdef RWA_TEST_WAIT
__device__ __forceinline__ void spin_test_wait(uint64_t* bar,
                                               uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "SPIN:\n"
      "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra SPIN;\n"
      "}\n" ::"r"((uint32_t)__cvta_generic_to_shared(bar)),
      "r"(parity)
      : "memory");
}
#define RWA_WAIT spin_test_wait
#endif

#include "sweep_rwa.cu"

namespace {

template <int STORE, bool BULK>
__global__ void __launch_bounds__(kThreads, 1)
    floor_kernel(const RwaParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = p.width;
  const int q = (int)cluster.block_rank();
  const int r = blockIdx.x / c;
  const int L = p.leaves, S = L * kLeaf, lo = q * S, N = p.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* u4 = reinterpret_cast<float4*>(smem);
  __shared__ float sub[2][kMaxWidth];
  __shared__ Decision dec[2];
  __shared__ __align__(8) uint64_t bar_sum[2];
  __shared__ __align__(8) uint64_t bar_dec[2];
  __shared__ __align__(8) uint64_t bar_row;
  // BULK: the rank's words of row j, pos then neg (S/32 words each).
  unsigned* words = reinterpret_cast<unsigned*>(u4 + S / 4);
  const int w0 = lo / 32;
  const int nw = BULK ? max(0, min(S / 32, p.st.W - w0)) : 0;
  for (int qi = tid; qi < S / 4; qi += kThreads)
    u4[qi] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(&bar_sum[k], 1);
      mbar_init(&bar_dec[k], 1);
    }
    mbar_init(&bar_row, 1);
    fence_barrier_init();
  }
  if (c > 1) cluster.sync(); else __syncthreads();
  const bool aligned = (N & 3) == 0;
  auto post = [&](int b) {
    if (lane < c)
      st_async_b32(cluster_addr(&sub[b][q], lane), 0u,
                   cluster_addr(&bar_sum[b], lane));
  };
  if (p.T > 0 && warp == 0) post(0);
  for (int t = 0; t < p.T; ++t) {
    const int b = t & 1;
    const uint32_t ph = (t >> 1) & 1;
    const int j = (int)(((long long)t * 7919 + (long long)r * 104729) % N);
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&bar_sum[b], 4u * c);
        mbar_arrive_expect_tx(&bar_dec[b], (uint32_t)sizeof(Decision));
      }
      RWA_WAIT(&bar_sum[b], ph);
      if (q == j / S && lane < c)
        st_async_v4(cluster_addr(&dec[b], lane),
                    make_int4(j, 1, __float_as_int(sub[b][0]), 0),
                    cluster_addr(&bar_dec[b], lane));
    }
    RWA_WAIT(&bar_dec[b], ph);
    const int jj = dec[b].j;
    if constexpr (BULK) {
      if (tid == 0) {
        // The block's reads of the last step's words (generic proxy)
        // before the copy's writes (async proxy).
        fence_proxy_async_shared();
        mbar_arrive_expect_tx(&bar_row, 8u * nw);
        const size_t at = (size_t)jj * p.st.W + w0;
        if (nw > 0) {
          cp_async_bulk_1d(words, p.st.pos + at, 4u * nw, &bar_row);
          cp_async_bulk_1d(words + S / 32, p.st.neg + at, 4u * nw, &bar_row);
        }
      }
      mbar_wait(&bar_row, t & 1);
    }
    for (int lf0 = warp; lf0 < L; lf0 += kWarps * kBatch) {
      float4 rows[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        rows[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        const int lf = lf0 + k * kWarps;
        if constexpr (STORE == kDense) {
          if (lf < L)
            rows[k] = dense_quad(p.st.J, N, jj, lo + lf * kLeaf + 4 * lane,
                                 aligned);
        } else if constexpr (BULK) {
          const int w = lf * 4 + (lane >> 3);
          if (lf < L && w < nw) {
            const unsigned pw = words[w], nw_ = words[S / 32 + w];
            rows[k].x = (float)((pw >> ((lane & 7) * 4)) & 1u) -
                        (float)((nw_ >> ((lane & 7) * 4)) & 1u);
          }
        } else {
          const int w = (lo + lf * kLeaf + 4 * lane) >> 5;
          if (lf < L && w < p.st.W) {
            const size_t at = (size_t)jj * p.st.W + w;
            const unsigned pw = __ldg(p.st.pos + at), nw = __ldg(p.st.neg + at);
            rows[k].x = (float)((pw >> ((lane & 7) * 4)) & 1u) -
                        (float)((nw >> ((lane & 7) * 4)) & 1u);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int lf = lf0 + k * kWarps;
        if (lf >= L) break;
        float4 uu = u4[lf * 32 + lane];
        uu.x += rows[k].x; uu.y += rows[k].y;
        uu.z += rows[k].z; uu.w += rows[k].w;
        u4[lf * 32 + lane] = uu;
      }
    }
    __syncthreads();  // BULK: every warp read the words before the next copy
    if (t + 1 < p.T && warp == 0) post(b ^ 1);
  }
  for (int qi = tid; qi < S / 4; qi += kThreads) {
    const float4 uu = u4[qi];
    const int g = lo + 4 * qi;
    if (g < N) p.u_out[(size_t)r * N + g] = uu.x + uu.y + uu.z + uu.w;
  }
  if (c > 1) cluster.sync();
}

template <int STORE, bool BULK>
int launch_floor(const RwaParams& p, cudaStream_t stream) {
  auto kernel = floor_kernel<STORE, BULK>;
  const size_t smem = (size_t)p.leaves * kLeaf * (BULK ? 5 : 4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (p.width > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.R * p.width);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.width;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The floor of T steps for R replicas at `width` blocks a replica, on a
// dense J (pos == nullptr) or plane 0 of (B, N, W) planes; u_out (R, N).
int snowball_rwa_floor(const float* J, const unsigned* pos,
                       const unsigned* neg, int B, int W, int R, int N,
                       int T, int width, float* u_out, void* stream) {
  RwaParams p{};
  p.st = Store{J, pos, neg, B, W};
  p.u_out = u_out;
  p.R = R;
  p.N = N;
  p.T = T;
  p.width = width;
  p.leaves = tree_leaves(N) / width;
  cudaStream_t st = (cudaStream_t)stream;
  return J != nullptr ? launch_floor<kDense, false>(p, st)
                      : launch_floor<kPlanes, false>(p, st);
}

// The same on planes (plane 0), the row's words by cp.async.bulk.
int snowball_rwa_floor_bulk(const unsigned* pos, const unsigned* neg, int B,
                            int W, int R, int N, int T, int width,
                            float* u_out, void* stream) {
  RwaParams p{};
  p.st = Store{nullptr, pos, neg, B, W};
  p.u_out = u_out;
  p.R = R;
  p.N = N;
  p.T = T;
  p.width = width;
  p.leaves = tree_leaves(N) / width;
  if (W % 4 != 0) return (int)cudaErrorInvalidValue;
  return launch_floor<kPlanes, true>(p, (cudaStream_t)stream);
}

int rwa_read_stamps(unsigned long long* out, int clear) {
#ifdef RWA_STAMPS
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
  if (err == cudaSuccess && clear) {
    static const unsigned long long zero[16][8] = {};
    err = cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
  }
  return (int)err;
#else
  (void)out;
  (void)clear;
  return -1;
#endif
}

}  // extern "C"
