// GEMM with a row-RMS-statistic epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mm_rstat_kernel`
// (versecrafter_tpu/kernels/matmul_stat.py:52, launched by
// `_linear_rstat_pallas` :76, pl.pallas_call :101):
//   y  = bf16(x @ W + bias)             fp32 accumulation, bias added in fp32,
//                                       one rounding
//   rs = rsqrt(mean(y^2, row) + eps)    from the ROUNDED y, fp32 [M, 1]
// x bf16 [M, K] row-major, W bf16 [K, N] row-major (the [in, out] layout),
// bias fp32 [N] or null.
//
// What bounds it on an H100: at the q/k projection of a 480x832x81 CFG-2
// step (M = 65,520, K = N = 1536) it does 2*M*K*N = 3.09e11 FLOP against
// 0.41 GB of I/O, so it is tensor-core bound (~0.31 ms at 989 TFLOP/s).
//
// Design: the statistic needs the whole 1536-wide output row, which no
// tile holds, so the work is split in two passes with no atomics (results
// repeat bit for bit). Pass 1 is a plain tiled GEMM: one CTA per 128 x 128
// output tile, 8 warps of 64 x 32, mma.sync m16n8k16 bf16 with fp32
// accumulators, x and W tiles 32 deep in a 3-stage cp.async ring (W through
// ldmatrix.trans, rows padded so fragment loads are bank-conflict free).
// Its epilogue adds the bias, rounds to bf16, stores y, and writes the
// square-sum of the rounded values over the tile's 128 columns to an fp32
// [M, N/128] buffer, reduced across the quad by shuffles and across the
// four column warps through shared memory, each in a fixed order. Pass 2
// sums each row's N/128 partials in column order and takes the statistic.
// Rows past M load zeros and store nothing. No wgmma/TMA yet: that, and a
// persistent schedule, is the headroom left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;  // CTA tile (the wrapper checks K, N)
constexpr int WM = 64, WN = 32;             // warp tile
constexpr int WARPS_N = BN / WN;            // 4
constexpr int NTHREADS = 32 * (BM / WM) * WARPS_N;  // 256
constexpr int MT = WM / 16, NT = WN / 8;    // mma tiles per warp: 4 x 4
constexpr int STAGES = 3;
constexpr int LDA = BK + 8;                 // padded rows, in bf16 elements
constexpr int LDB = BN + 8;
constexpr int A_STAGE = BM * LDA, B_STAGE = BK * LDB;
constexpr size_t SMEM_BYTES =
    size_t(STAGES) * (A_STAGE + B_STAGE) * sizeof(__nv_bfloat16) +
    size_t(WARPS_N) * BM * sizeof(float);   // + the epilogue's row sums

__global__ void __launch_bounds__(NTHREADS, 2)
gemm_rstat_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                  float* __restrict__ part, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;
  float* red = reinterpret_cast<float*>(Bs + STAGES * B_STAGE);  // [WARPS_N][BM]

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int grp = lane >> 2, tig = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const int ktiles = K / BK;

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * BK;
    __nv_bfloat16* as = As + stage * A_STAGE;
    __nv_bfloat16* bs = Bs + stage * B_STAGE;
    for (int idx = tid; idx < BM * (BK / 8); idx += NTHREADS) {
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      const int row = m0 + r;
      const bool valid = row < M;
      cp_async16(as + r * LDA + c, x + size_t(valid ? row : 0) * K + k0 + c, valid);
    }
    for (int idx = tid; idx < BK * (BN / 8); idx += NTHREADS) {
      const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
      cp_async16(bs + r * LDB + c, w + size_t(k0 + r) * N + n0 + c, true);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  // per-lane ldmatrix offsets: x (A operand) and W (B operand, transposed)
  const int a_off = (warp_m * WM + (mat & 1) * 8 + mrow) * LDA + (mat >> 1) * 8;
  const int b_off = ((mat & 1) * 8 + mrow) * LDB + warp_n * WN + (mat >> 1) * 8;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt visible; every warp is done with stage (kt-1)
    if (kt + STAGES - 1 < ktiles) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* as = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(as + a_off + mt * 16 * LDA + kk * 16, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(bs + b_off + kk * 16 * LDB + jp * 16, b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * jp], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
          mma_bf16(acc[mt][2 * jp + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b2, b3);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: + bias in fp32, one rounding, store; square-sum of the
  // rounded values per row over this warp's 32 columns, in column order
  float bcol[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + warp_n * WN + j * 8 + tig * 2;
    bcol[j][0] = bias != nullptr ? bias[col] : 0.f;
    bcol[j][1] = bias != nullptr ? bias[col + 1] : 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lrow = warp_m * WM + mt * 16 + grp + 8 * r;
      const int row = m0 + lrow;
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t packed = pack_bf16(acc[mt][j][2 * r] + bcol[j][0],
                                          acc[mt][j][2 * r + 1] + bcol[j][1]);
        if (row < M)
          *reinterpret_cast<uint32_t*>(y + size_t(row) * N + n0 + warp_n * WN + j * 8 + tig * 2) = packed;
        const float2 yr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
        ss += yr.x * yr.x;
        ss += yr.y * yr.y;
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if (tig == 0) red[warp_n * BM + lrow] = ss;
    }
  }
  __syncthreads();
  if (tid < BM && m0 + tid < M) {
    float ss = 0.f;
#pragma unroll
    for (int wn = 0; wn < WARPS_N; ++wn) ss += red[wn * BM + tid];
    part[size_t(m0 + tid) * (N / BN) + blockIdx.x] = ss;
  }
}

// rs[m] = rsqrt(sum of the row's partials in column order / N + eps)
__global__ void row_stat_kernel(const float* __restrict__ part, float* __restrict__ rs,
                                int M, int tiles, int N, float eps) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float ss = 0.f;
  for (int t = 0; t < tiles; ++t) ss += part[size_t(m) * tiles + t];
  rs[m] = 1.f / sqrtf(ss / float(N) + eps);
}

}  // namespace

// Plain C entry for ctypes. Device pointers; bias may be null; part is an
// fp32 [M, N/128] scratch buffer. K must be a multiple of 32 and N of 128
// (the wrapper checks). Returns the cudaError_t of the launches (0 = ok).
extern "C" int vc_linear_rstat(const void* x, const void* w, const void* bias,
                               void* y, void* part, void* rs, int M, int N, int K,
                               float eps, void* stream) {
  if (M <= 0 || K % BK != 0 || N % BN != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(gemm_rstat_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_rstat_kernel<<<grid, NTHREADS, SMEM_BYTES, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(part), M, N, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  row_stat_kernel<<<(M + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                  static_cast<float*>(rs), M, N / BN, N,
                                                  eps);
  return int(cudaGetLastError());
}
