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
// Design: one persistent kernel in clusters of two CTAs, one CTA an SM.
// The statistic needs the whole output row, so a work item is a row block
// of BM = 128 rows, and the cluster that takes it sweeps every N tile of the
// row block (BN = 256 columns; a last tile of 128 when N % 256 == 128): CTA
// rank r takes tiles r, r + 2, ... in column order. Each consumer thread
// keeps the square-sum of its rows over its columns in registers across its
// tiles, in a fixed order; after the last tile a quad reduces it by two
// shuffles in a fixed order, rank 1 stores its sums into rank 0's shared
// memory (a two-slot hand-over on mbarriers, arrived on across the
// cluster), and rank 0 adds them to its own and writes rs. No second pass,
// no atomics: reruns are bit-identical. A row block of x (128 x 1536 bf16 =
// 384 KB) does not fit in shared memory, so it is streamed again for each N
// tile; W (4.7 MB at 1536 x 1536) stays in L2. Splitting a row block's tiles
// over the cluster halves the x rows in flight (66 row blocks, 25 MB at K =
// 1536, against 50 MB with one CTA a row block), so x's re-reads hit L2.
//   CTA = one producer warp (the rest of its warpgroup idles) and two
//   consumer warpgroups of 64 rows each; setmaxnreg hands the producer's
//   registers to the consumers (240 / 24). The producer TMA-loads K slices
//   into a ring of STAGES stages with a full and an empty mbarrier each: a
//   stage is the x slice [128 rows, 64] (one 16 KB box, rows past M read as
//   zeros) and the W slice [64, BN] (BN / 64 boxes of [64, 64], 8 KB each),
//   all in the 128-byte swizzle, from tensor maps over the two row-major
//   matrices (make_flat_map).
//   Each consumer warpgroup issues four wgmma m64n256k16 a stage (m64n128k16
//   on a 128-wide tile), A = its 64 x rows K-major and B = the W slice read
//   MN-major (the transposed read of the row-major tile), both from shared
//   memory; one group stays in flight while the next stage is awaited, and
//   a stage is released once the group that read it has landed. No thread
//   writes a stage, so no proxy fence is needed.
//   Epilogue per tile, from the fp32 accumulator (128 registers a thread):
//   + bias in fp32 (the bias row is copied to shared memory once), one
//   rounding to bf16, the square of the rounded values into the row's
//   running sum, and y through 16-byte stores after a transpose inside each
//   quad (store_row); rows past M store nothing. The producer fills the ring
//   for the next tile meanwhile; the tensor cores idle during the epilogue
//   (a second accumulator does not fit beside the 128 registers of this
//   one).
// Work walk: cluster q of the grid's 66 takes row blocks q, q + 66, ...; 512
// row blocks at M = 65,520 is 7.76 rounds (the last round runs 50 of 66
// clusters, 97 % of eight full rounds); tests/test_torch_rstat_geometry.py
// holds a Python copy of the walk.
//
// Measured (scripts/bench_torch_matmul_stat.py on edited copies, NVIDIA
// H100 80GB HBM3, 700.00 W, M = 65,520, K = N = 1536 with bias; PERF.md has
// every reading): one CTA a row block with the bias read from global memory
// in the epilogue 0.568 ms (x read from an L2-resident block instead: 0.435;
// three ring stages: 0.616; 4-byte stores instead of store_row: +20 % on the
// clustered kernel); the bias row in shared memory 0.525 ms; the tiles split
// over a cluster 0.445-0.454 ms, of which the epilogue takes ~0.05 (0.405
// with it stubbed). torch.addmm alone 0.419; the mma.sync kernel this
// replaces 1.235.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int BM = 128;             // rows of a work item (a row block)
constexpr int WG_ROWS = 64;         // of which each consumer warpgroup owns
constexpr int NWG = BM / WG_ROWS;
constexpr int BN = 256;             // columns of an N tile (the last may be 128)
constexpr int BK = 64;              // K depth of a ring stage (the wrapper checks K)
constexpr int STAGES = 4;           // ring depth
constexpr int NTHREADS = 128 * (NWG + 1);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// a stage: the x slice (one [128 rows, 128 bytes] box), then the W slice
// (BN / 64 boxes of [64 rows, 128 bytes])
constexpr uint32_t X_BYTES = BM * SW_ROW_BYTES;
constexpr uint32_t W_BOX_BYTES = BK * SW_ROW_BYTES;
constexpr uint32_t STAGE_BYTES = X_BYTES + (BN / 64) * W_BOX_BYTES;
constexpr uint32_t BAR_OFF = STAGES * STAGE_BYTES;
// the square-sum hand-over between the cluster's two CTAs: full and empty
// barriers of two slots, then fp32 [2 slots][BM rows]
constexpr uint32_t XBAR_OFF = BAR_OFF + 2 * STAGES * sizeof(uint64_t);
constexpr uint32_t XSS_OFF = XBAR_OFF + 4 * sizeof(uint64_t);
constexpr uint32_t BIAS_OFF = XSS_OFF + 2 * BM * sizeof(float);  // fp32 [N]
constexpr int MAX_N = 8192;  // the bias row must fit beside the ring
static_assert(STAGE_BYTES % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
static_assert(BIAS_OFF + MAX_N * sizeof(float) + 1024 <= 232448, "shared memory of a CTA");

constexpr size_t smem_bytes(int N) { return BIAS_OFF + N * sizeof(float) + 1024; }

struct Params {
  const float* bias;   // [N] or null
  __nv_bfloat16* y;    // [M, N]
  float* rs;           // [M]
  int M, N, K, items;  // items: row blocks
  float eps;
};

struct Smem {
  uint32_t ring, full_bar, empty_bar, xbar, xss;
  float* xss_ptr;  // rank 0: the peer's square-sums, [2 slots][BM rows]
  float* bias;     // the bias row (zeros without one), written once by the consumers
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    const uint32_t a = smem_u32(raw);
    const uint32_t pad = ((a + 1023u) & ~1023u) - a;
    ring = a + pad;
    full_bar = ring + BAR_OFF;
    empty_bar = full_bar + 8 * STAGES;
    xbar = ring + XBAR_OFF;
    xss = ring + XSS_OFF;
    xss_ptr = reinterpret_cast<float*>(raw + pad + XSS_OFF);
    bias = reinterpret_cast<float*>(raw + pad + BIAS_OFF);
  }
  __device__ __forceinline__ uint32_t stage(int s) const { return ring + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return full_bar + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return empty_bar + 8 * s; }
  __device__ __forceinline__ uint32_t xfull(int s) const { return xbar + 8 * s; }
  __device__ __forceinline__ uint32_t xempty(int s) const { return xbar + 16 + 8 * s; }
  // one thread, before the cluster-wide barrier that precedes any use
  __device__ __forceinline__ void init_barriers() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NWG);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < 2; ++s) {  // one arrival per quad of the peer's consumers
      mbar_init(xfull(s), 8 * 4 * NWG);
      mbar_init(xempty(s), 8 * 4 * NWG);
    }
    mbar_init_fence();
  }
};

// ---- the cluster's two CTAs ------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of both CTAs: orders the barriers' initialisation before
// any use from the other CTA
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of the same shared-memory location in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_peer_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// arrive on a barrier of the other CTA, releasing this thread's earlier
// writes to the cluster
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait with cluster-scope acquire: the other CTA's writes released by
// its arrivals are visible afterwards
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// position in a ring of SLOTS slots and the phase parity of its barriers
template <int SLOTS>
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == SLOTS) {
      s = 0;
      phase ^= 1;
    }
  }
};

// One consumer warpgroup's products of a W-column tile over all K slices:
// acc = x[its 64 rows, :] @ W[:, tile], the first W / 2 registers of acc
// (all 128 at W = 256). Ends with acc landed and pinned and every stage
// released.
template <int W>
__device__ __forceinline__ void tile_products(const Smem& sm, Ring<STAGES>& r, int c, int lane,
                                              int k_blocks, float (&acc)[128]) {
  const uint32_t x_rows = c * WG_ROWS * SW_ROW_BYTES;  // this warpgroup's rows of the x box
  int prev = 0;
  for (int kb = 0; kb < k_blocks; ++kb) {
    mbar_wait(sm.full(r.s), r.phase);
    const uint32_t st = sm.stage(r.s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a = desc_k_major(st + x_rows, kk * 16);
      const uint64_t b = desc_mn_major(st + X_BYTES, kk * 16, W_BOX_BYTES);
      if (W == 256)
        wgmma_m64n256k16_ss_bt(acc, a, b, kb > 0 || kk > 0);
      else
        wgmma_m64n128k16_ss_bt(acc, a, b, kb > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's group has landed: free its stage
    if (kb > 0 && lane == 0) mbar_arrive(sm.empty(prev));
    prev = r.s;
    r.next();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(sm.empty(prev));
}

// The epilogue of a W-column tile at column n0 for this thread's rows row0
// (accumulator e = 0, 1) and row0 + 8 (e = 2, 3): + bias in fp32, one
// rounding, the square of each rounded value into the row's running sum (in
// column order), 16-byte stores of the rows below M.
template <int W>
__device__ __forceinline__ void tile_epilogue(const Params& p, const float* bias,
                                              const float (&acc)[128], float (&ss)[2], int row0,
                                              int n0, int tig) {
#pragma unroll
  for (int h = 0; h < W / 128; ++h) {
    float2 b[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      b[j] = *reinterpret_cast<const float2*>(bias + n0 + 128 * h + 8 * j + 2 * tig);
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      uint32_t w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int e = 4 * (16 * h + j) + 2 * r2;
        w[j] = pack_bf16(acc[e] + b[j].x, acc[e + 1] + b[j].y);
        const float2 yr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        ss[r2] = fmaf(yr.x, yr.x, ss[r2]);
        ss[r2] = fmaf(yr.y, yr.y, ss[r2]);
      }
      const int row = row0 + 8 * r2;
      store_row(p.y + size_t(row) * p.N + n0 + 128 * h, w, tig, row < p.M);
    }
  }
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NTHREADS, 1)
gemm_rstat_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int k_blocks = p.K / BK, n_tiles = (p.N + BN - 1) / BN;
  // the cluster takes row blocks pair, pair + pairs, ...; its CTA `rank`
  // the N tiles rank, rank + 2, ...
  const int rank = int(cluster_rank()), pair = blockIdx.x >> 1, pairs = gridDim.x >> 1;

  if (tid == 0) sm.init_barriers();
  cluster_sync();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ------------------------
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 0) {
      Ring<STAGES> r;
      for (int item = pair; item < p.items; item += pairs) {
        const int m0 = item * BM;
        for (int nt = rank; nt < n_tiles; nt += 2) {
          const int n0 = nt * BN, boxes = min(BN, p.N - n0) / 64;
          for (int kb = 0; kb < k_blocks; ++kb, r.next()) {
            const uint32_t st = sm.stage(r.s), bar = sm.full(r.s);
            mbar_wait(sm.empty(r.s), r.phase ^ 1);
            mbar_arrive_expect_tx(bar, X_BYTES + boxes * W_BOX_BYTES);
            tma_load_3d(st, &map_x, bar, kb * BK, m0, 0);
            for (int j = 0; j < boxes; ++j)
              tma_load_3d(st + X_BYTES + j * W_BOX_BYTES, &map_w, bar, n0 + 64 * j, kb * BK, 0);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows a warpgroup ----------------------------------
    reg_alloc<CONSUMER_REGS>();
    const int c = wg - 1, grp = lane >> 2, tig = lane & 3;
    for (int i = tid - 128; i < p.N; i += 128 * NWG)
      sm.bias[i] = p.bias != nullptr ? p.bias[i] : 0.f;
    bar_sync(1, 128 * NWG);  // the bias row is in place
    Ring<STAGES> r;
    Ring<2> x;  // the square-sum hand-over slots
    float acc[128];
    for (int item = pair; item < p.items; item += pairs) {
      const int lrow = c * WG_ROWS + warp * 16 + grp;  // this thread's rows: lrow, lrow + 8
      const int row0 = item * BM + lrow;
      float ss[2] = {0.f, 0.f};
      for (int nt = rank; nt < n_tiles; nt += 2) {
        const int n0 = nt * BN;
        if (p.N - n0 >= BN) {
          tile_products<BN>(sm, r, c, lane, k_blocks, acc);
          tile_epilogue<BN>(p, sm.bias, acc, ss, row0, n0, tig);
        } else {
          tile_products<128>(sm, r, c, lane, k_blocks, acc);
          tile_epilogue<128>(p, sm.bias, acc, ss, row0, n0, tig);
        }
      }
      // each row's square-sum over this CTA's columns: the quad's four in a
      // fixed order; rank 1 hands its sums to rank 0, which adds them to its
      // own (rank 0's, then rank 1's columns) and writes rs
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        ss[r2] += __shfl_xor_sync(0xffffffffu, ss[r2], 1);
        ss[r2] += __shfl_xor_sync(0xffffffffu, ss[r2], 2);
      }
      if (tig == 0) {
        const uint32_t slot = sm.xss + x.s * BM * sizeof(float);
        if (rank == 1) {
          mbar_wait_cluster(sm.xempty(x.s), x.phase ^ 1);
          for (int r2 = 0; r2 < 2; ++r2)
            st_peer_f32(peer_addr(slot + (lrow + 8 * r2) * sizeof(float), 0), ss[r2]);
          mbar_arrive_peer(peer_addr(sm.xfull(x.s), 0));
        } else {
          mbar_wait_cluster(sm.xfull(x.s), x.phase);
          for (int r2 = 0; r2 < 2; ++r2) {
            const float total = ss[r2] + sm.xss_ptr[x.s * BM + lrow + 8 * r2];
            const int row = row0 + 8 * r2;
            if (row < p.M) p.rs[row] = 1.f / sqrtf(total / float(p.N) + p.eps);
          }
          mbar_arrive_peer(peer_addr(sm.xempty(x.s), 1));
        }
      }
      x.next();
    }
    // rank 1 stays until rank 0 has read its last sums (rank 0's arrivals
    // land in rank 1's shared memory)
    if (rank == 1 && tig == 0) {
      for (int i = 0; i < 2; ++i, x.next()) mbar_wait_cluster(sm.xempty(x.s), x.phase ^ 1);
    }
  }
}

}  // namespace

// Plain C entry for ctypes. Device pointers, 16-byte aligned; bias may be
// null. K must be a multiple of 64, N of 128 and at most 8192, M > 0 (the
// wrapper checks).
// Returns 0, the cudaError_t of the launch, or 100000 + the CUresult of a
// refused tensor map.
extern "C" int vc_linear_rstat(const void* x, const void* w, const void* bias, void* y,
                               void* rs, int M, int N, int K, float eps, void* stream) {
  if (M <= 0 || K <= 0 || K % BK != 0 || N <= 0 || N % 128 != 0 || N > MAX_N)
    return int(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (int err = make_flat_map(&map_x, x, 1, M, K, BM)) return err;
  if (int err = make_flat_map(&map_w, w, 1, K, N, BK)) return err;
  if (cudaError_t err = cudaFuncSetAttribute(
          gemm_rstat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes(N))))
    return int(err);
  Params p = {};
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.rs = static_cast<float*>(rs);
  p.M = M;
  p.N = N;
  p.K = K;
  p.items = (M + BM - 1) / BM;
  p.eps = eps;
  int grid = 0;  // two CTAs a row block: a cluster an SM pair
  if (int err = persistent_grid(2 * p.items, &grid)) return err;
  grid &= ~1;
  gemm_rstat_kernel<<<grid, NTHREADS, smem_bytes(N), static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, p);
  return int(cudaGetLastError());
}
