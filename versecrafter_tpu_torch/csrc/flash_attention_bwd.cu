// FA2-style flash-attention backward for Hopper (sm_90a): two kernels over
// head-major [B, N, S, 128], as the TPU has.
//
// Replaces `fa_backward` (versecrafter_tpu/kernels/flash_attention_bwd.py:196)
// with its two Pallas kernels:
//   dq_kernel  <- `_dq_kernel` (:100): one CTA per (128 q rows, head, batch),
//                 looping over KV tiles: S = qs K^T, P = exp(S - L),
//                 dP = dO V^T, dS = P (dP - delta), dQ += bf16(dS) K, and
//                 dQ * sm_scale at the end;
//   dkv_kernel <- `_dkv_kernel` (:142): one CTA per (128 kv rows, head,
//                 batch), looping over q tiles on the transposed tile:
//                 S^T = K qs^T, P^T = exp(S^T - L), dP^T = V dO^T,
//                 dV += bf16(P^T) dO, dK += bf16(dS^T) qs.
// qs = bf16(q * sm_scale) (rounded once, as the stats forward did), L = the
// row logsumexp m + log(max(l, 1e-30)) and delta = rowsum(dO * O) come from
// the wrapper. Both kernels use the forward's k_lens / window tile skip.
// Masked keys and query rows past Sq get P = 0 explicitly (the TPU pads rows
// with L = +big instead), so they add nothing to dK/dV. No atomics: every
// output element is summed by one thread in a fixed order, so results are
// run-to-run identical.
//
// What bounds it on an H100: at the training shape (S = 32,760, 12 heads,
// batch 1) dQ does three products of 2*S^2*128 per head, 9.9e12 FLOP
// (~10.0 ms at 989 TFLOP/s); dK/dV four, 13.2e12 FLOP (~13.3 ms); the I/O is
// ~0.5 GB. Both are tensor-core bound on paper.
//
// Design. All seven products are wgmma.mma_async (bf16 -> fp32). A CTA is
// three warpgroups: one producer warp (the rest of its warpgroup idles) and
// two consumer warpgroups of 64 rows each; setmaxnreg hands the producer's
// registers to the consumers. Tiles are [64, 128] bf16 in the 128-byte
// swizzle, written by the Tensor Memory Accelerator (cp.async.bulk.tensor
// from 3-D tensor maps over [B*N, S, 128], so rows past S are zero-filled
// and a tile never runs into the next head) into a ring of STAGES stages
// with a full and an empty mbarrier per stage. TMA rather than cp.async
// with hand-swizzled addresses: one thread issues four instructions a
// stage, the consumers spend no instruction on loads, and the tensor maps
// are built in the C entry from the pointers, with the encode function
// looked up through the CUDA runtime (nothing but the runtime is linked).
//   dQ:    qs and dO of the CTA's rows are loaded once and held as register
//          A operands (ldmatrix from the swizzled tile), so S and dP read
//          only K / V from shared memory; dS goes to bf16 in registers as
//          the A operand of dQ += dS K, K read from the same tile through
//          the MN-major (transposed) descriptor. dQ += dS K of tile n stays
//          in flight under the two score products of tile n + 1, and the P
//          arithmetic runs under dP's product.
//   dK/dV: K and V of the CTA's rows stay in shared memory as the A
//          operands of S^T and dP^T; P^T and dS^T go to bf16 registers as A
//          of dV += P^T dO and dK += dS^T qs, with dO / qs read MN-major
//          from the stage's tiles. L and delta of a q tile are put into the
//          stage by the producer warp. Two [64, 128] accumulators (128
//          registers) leave room for the two score tiles (64) or for them
//          plus the packed operands, not for a second tile in flight: a
//          warpgroup alternates between a tensor phase (dV, dK of tile n,
//          then S^T, dP^T of tile n + 1, queued back to back) and an
//          arithmetic phase (exp2, dS, packing), and the two warpgroups of a
//          CTA fill each other's gaps.
// Registers decide both kernels: with 232 a consumer thread ptxas serialised
// every wgmma (C7512); 240 / 24 (consumer / producer) and the phase order
// above compile without that warning and without spills. Ring depth 3 (2 and
// 4 were measured and are no better; PERF.md has the numbers).
// `vc_wgmma_layout_check` runs one warpgroup over an integer-valued tile
// pair and returns every product form the kernels use (K-major from shared
// memory and from registers, register A from a packed accumulator with the
// MN-major B) and the forms of csrc/matmul_stat.cu (A K-major and B MN-major
// both from shared memory, n256 and n128); the CUDA tests hold it to an
// exact integer product.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W (name and
// power limit as nvidia-smi gives them), batch 1, 12 heads: dQ 14.99 ms and
// dK/dV 20.39 ms at 32,760 x 32,760 (1.50x and 1.53x their bounds; the
// warp-level MMA kernels these replace took 32.94 and 46.25 ms in the same call),
// 0.331 and 0.756 ms at 32,760 x 512. With the exp2 / mask / dS arithmetic
// stubbed out (scripts/bench_torch_fa_backward.py on an edited copy) the
// products alone take 12.79 and 16.70 ms: the tensor pipeline runs at ~80 %
// of peak and the arithmetic that is not hidden under it costs the rest.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int D = 128;      // head_dim (the wrapper checks it)
constexpr int BR = 64;      // rows a consumer warpgroup owns
constexpr int NWG = 2;      // consumer warpgroups a CTA
constexpr int BM = BR * NWG;  // rows a CTA owns (q rows for dQ, kv rows for dK/dV)
constexpr int BT = 64;      // rows of the tiles it loops over
constexpr int STAGES = 3;   // ring depth of the streamed tiles
constexpr int NTHREADS = 128 * (NWG + 1);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// shared memory, from a 1024-byte aligned base: the resident tiles (two
// matrices x NWG row blocks), the ring (two tiles a stage), L and delta
// rows of the stages (dK/dV only), the barriers
constexpr uint32_t RES_BYTES = 2 * NWG * TILE_BYTES;
constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES;
constexpr uint32_t STATS_OFF = RES_BYTES + STAGES * STAGE_BYTES;
constexpr uint32_t BAR_OFF = STATS_OFF + STAGES * 2 * BT * sizeof(float);
constexpr size_t SMEM_BYTES = BAR_OFF + (1 + 2 * STAGES) * sizeof(uint64_t) + 1024;

struct Params {
  const float *L, *delta;  // [B, N, Sq]
  const int* k_lens;       // [B] or null
  __nv_bfloat16 *dq, *dk, *dv;
  int N, Sq, Skv, wl, wr;
  float sm_scale;
};

struct Smem {
  uint32_t res, ring, res_bar, full_bar, empty_bar;
  float* stats;
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    const uint32_t a = smem_u32(raw);
    const uint32_t pad = ((a + 1023u) & ~1023u) - a;
    res = a + pad;
    ring = res + RES_BYTES;
    stats = reinterpret_cast<float*>(raw + pad + STATS_OFF);
    res_bar = res + BAR_OFF;
    full_bar = res_bar + 8;
    empty_bar = full_bar + 8 * STAGES;
  }
  __device__ __forceinline__ uint32_t stage(int s) const { return ring + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return full_bar + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return empty_bar + 8 * s; }
  // one thread, before the block-wide barrier that precedes any use
  __device__ __forceinline__ void init_barriers() const {
    mbar_init(res_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NWG);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
};

// position in the ring and the phase parity of its barriers
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ int key_len(const Params& p, int b) {
  return p.k_lens == nullptr ? p.Skv : min(max(p.k_lens[b], 0), p.Skv);
}

// a [64, 128] fp32 accumulator to bf16 rows `row` and `row + 8` of `dst`
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[64],
                                           int row, int rows, int tig, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= rows) continue;
    __nv_bfloat16* d = dst + size_t(row + 8 * r) * D + tig * 2;
#pragma unroll
    for (int t = 0; t < 16; ++t)
      *reinterpret_cast<uint32_t*>(d + t * 8) =
          pack_bf16(acc[4 * t + 2 * r] * scale, acc[4 * t + 2 * r + 1] * scale);
  }
}

// P = exp(S - L) in place over a [64, 64] score accumulator whose rows are
// query rows (row0, row0 + 8) and columns keys kv0 + ...; masked entries 0
template <bool FULL>
__device__ __forceinline__ void dq_probabilities(float (&s)[32], const float (&Lr)[2],
                                                 int row0, int kv0, int tig, int k_len,
                                                 int wl, int wr) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kv0 + j * 8 + tig * 2 + (e & 1);
      const int row = row0 + (e < 2 ? 0 : 8);
      const bool ok = FULL || (col < k_len && (wl < 0 || col >= row - wl) &&
                               (wr < 0 || col <= row + wr));
      s[4 * j + e] = ok ? exp2f((s[4 * j + e] - Lr[e >> 1]) * LOG2E_F) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap map_qs, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
          const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = b * p.N + h;

  const int k_len = key_len(p, b);
  int n_lo = 0, n_hi = (k_len + BT - 1) / BT;
  if (p.wl >= 0) n_lo = max(q0 - p.wl, 0) / BT;
  if (p.wr >= 0) n_hi = min(n_hi, (q0 + BM - 1 + p.wr) / BT + 1);

  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full -----------------------
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 0 && n_lo < n_hi) {
      mbar_arrive_expect_tx(sm.res_bar, RES_BYTES);
      for (int c = 0; c < NWG; ++c) {
        tma_load_tile(sm.res + c * TILE_BYTES, &map_qs, sm.res_bar, q0 + c * BR, bh);
        tma_load_tile(sm.res + (NWG + c) * TILE_BYTES, &map_do, sm.res_bar, q0 + c * BR, bh);
      }
      Ring r;
      for (int n = n_lo; n < n_hi; ++n, r.next()) {
        mbar_wait(sm.empty(r.s), r.phase ^ 1);
        mbar_arrive_expect_tx(sm.full(r.s), STAGE_BYTES);
        tma_load_tile(sm.stage(r.s), &map_k, sm.full(r.s), n * BT, bh);
        tma_load_tile(sm.stage(r.s) + TILE_BYTES, &map_v, sm.full(r.s), n * BT, bh);
      }
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup ------------------------------
    reg_alloc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int grp = lane >> 2, tig = lane & 3;
    const int q0w = q0 + c * BR;
    // this thread's rows: row0 (accumulator e = 0,1) and row0 + 8 (e = 2,3)
    const int row0 = q0w + warp * 16 + grp;
    float Lr[2], Dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool valid = row0 + 8 * r < p.Sq;
      Lr[r] = valid ? p.L[size_t(bh) * p.Sq + row0 + 8 * r] : 0.f;
      Dr[r] = valid ? p.delta[size_t(bh) * p.Sq + row0 + 8 * r] : 0.f;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    if (n_lo < n_hi) {
      // qs and dO of this warp's 16 rows as register A operands
      uint32_t qa[D / 16][4], da[D / 16][4];
      mbar_wait(sm.res_bar, 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a_frag(qa[kk], sm.res + c * TILE_BYTES, warp * 16, kk * 16, lane);
        load_a_frag(da[kk], sm.res + (NWG + c) * TILE_BYTES, warp * 16, kk * 16, lane);
      }
      float s[32], dp[32];
      uint32_t ds[BT / 16][4] = {};
      Ring r;
      int prev = -1;  // the stage dQ += dS K of the previous tile still reads
      for (int n = n_lo; n < n_hi; ++n, r.next()) {
        const int kv0 = n * BT;
        mbar_wait(sm.full(r.s), r.phase);
        const uint32_t kt = sm.stage(r.s), vt = kt + TILE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // S = qs K^T
          wgmma_m64n64k16_rs(s, qa[kk], desc_k_major(kt, kk * 16), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
          wgmma_m64n64k16_rs(dp, da[kk], desc_k_major(vt, kk * 16), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // S, and the previous tile's dQ product
        fence_regs(s);
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) fence_regs(ds[kk]);
        if (prev >= 0 && lane == 0) mbar_arrive(sm.empty(prev));

        const bool full = kv0 + BT <= k_len &&
                          (p.wl < 0 || kv0 >= q0w + BR - 1 - p.wl) &&
                          (p.wr < 0 || kv0 + BT - 1 <= q0w + p.wr);
        if (full) dq_probabilities<true>(s, Lr, row0, kv0, tig, k_len, p.wl, p.wr);
        else dq_probabilities<false>(s, Lr, row0, kv0, tig, k_len, p.wl, p.wr);
        wgmma_wait<0>();  // dP
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= dp[i] - Dr[(i >> 1) & 1];  // dS
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) pack_a_frag(ds[kk], s, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)  // dQ += bf16(dS) K
          wgmma_m64n128k16_rs_bt(acc, ds[kk], desc_mn_major(kt, kk * 16), 1);
        wgmma_commit();
        prev = r.s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
    }
    store_rows(p.dq + size_t(bh) * p.Sq * D, acc, row0, p.Sq, tig, p.sm_scale);
  }
}

// P^T and dS^T of a [64 keys, 64 q rows] tile, rounded to bf16 as the A
// operands of dV += P^T dO and dK += dS^T qs; L and delta per column from
// shared memory
template <bool FULL>
__device__ __forceinline__ void dkv_operands(uint32_t (&pt)[BT / 16][4],
                                             uint32_t (&dst)[BT / 16][4], float (&st)[32],
                                             float (&dpt)[32], const float* lb,
                                             const float* db, int row0, int q0, int tig,
                                             int Sq, int k_len, int wl, int wr) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lc = j * 8 + tig * 2;  // q row in the tile
    const float2 l2 = *reinterpret_cast<const float2*>(lb + lc);
    const float2 d2 = *reinterpret_cast<const float2*>(db + lc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qrow = q0 + lc + (e & 1);
      const int key = row0 + (e < 2 ? 0 : 8);
      const bool ok = FULL || (qrow < Sq && key < k_len && (wl < 0 || key >= qrow - wl) &&
                               (wr < 0 || key <= qrow + wr));
      const float lv = (e & 1) ? l2.y : l2.x, dv = (e & 1) ? d2.y : d2.x;
      const float pr = ok ? exp2f((st[4 * j + e] - lv) * LOG2E_F) : 0.f;
      st[4 * j + e] = pr;                          // P^T
      dpt[4 * j + e] = pr * (dpt[4 * j + e] - dv);  // dS^T
    }
  }
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    pack_a_frag(pt[kk], st, kk);
    pack_a_frag(dst[kk], dpt, kk);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap map_qs, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
           const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);

  const int h = blockIdx.y, b = blockIdx.z;
  const int kv0 = blockIdx.x * BM;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = b * p.N + h;

  const int k_len = key_len(p, b);
  // q tiles holding a row that can see a key of this CTA's rows
  int m_lo = 0, m_hi = kv0 < k_len ? (p.Sq + BT - 1) / BT : 0;
  if (p.wr >= 0) m_lo = max(kv0 - p.wr, 0) / BT;
  if (p.wl >= 0) m_hi = min(m_hi, (kv0 + BM - 1 + p.wl) / BT + 1);

  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one warp; lane 0 issues the tile loads, all lanes put
    // the q tile's L and delta rows (zeros past Sq) into the stage --------
    reg_dealloc<PRODUCER_REGS>();
    if (warp == 0 && m_lo < m_hi) {
      if (lane == 0) {
        mbar_arrive_expect_tx(sm.res_bar, RES_BYTES);
        for (int c = 0; c < NWG; ++c) {
          tma_load_tile(sm.res + c * TILE_BYTES, &map_k, sm.res_bar, kv0 + c * BR, bh);
          tma_load_tile(sm.res + (NWG + c) * TILE_BYTES, &map_v, sm.res_bar, kv0 + c * BR,
                        bh);
        }
      }
      const float* Lg = p.L + size_t(bh) * p.Sq;
      const float* Dg = p.delta + size_t(bh) * p.Sq;
      auto stats_of = [&](int m, float (&x)[4]) {
        const int r = m * BT + lane;
        x[0] = r < p.Sq ? Lg[r] : 0.f;
        x[1] = r + 32 < p.Sq ? Lg[r + 32] : 0.f;
        x[2] = r < p.Sq ? Dg[r] : 0.f;
        x[3] = r + 32 < p.Sq ? Dg[r + 32] : 0.f;
      };
      float x[4];
      stats_of(m_lo, x);
      Ring r;
      for (int m = m_lo; m < m_hi; ++m, r.next()) {
        mbar_wait(sm.empty(r.s), r.phase ^ 1);
        float* st = sm.stats + r.s * 2 * BT;
        st[lane] = x[0];
        st[lane + 32] = x[1];
        st[BT + lane] = x[2];
        st[BT + lane + 32] = x[3];
        if (m + 1 < m_hi) stats_of(m + 1, x);  // in flight under the next wait
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(sm.full(r.s), STAGE_BYTES);  // releases the rows above
          tma_load_tile(sm.stage(r.s), &map_qs, sm.full(r.s), m * BT, bh);
          tma_load_tile(sm.stage(r.s) + TILE_BYTES, &map_do, sm.full(r.s), m * BT, bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 kv rows a warpgroup ------------------------------
    reg_alloc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int grp = lane >> 2, tig = lane & 3;
    const int kv0w = kv0 + c * BR;
    // this thread's kv rows: row0 (accumulator e = 0,1) and row0 + 8 (e = 2,3)
    const int row0 = kv0w + warp * 16 + grp;
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    if (m_lo < m_hi) {
      const uint32_t Kt = sm.res + c * TILE_BYTES, Vt = sm.res + (NWG + c) * TILE_BYTES;
      mbar_wait(sm.res_bar, 0);
      float st[32], dpt[32];
      uint32_t pt[BT / 16][4] = {}, dst[BT / 16][4] = {};
      Ring r;
      int prev = -1;  // the stage the previous tile's dV / dK products still read
      for (int m = m_lo; m < m_hi; ++m, r.next()) {
        const int q0 = m * BT;
        const uint32_t qt = sm.stage(r.s), ot = qt + TILE_BYTES;
        const float* lb = sm.stats + r.s * 2 * BT;
        // the previous tile's dV / dK products end before the score products
        // start: P^T, dS^T and the two score tiles never live together
        wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
          fence_regs(pt[kk]);
          fence_regs(dst[kk]);
        }
        if (prev >= 0 && lane == 0) mbar_arrive(sm.empty(prev));
        mbar_wait(sm.full(r.s), r.phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // S^T = K qs^T
          wgmma_m64n64k16_ss(st, desc_k_major(Kt, kk * 16), desc_k_major(qt, kk * 16), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
          wgmma_m64n64k16_ss(dpt, desc_k_major(Vt, kk * 16), desc_k_major(ot, kk * 16),
                             kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        const bool full = kv0w + BR <= k_len && q0 + BT <= p.Sq &&
                          (p.wl < 0 || kv0w >= q0 + BT - 1 - p.wl) &&
                          (p.wr < 0 || kv0w + BR - 1 <= q0 + p.wr);
        if (full)
          dkv_operands<true>(pt, dst, st, dpt, lb, lb + BT, row0, q0, tig, p.Sq, k_len, p.wl,
                             p.wr);
        else
          dkv_operands<false>(pt, dst, st, dpt, lb, lb + BT, row0, q0, tig, p.Sq, k_len, p.wl,
                              p.wr);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)  // dV += bf16(P^T) dO
          wgmma_m64n128k16_rs_bt(dv, pt[kk], desc_mn_major(ot, kk * 16), 1);
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)  // dK += bf16(dS^T) qs
          wgmma_m64n128k16_rs_bt(dk, dst[kk], desc_mn_major(qt, kk * 16), 1);
        wgmma_commit();
        prev = r.s;
      }
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
    }
    store_rows(p.dk + size_t(bh) * p.Skv * D, dk, row0, p.Skv, tig, 1.f);
    store_rows(p.dv + size_t(bh) * p.Skv * D, dv, row0, p.Skv, tig, 1.f);
  }
}

// One warpgroup, one tile pair: every product form the kernels use, on the
// first 64 rows of matrix `which` of a ([count, rows, 128]) and of b.
//   c_ss [64, 64]  = A B^T, both K-major from shared memory
//   c_rs [64, 64]  = A B^T, A from registers (ldmatrix of the swizzled tile)
//   c_pb [64, 128] = bf16(c_ss) B, the accumulator packed as register A and
//                    B read MN-major from the same tile
//   c_sb [64, 384] = A[:, :64] [A | B | B], A K-major and B MN-major both
//                    from shared memory, as csrc/matmul_stat.cu's GEMM reads
//                    x and W: columns 0..255 by the n256 form over the A
//                    and B tiles read as one [64, 256] tile (four 64-column
//                    blocks), 256..383 by the n128 form over B
__global__ void __launch_bounds__(128, 1)
layout_check_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, int which, float* c_ss,
                    float* c_rs, float* c_pb, float* c_sb) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const uint32_t at = sm.res, bt = sm.res + TILE_BYTES;
  if (tid == 0) {
    sm.init_barriers();
    mbar_arrive_expect_tx(sm.res_bar, 2 * TILE_BYTES);
    tma_load_tile(at, &map_a, sm.res_bar, 0, which);
    tma_load_tile(bt, &map_b, sm.res_bar, 0, which);
  }
  __syncthreads();
  mbar_wait(sm.res_bar, 0);

  float ss[32], rs[32], pb[64];
  uint32_t a[4];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(ss, desc_k_major(at, kk * 16), desc_k_major(bt, kk * 16), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(ss);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a_frag(a, at, warp * 16, kk * 16, lane);
    wgmma_fence();
    wgmma_m64n64k16_rs(rs, a, desc_k_major(bt, kk * 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(a);
  }
  fence_regs(rs);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    pack_a_frag(a, ss, kk);
    wgmma_fence();
    wgmma_m64n128k16_rs_bt(pb, a, desc_mn_major(bt, kk * 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(a);
  }
  fence_regs(pb);

  const int row = warp * 16 + grp;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = row + ((i >> 1) & 1) * 8, col = (i >> 2) * 8 + tig * 2 + (i & 1);
    if (i < 32) {
      c_ss[r * 64 + col] = ss[i];
      c_rs[r * 64 + col] = rs[i];
    }
    c_pb[r * D + col] = pb[i];
  }

  float sb[128];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n256k16_ss_bt(sb, desc_k_major(at, kk * 16), desc_mn_major(at, kk * 16), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sb);
#pragma unroll
  for (int i = 0; i < 128; ++i)
    c_sb[(row + ((i >> 1) & 1) * 8) * 384 + (i >> 2) * 8 + tig * 2 + (i & 1)] = sb[i];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_ss_bt(sb, desc_k_major(at, kk * 16), desc_mn_major(bt, kk * 16), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sb);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    c_sb[(row + ((i >> 1) & 1) * 8) * 384 + 256 + (i >> 2) * 8 + tig * 2 + (i & 1)] = sb[i];
}

Params make_params(const void* L, const void* delta, const void* k_lens, int N, int Sq,
                   int Skv, int wl, int wr) {
  Params p = {};
  p.L = static_cast<const float*>(L);
  p.delta = static_cast<const float*>(delta);
  p.k_lens = static_cast<const int*>(k_lens);
  p.N = N;
  p.Sq = Sq;
  p.Skv = Skv;
  p.wl = wl;
  p.wr = wr;
  return p;
}

// tensor maps of qs, k, v, dO (in that order); 0 or an error code
int make_maps(CUtensorMap (&maps)[4], const void* qs, const void* k, const void* v,
              const void* dout, int BH, int Sq, int Skv) {
  const void* base[4] = {qs, k, v, dout};
  const int rows[4] = {Sq, Skv, Skv, Sq};
  for (int i = 0; i < 4; ++i)
    if (int err = make_rows_map(&maps[i], base[i], rows[i], BH)) return err;
  return 0;
}

template <typename Kernel>
int opt_in_shared_memory(Kernel kernel) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(SMEM_BYTES)));
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers, 16-byte aligned;
// k_lens may be null (every key visible). Each returns 0, the cudaError_t of
// its launch, or 100000 + the CUresult of a refused tensor map.
extern "C" int vc_fa_backward_dq(const void* qs, const void* k, const void* v,
                                 const void* dout, const void* L, const void* delta,
                                 const void* k_lens, void* dq, int B, int N, int Sq,
                                 int Skv, int wl, int wr, float sm_scale,
                                 void* stream) {
  Params p = make_params(L, delta, k_lens, N, Sq, Skv, wl, wr);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.sm_scale = sm_scale;
  CUtensorMap maps[4];
  if (int err = make_maps(maps, qs, k, v, dout, B * N, Sq, Skv)) return err;
  if (int err = opt_in_shared_memory(dq_kernel)) return err;
  dim3 grid((Sq + BM - 1) / BM, N, B);
  dq_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return int(cudaGetLastError());
}

extern "C" int vc_fa_backward_dkv(const void* qs, const void* k, const void* v,
                                  const void* dout, const void* L, const void* delta,
                                  const void* k_lens, void* dk, void* dv, int B,
                                  int N, int Sq, int Skv, int wl, int wr,
                                  void* stream) {
  Params p = make_params(L, delta, k_lens, N, Sq, Skv, wl, wr);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  CUtensorMap maps[4];
  if (int err = make_maps(maps, qs, k, v, dout, B * N, Sq, Skv)) return err;
  if (int err = opt_in_shared_memory(dkv_kernel)) return err;
  dim3 grid((Skv + BM - 1) / BM, N, B);
  dkv_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return int(cudaGetLastError());
}

// The wgmma / TMA layout check: a, b are bf16 [count, rows, 128]; c_ss, c_rs
// fp32 [64, 64], c_pb fp32 [64, 128] and c_sb fp32 [64, 384] (see
// layout_check_kernel).
extern "C" int vc_wgmma_layout_check(const void* a, const void* b, int rows, int count,
                                     int which, void* c_ss, void* c_rs, void* c_pb,
                                     void* c_sb, void* stream) {
  CUtensorMap map_a, map_b;
  if (int err = make_rows_map(&map_a, a, rows, count)) return err;
  if (int err = make_rows_map(&map_b, b, rows, count)) return err;
  if (int err = opt_in_shared_memory(layout_check_kernel)) return err;
  layout_check_kernel<<<1, 128, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, which, static_cast<float*>(c_ss), static_cast<float*>(c_rs),
      static_cast<float*>(c_pb), static_cast<float*>(c_sb));
  return int(cudaGetLastError());
}
