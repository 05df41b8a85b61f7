// FA2-style flash-attention backward for Hopper (sm_90a): two kernels over
// head-major [B, N, S, 128], as the TPU has.
//
// Replaces `fa_backward` (versecrafter_tpu/kernels/flash_attention_bwd.py:196)
// with its two Pallas kernels:
//   dq_kernel  <- `_dq_kernel` (:100): one CTA per (q tile, head, batch),
//                 looping over KV tiles: S = qs K^T, P = exp(S - L),
//                 dP = dO V^T, dS = P (dP - delta), dQ += bf16(dS) K, and
//                 dQ * sm_scale at the end;
//   dkv_kernel <- `_dkv_kernel` (:142): one CTA per (kv tile, head, batch),
//                 looping over q tiles on the transposed tile:
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
// Design: mma.sync m16n8k16 bf16 with fp32 accumulators, 4 warps of 16 rows
// each (a [16, 128] fp32 accumulator per output is 64 registers a thread,
// and dK/dV hold two), cp.async double-buffered tiles in shared memory with
// rows padded to 136 elements. dK/dV walks each 64-row q tile in two halves
// of 32 columns so the transposed score and dP tiles stay at 16 registers
// each next to the two accumulators. No wgmma/TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int D = 128;         // head_dim (the wrapper checks it)
constexpr int BR = 64;         // rows a CTA owns (q rows for dQ, kv rows for dK/dV)
constexpr int BT = 64;         // rows of the tiles it loops over
constexpr int NTHREADS = 128;  // 4 warps x 16 rows
constexpr int LDS = D + 8;     // padded shared-memory row, in bf16 elements
constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
constexpr size_t SMEM_DQ = size_t(2 * BR + 4 * BT) * LDS * sizeof(__nv_bfloat16);
constexpr size_t SMEM_DKV = SMEM_DQ + 4 * BT * sizeof(float);

struct Params {
  const __nv_bfloat16 *qs, *k, *v, *dout;  // [B, N, Sq|Skv, D]
  const float *L, *delta;                   // [B, N, Sq]
  const int* k_lens;                        // [B] or null
  __nv_bfloat16 *dq, *dk, *dv;
  int N, Sq, Skv, wl, wr;
  float sm_scale;
};

// rows [r0, r0 + 64) of a [rows, D] bf16 matrix into a padded shared tile,
// zero-filled past `rows`
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int rows, int tid) {
  for (int idx = tid; idx < 64 * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS, c0 = (idx % CHUNKS) * 8;
    const bool valid = r0 + r < rows;
    cp_async16(dst + r * LDS + c0, src + size_t(valid ? r0 + r : 0) * D + c0, valid);
  }
}

__device__ __forceinline__ int key_len(const Params& p, int b) {
  return p.k_lens == nullptr ? p.Skv : min(max(p.k_lens[b], 0), p.Skv);
}

// acc[16 x 64] += A[16 x 128] * B[64 x 128]^T for one warp: A rows from
// `a` (ldmatrix A address of this lane), B rows from `bt` (tile base)
__device__ __forceinline__ void mma_abt64(float (*acc)[4], const __nv_bfloat16* a,
                                          const __nv_bfloat16* bt, int b_off) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a0, a1, a2, a3;
    ldmatrix_x4(a + kk * 16, a0, a1, a2, a3);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(bt + jp * 16 * LDS + b_off + kk * 16, b0, b1, b2, b3);
      mma_bf16(acc[2 * jp], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[2 * jp + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// acc[16 x 128] += bf16(x[16 x 16*KT]) * B[16*KT x 128], x the warp's fp32
// score-shaped registers, B rows from the tile `bt` (transposed ldmatrix)
template <int KT>
__device__ __forceinline__ void mma_xb(float (*acc)[4], const float (*x)[4],
                                       const __nv_bfloat16* bt, int v_off) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t a0 = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    const uint32_t a1 = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(bt + kk * 16 * LDS + v_off + dp * 16, b0, b1, b2, b3);
      mma_bf16(acc[2 * dp], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[2 * dp + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (*acc)[4],
                                           int row, int rows, int tig, float scale) {
  // accumulator e = 0,1 belong to `row`, e = 2,3 to `row + 8`
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= rows) continue;
    __nv_bfloat16* d = dst + size_t(row + 8 * r) * D + tig * 2;
#pragma unroll
    for (int t = 0; t < 16; ++t)
      *reinterpret_cast<uint32_t*>(d + t * 8) =
          pack_bf16(acc[t][2 * r] * scale, acc[t][2 * r + 1] * scale);
  }
}

__global__ void __launch_bounds__(NTHREADS, 2) dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BR * LDS;
  __nv_bfloat16* Ks = dOs + BR * LDS;     // two K tile buffers
  __nv_bfloat16* Vs = Ks + 2 * BT * LDS;  // two V tile buffers

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const size_t bh = size_t(b) * p.N + h;
  const __nv_bfloat16* kg = p.k + bh * p.Skv * D;
  const __nv_bfloat16* vg = p.v + bh * p.Skv * D;

  const int k_len = key_len(p, b);
  int n_lo = 0, n_hi = (k_len + BT - 1) / BT;
  if (p.wl >= 0) n_lo = max(q0 - p.wl, 0) / BT;
  if (p.wr >= 0) n_hi = min(n_hi, (q0 + BR - 1 + p.wr) / BT + 1);

  load_rows(Qs, p.qs + bh * p.Sq * D, q0, p.Sq, tid);
  load_rows(dOs, p.dout + bh * p.Sq * D, q0, p.Sq, tid);
  auto load_tile = [&](int n, int buf) {
    load_rows(Ks + buf * BT * LDS, kg, n * BT, p.Skv, tid);
    load_rows(Vs + buf * BT * LDS, vg, n * BT, p.Skv, tid);
    cp_async_commit();
  };
  if (n_lo < n_hi) load_tile(n_lo, 0);  // one group with the q and dO tiles
  else cp_async_commit();

  // this thread's rows: row0 (accumulator e = 0,1) and row0 + 8 (e = 2,3)
  const int row0 = q0 + warp * 16 + grp;
  float Lr[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = row0 + 8 * r < p.Sq;
    Lr[r] = valid ? p.L[bh * p.Sq + row0 + 8 * r] : 0.f;
    Dr[r] = valid ? p.delta[bh * p.Sq + row0 + 8 * r] : 0.f;
  }
  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  const int a_off = (warp * 16 + (mat & 1) * 8 + mrow) * LDS + (mat >> 1) * 8;
  const int k_off = ((mat >> 1) * 8 + mrow) * LDS + (mat & 1) * 8;
  const int v_off = ((mat & 1) * 8 + mrow) * LDS + (mat >> 1) * 8;

  for (int n = n_lo; n < n_hi; ++n) {
    const int kv0 = n * BT;
    const int buf = (n - n_lo) & 1;
    if (n + 1 < n_hi) {
      load_tile(n + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kb = Ks + buf * BT * LDS;
    const __nv_bfloat16* vb = Vs + buf * BT * LDS;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_abt64(s, Qs + a_off, kb, k_off);    // S = qs K^T
    mma_abt64(dp, dOs + a_off, vb, k_off);  // dP = dO V^T

    const bool full = kv0 + BT <= k_len &&
                      (p.wl < 0 || kv0 >= q0 + BR - 1 - p.wl) &&
                      (p.wr < 0 || kv0 + BT - 1 <= q0 + p.wr);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + tig * 2 + (e & 1);
        const int row = row0 + (e < 2 ? 0 : 8);
        const bool ok = full || (col < k_len && (p.wl < 0 || col >= row - p.wl) &&
                                 (p.wr < 0 || col <= row + p.wr));
        const float pr = ok ? exp2f((s[j][e] - Lr[e >> 1]) * LOG2E_F) : 0.f;
        s[j][e] = pr * (dp[j][e] - Dr[e >> 1]);  // dS
      }
    }
    mma_xb<BT / 16>(acc, s, kb, v_off);  // dQ += bf16(dS) K
    __syncthreads();  // every warp is done with this buffer before it refills
  }
  cp_async_wait<0>();
  store_rows(p.dq + bh * p.Sq * D, acc, row0, p.Sq, tig, p.sm_scale);
}

__global__ void __launch_bounds__(NTHREADS, 2) dkv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BR * LDS;
  __nv_bfloat16* Qs = Vs + BR * LDS;       // two qs tile buffers
  __nv_bfloat16* dOs = Qs + 2 * BT * LDS;  // two dO tile buffers
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BT * LDS);  // two L tiles
  float* Ds = Ls + 2 * BT;                                   // two delta tiles

  const int h = blockIdx.y, b = blockIdx.z;
  const int kv0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const size_t bh = size_t(b) * p.N + h;
  const __nv_bfloat16* qg = p.qs + bh * p.Sq * D;
  const __nv_bfloat16* dog = p.dout + bh * p.Sq * D;
  const float* Lg = p.L + bh * p.Sq;
  const float* Dg = p.delta + bh * p.Sq;

  const int k_len = key_len(p, b);
  // q tiles holding a row that can see a key of this tile
  int m_lo = 0, m_hi = kv0 < k_len ? (p.Sq + BT - 1) / BT : 0;
  if (p.wr >= 0) m_lo = max(kv0 - p.wr, 0) / BT;
  if (p.wl >= 0) m_hi = min(m_hi, (kv0 + BR - 1 + p.wl) / BT + 1);

  load_rows(Ks, p.k + bh * p.Skv * D, kv0, p.Skv, tid);
  load_rows(Vs, p.v + bh * p.Skv * D, kv0, p.Skv, tid);
  auto load_tile = [&](int m, int buf) {
    const int r0 = m * BT;
    load_rows(Qs + buf * BT * LDS, qg, r0, p.Sq, tid);
    load_rows(dOs + buf * BT * LDS, dog, r0, p.Sq, tid);
    const int i = tid & (BT - 1);
    const bool valid = r0 + i < p.Sq;
    if (tid < BT) cp_async4(Ls + buf * BT + i, Lg + (valid ? r0 + i : 0), valid);
    else cp_async4(Ds + buf * BT + i, Dg + (valid ? r0 + i : 0), valid);
    cp_async_commit();
  };
  if (m_lo < m_hi) load_tile(m_lo, 0);  // one group with the K and V tiles
  else cp_async_commit();

  // this thread's kv rows: row0 (accumulator e = 0,1) and row0 + 8 (e = 2,3)
  const int row0 = kv0 + warp * 16 + grp;
  float dk[16][4], dv[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    dk[t][0] = dk[t][1] = dk[t][2] = dk[t][3] = 0.f;
    dv[t][0] = dv[t][1] = dv[t][2] = dv[t][3] = 0.f;
  }

  const int a_off = (warp * 16 + (mat & 1) * 8 + mrow) * LDS + (mat >> 1) * 8;
  const int k_off = ((mat >> 1) * 8 + mrow) * LDS + (mat & 1) * 8;
  const int v_off = ((mat & 1) * 8 + mrow) * LDS + (mat >> 1) * 8;

  for (int m = m_lo; m < m_hi; ++m) {
    const int q0 = m * BT;
    const int buf = (m - m_lo) & 1;
    if (m + 1 < m_hi) {
      load_tile(m + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qb = Qs + buf * BT * LDS;
    const __nv_bfloat16* ob = dOs + buf * BT * LDS;
    const float* lb = Ls + buf * BT;
    const float* db = Ds + buf * BT;
    const bool full = kv0 + BR <= k_len && q0 + BT <= p.Sq &&
                      (p.wl < 0 || kv0 >= q0 + BT - 1 - p.wl) &&
                      (p.wr < 0 || kv0 + BR - 1 <= q0 + p.wr);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;  // this half's first q column in the tile
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
      // S^T = K qs^T and dP^T = V dO^T over 32 q columns
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a0, a1, a2, a3, c0r, c1r, c2r, c3r;
        ldmatrix_x4(Ks + a_off + kk * 16, a0, a1, a2, a3);
        ldmatrix_x4(Vs + a_off + kk * 16, c0r, c1r, c2r, c3r);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(qb + (c0 + jp * 16) * LDS + k_off + kk * 16, b0, b1, b2, b3);
          mma_bf16(st[2 * jp], a0, a1, a2, a3, b0, b1);
          mma_bf16(st[2 * jp + 1], a0, a1, a2, a3, b2, b3);
          ldmatrix_x4(ob + (c0 + jp * 16) * LDS + k_off + kk * 16, b0, b1, b2, b3);
          mma_bf16(dpt[2 * jp], c0r, c1r, c2r, c3r, b0, b1);
          mma_bf16(dpt[2 * jp + 1], c0r, c1r, c2r, c3r, b2, b3);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lc = c0 + j * 8 + tig * 2 + (e & 1);  // q row in the tile
          const int qrow = q0 + lc;
          const int key = row0 + (e < 2 ? 0 : 8);
          const bool ok = full || (qrow < p.Sq && key < k_len &&
                                   (p.wl < 0 || key >= qrow - p.wl) &&
                                   (p.wr < 0 || key <= qrow + p.wr));
          const float pr = ok ? exp2f((st[j][e] - lb[lc]) * LOG2E_F) : 0.f;
          st[j][e] = pr;                           // P^T
          dpt[j][e] = pr * (dpt[j][e] - db[lc]);   // dS^T
        }
      }
      mma_xb<2>(dv, st, ob + c0 * LDS, v_off);   // dV += bf16(P^T) dO
      mma_xb<2>(dk, dpt, qb + c0 * LDS, v_off);  // dK += bf16(dS^T) qs
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }
  cp_async_wait<0>();
  store_rows(p.dk + bh * p.Skv * D, dk, row0, p.Skv, tig, 1.f);
  store_rows(p.dv + bh * p.Skv * D, dv, row0, p.Skv, tig, 1.f);
}

Params make_params(const void* qs, const void* k, const void* v, const void* dout,
                   const void* L, const void* delta, const void* k_lens, int N,
                   int Sq, int Skv, int wl, int wr) {
  Params p = {};
  p.qs = static_cast<const __nv_bfloat16*>(qs);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
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

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers; k_lens may be
// null (every key visible). Each returns the cudaError_t of its launch.
extern "C" int vc_fa_backward_dq(const void* qs, const void* k, const void* v,
                                 const void* dout, const void* L, const void* delta,
                                 const void* k_lens, void* dq, int B, int N, int Sq,
                                 int Skv, int wl, int wr, float sm_scale,
                                 void* stream) {
  Params p = make_params(qs, k, v, dout, L, delta, k_lens, N, Sq, Skv, wl, wr);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.sm_scale = sm_scale;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_DQ));
  if (err != cudaSuccess) return int(err);
  dim3 grid((Sq + BR - 1) / BR, N, B);
  dq_kernel<<<grid, NTHREADS, SMEM_DQ, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

extern "C" int vc_fa_backward_dkv(const void* qs, const void* k, const void* v,
                                  const void* dout, const void* L, const void* delta,
                                  const void* k_lens, void* dk, void* dv, int B,
                                  int N, int Sq, int Skv, int wl, int wr,
                                  void* stream) {
  Params p = make_params(qs, k, v, dout, L, delta, k_lens, N, Sq, Skv, wl, wr);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_DKV));
  if (err != cudaSuccess) return int(err);
  dim3 grid((Skv + BR - 1) / BR, N, B);
  dkv_kernel<<<grid, NTHREADS, SMEM_DKV, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}
