// Fused qk-RMSNorm (+ RoPE) flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_attention_fused_pallas`
// (versecrafter_tpu/kernels/flash_attention.py:800, body `_fa_kernel` :94)
// in its two inference flavors:
//   ROPE=true  — self-attention (fused_rope_rms_attention): per-tile
//                bf16(x * rstat * g), then x*cosI + pairswap(x)*sinI;
//   ROPE=false — cross-attention (fused_rms_cross_attention): norm only.
// q/k/v arrive raw in their flat [B, S, N*128] projection layout; the head's
// columns are addressed as h*128 inside the row stride N*128, so no relayout
// pass exists. rstat_q carries sm_scale*log2(e), so scores are in the exp2
// domain. Online softmax in fp32; P is rounded to bf16 before PV with fp32
// accumulation; l is summed from the fp32 P; a row with l == 0 writes 0.
// Masked keys (past k_len, past Skv, outside the window) contribute exactly
// zero — also in a row whose first visited tile holds none of its keys.
//
// What bounds it on an H100: at the 480p x 81f shape (S = 32,760, 12 heads,
// CFG batch 2) the self flavor does 4*2*12*S^2*128 = 1.3e13 FLOP against
// ~0.8 GB of I/O, so it is tensor-core bound (~13 ms at 989 TFLOP/s); the
// cross flavor (512 keys) does 2.1e11 FLOP against ~0.4 GB, about as much
// memory- as compute-bound (~0.2 ms).
//
// Design: a prepass kernel normalises (+ rotates) K once per row into a
// scratch buffer the wrapper allocates (the Pallas resident-KV mode's
// "rotate K once per (b, h)"), so the main loop streams ready bf16 K~ and V
// tiles. Main kernel: one CTA per (q tile of 128 rows, head, batch), 4 warps
// of 32 q rows each; the Pallas sequential kv grid axis becomes a loop over
// 64-row K~/V tiles inside the CTA, double-buffered in shared memory with
// cp.async so the next tile's load overlaps this tile's math. The q tile is
// normalised and rotated once into shared memory as bf16 (one thread owns
// whole RoPE pairs, so pairswap is a register swap). QK^T and PV run on
// tensor cores through mma.sync m16n8k16 bf16 with fp32 accumulators in
// registers; fragments come from ldmatrix (.trans for V). Shared-memory
// bandwidth, not the tensor cores, limits this loop, so each warp owns two
// 16-row mma tiles and every K~/V fragment it loads feeds both; that takes
// the whole 255-register budget, and two CTAs share an SM. Rows are padded
// to 136 elements so every fragment load is bank-conflict free. No
// wgmma/TMA and no warp specialisation yet: that is the headroom left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int D = 128;          // head_dim (the wrapper checks it)
constexpr int BM = 128;         // q rows per CTA
constexpr int BN = 64;          // kv rows per tile
constexpr int MT = 2;           // 16-row mma tiles per warp
constexpr int NTHREADS = 32 * BM / (16 * MT);  // 4 warps of 32 q rows
constexpr int LDS = D + 8;      // padded shared-memory row, in bf16 elements
constexpr int CHUNKS = D / 8;   // 16-byte chunks per row
constexpr size_t SMEM_BYTES = size_t(BM + 4 * BN) * LDS * sizeof(__nv_bfloat16);  // Q + 2 x (K~, V)

struct Params {
  const __nv_bfloat16 *q, *k, *v;  // k: the transformed K~ rows
  const float *rq, *rk;          // [B, Sq], [B, Skv] row statistics
  const float *gq, *gk;          // [N*D] norm scales
  const __nv_bfloat16 *cos, *sin;  // [>= max(Sq, Skv), D] interleaved tables
  const int *k_lens;             // [B] or null
  __nv_bfloat16 *out;            // [B, Sq, N*D]
  int Sq, Skv, N, wl, wr;
};

// 8 consecutive channels of one row: fp32 (x * rstat) * g, optional RoPE,
// one rounding to bf16, 16-byte store into shared memory. Invalid rows
// (past the sequence) store zeros.
template <bool ROPE>
__device__ __forceinline__ void transform_chunk(
    __nv_bfloat16* dst, const __nv_bfloat16* src, float rstat, const float* g,
    const __nv_bfloat16* cs, const __nv_bfloat16* sn, bool valid) {
  uint4 res = make_uint4(0u, 0u, 0u, 0u);
  if (valid) {
    uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float4 g0 = *reinterpret_cast<const float4*>(g);
    float4 g1 = *reinterpret_cast<const float4*>(g + 4);
    float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 p = __bfloat1622float2(x2[i]);
      f[2 * i] = p.x * rstat * gg[2 * i];
      f[2 * i + 1] = p.y * rstat * gg[2 * i + 1];
    }
    if (ROPE) {
      uint4 craw = *reinterpret_cast<const uint4*>(cs);
      uint4 sraw = *reinterpret_cast<const uint4*>(sn);
      const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&craw);
      const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sraw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 c = __bfloat1622float2(c2[i]);
        float2 s = __bfloat1622float2(s2[i]);
        float a = f[2 * i], b = f[2 * i + 1];
        f[2 * i] = a * c.x + b * s.x;      // pairswap: even lane takes x[2i+1]
        f[2 * i + 1] = b * c.y + a * s.y;  // odd lane takes x[2i]
      }
    }
    res.x = pack_bf16(f[0], f[1]);
    res.y = pack_bf16(f[2], f[3]);
    res.z = pack_bf16(f[4], f[5]);
    res.w = pack_bf16(f[6], f[7]);
  }
  *reinterpret_cast<uint4*>(dst) = res;
}

// Prepass: K~ = bf16(norm (+ rope)(K)) for every row, one 16-byte chunk per
// thread, written in K's own [B, Skv, N*D] layout.
template <bool ROPE>
__global__ void transform_rows_kernel(const __nv_bfloat16* x, const float* rstat,
                                      const float* g, const __nv_bfloat16* cos,
                                      const __nv_bfloat16* sin,
                                      __nv_bfloat16* out, size_t rows, int S,
                                      int N) {
  const size_t per_row = size_t(N) * CHUNKS;
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * per_row) return;
  const size_t r = idx / per_row;
  const int c = int(idx % per_row) * 8;  // column inside N*D
  const int s = int(r % S), d0 = c % D;
  const size_t off = r * per_row * 8 + c;
  transform_chunk<ROPE>(out + off, x + off, rstat[r], g + c,
                        ROPE ? cos + size_t(s) * D + d0 : nullptr,
                        ROPE ? sin + size_t(s) * D + d0 : nullptr, true);
}

template <bool ROPE>
__global__ void __launch_bounds__(NTHREADS, 2)
fused_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * LDS;      // two K~ tile buffers
  __nv_bfloat16* Vs = Ks + 2 * BN * LDS;  // two V tile buffers

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const size_t stride = size_t(p.N) * D;
  const int col_h = h * D;

  int k_len = p.Skv;
  if (p.k_lens != nullptr) k_len = min(max(p.k_lens[b], 0), p.Skv);

  // kv tiles this q tile can see: up to k_len, and inside the window of
  // at least one of its rows
  int n_lo = 0, n_hi = (k_len + BN - 1) / BN;
  if (p.wl >= 0) n_lo = max(q0 - p.wl, 0) / BN;
  if (p.wr >= 0) n_hi = min(n_hi, (q0 + BM - 1 + p.wr) / BN + 1);

  auto load_tile = [&](int n, int buf) {
    const int kv0 = n * BN;
    __nv_bfloat16* kb = Ks + buf * BN * LDS;
    __nv_bfloat16* vb = Vs + buf * BN * LDS;
    for (int idx = tid; idx < BN * CHUNKS; idx += NTHREADS) {
      const int r = idx / CHUNKS, c0 = (idx % CHUNKS) * 8;
      const int row = kv0 + r;
      const bool valid = row < p.Skv;
      const size_t off = (size_t(b) * p.Skv + (valid ? row : 0)) * stride + col_h + c0;
      cp_async16(kb + r * LDS + c0, p.k + off, valid);
      cp_async16(vb + r * LDS + c0, p.v + off, valid);
    }
    cp_async_commit();
  };
  if (n_lo < n_hi) load_tile(n_lo, 0);  // in flight while the q tile transforms

  // q tile: normalise (+ rotate) once into shared memory
  for (int idx = tid; idx < BM * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS, c0 = (idx % CHUNKS) * 8;
    const int row = q0 + r;
    const bool valid = row < p.Sq;
    const size_t grow = size_t(b) * p.Sq + (valid ? row : 0);
    transform_chunk<ROPE>(Qs + r * LDS + c0, p.q + grow * stride + col_h + c0,
                          valid ? p.rq[grow] : 0.f, p.gq + col_h + c0,
                          ROPE ? p.cos + size_t(valid ? row : 0) * D + c0 : nullptr,
                          ROPE ? p.sin + size_t(valid ? row : 0) * D + c0 : nullptr,
                          valid);
  }

  // this thread's q rows: row0 + 16*mt (accumulator e = 0,1) and +8 (e = 2,3)
  const int row0 = q0 + warp * 16 * MT + grp;
  float m_run[MT][2], l_run[MT][2];
  float o[MT][16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = NEG_INF;
    l_run[mt][0] = l_run[mt][1] = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) o[mt][t][0] = o[mt][t][1] = o[mt][t][2] = o[mt][t][3] = 0.f;
  }

  // per-lane ldmatrix row addresses: Q (A operand) and K~ (B operand)
  const __nv_bfloat16* qa = Qs + (warp * 16 * MT + (mat & 1) * 8 + mrow) * LDS + (mat >> 1) * 8;
  const int k_off = ((mat >> 1) * 8 + mrow) * LDS + (mat & 1) * 8;
  const int v_off = ((mat & 1) * 8 + mrow) * LDS + (mat >> 1) * 8;

  for (int n = n_lo; n < n_hi; ++n) {
    const int kv0 = n * BN;
    const int buf = (n - n_lo) & 1;
    if (n + 1 < n_hi) {
      load_tile(n + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile n (and, first time, the q tile) visible to all
    const __nv_bfloat16* kb = Ks + buf * BN * LDS;
    const __nv_bfloat16* vb = Vs + buf * BN * LDS;

    // S = Q K~^T for this warp's MT x 16 rows x 64 keys; each K~ fragment
    // feeds all MT row tiles
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(qa + mt * 16 * LDS + kk * 16, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(kb + jp * 16 * LDS + k_off + kk * 16, b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * jp], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
          mma_bf16(s[mt][2 * jp + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b2, b3);
        }
      }
    }

    const bool full = kv0 + BN <= k_len &&
                      (p.wl < 0 || kv0 >= q0 + BM - 1 - p.wl) &&
                      (p.wr < 0 || kv0 + BN - 1 <= q0 + p.wr);
    if (!full) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + j * 8 + tig * 2 + (e & 1);
            const int row = row0 + 16 * mt + (e < 2 ? 0 : 8);
            const bool ok = col < k_len && (p.wl < 0 || col >= row - p.wl) &&
                            (p.wr < 0 || col <= row + p.wr);
            if (!ok) s[mt][j][e] = NEG_INF;
          }
        }
      }
    }

    // online softmax (exp2 domain) for each row: e = 0,1 (r = 0), 2,3 (r = 1)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][r], mx);
        const float alpha = exp2f(m_run[mt][r] - m_new);
        const bool none = m_new == NEG_INF;  // no visible key yet: P = 0
        m_run[mt][r] = m_new;
        float rowsum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = none ? 0.f : exp2f(s[mt][j][2 * r + e] - m_new);
            s[mt][j][2 * r + e] = pv;
            rowsum += pv;
          }
        }
        l_run[mt][r] = l_run[mt][r] * alpha + rowsum;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          o[mt][t][2 * r] *= alpha;
          o[mt][t][2 * r + 1] *= alpha;
        }
      }
    }

    // O += bf16(P) V; each V fragment feeds all MT row tiles
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(vb + kk * 16 * LDS + v_off + dp * 16, b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
          mma_bf16(o[mt][2 * dp + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b2, b3);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  // finalize: l summed over the quad, out = acc * (1/l), l == 0 -> 0
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = (l == 0.f) ? 1.f : 1.f / l;
      const int row = row0 + 16 * mt + 8 * r;
      if (row < p.Sq) {
        __nv_bfloat16* dst = p.out + (size_t(b) * p.Sq + row) * stride + col_h + tig * 2;
#pragma unroll
        for (int t = 0; t < 16; ++t)
          *reinterpret_cast<uint32_t*>(dst + t * 8) =
              pack_bf16(o[mt][t][2 * r] * inv, o[mt][t][2 * r + 1] * inv);
      }
    }
  }
}

template <bool ROPE>
cudaError_t launch(Params p, const __nv_bfloat16* k_raw, int B, cudaStream_t stream) {
  const size_t rows = size_t(B) * p.Skv;
  const size_t chunks = rows * p.N * CHUNKS;
  transform_rows_kernel<ROPE><<<unsigned((chunks + 255) / 256), 256, 0, stream>>>(
      k_raw, p.rk, p.gk, p.cos, p.sin, const_cast<__nv_bfloat16*>(p.k), rows,
      p.Skv, p.N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_attention_kernel<ROPE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BM - 1) / BM, p.N, B);
  fused_attention_kernel<ROPE><<<grid, NTHREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; cos/sin may be
// null when rope == 0, k_lens may be null (every key visible); k_scratch is
// a [B, Skv, N*128] bf16 buffer for the transformed K. Returns the
// cudaError_t of the launches (0 = launched).
extern "C" int vc_fused_attention(const void* q, const void* k, const void* v,
                                  const void* rq, const void* rk,
                                  const void* gq, const void* gk,
                                  const void* cos, const void* sin,
                                  const void* k_lens, void* k_scratch, void* out,
                                  int B, int Sq, int Skv, int N, int wl, int wr,
                                  int rope, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_scratch);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.rq = static_cast<const float*>(rq);
  p.rk = static_cast<const float*>(rk);
  p.gq = static_cast<const float*>(gq);
  p.gk = static_cast<const float*>(gk);
  p.cos = static_cast<const __nv_bfloat16*>(cos);
  p.sin = static_cast<const __nv_bfloat16*>(sin);
  p.k_lens = static_cast<const int*>(k_lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.Sq = Sq;
  p.Skv = Skv;
  p.N = N;
  p.wl = wl;
  p.wr = wr;
  const __nv_bfloat16* k_raw = static_cast<const __nv_bfloat16*>(k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(rope ? launch<true>(p, k_raw, B, s) : launch<false>(p, k_raw, B, s));
}
