// Plain flash attention over head-major [B, N, S, 128] for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_attention_pallas`
// (versecrafter_tpu/kernels/flash_attention.py:363, body `_fa_kernel` :94
// with fused=False) in its two flavors:
//   STATS=true  — the training forward (`_fa_diff` fwd rule, :466): q is
//                 scaled by sm_scale and rounded to bf16 once, scores in the
//                 natural-log domain, and the row max m and sum l (fp32
//                 [B, N, Sq]) are written for the backward's recompute. The
//                 backward (csrc/flash_attention_bwd.cu) folds sm_scale into
//                 q with the same single rounding, so its recomputed P sums
//                 to 1 per row;
//   STATS=false — the inference flavor: sm_scale*log2(e) folded into q,
//                 exp2 scores, no stats.
// k_lens masking skips KV tiles past each batch element's key length, and a
// (left, right) window (-1 = unbounded) skips tiles outside every row's
// window. Masked keys contribute exactly zero, also in a row whose first
// visited tile holds none of its keys; a row that sees no key writes 0,
// m = NEG_INF and l = 0. Rows past Sq (32,760 is no multiple of 64 or 128)
// load as zeros and are not written.
//
// What bounds it on an H100: at the training shape (S = 32,760, 12 heads,
// batch 1) self-attention does 4*12*S^2*128 = 6.6e12 FLOP against ~0.3 GB
// of I/O: tensor-core bound, ~6.7 ms at 989 TFLOP/s. Cross-attention (512
// keys) does 1.0e11 FLOP against ~0.2 GB: ~0.1 ms either way.
//
// Design: the loop of csrc/fused_attention.cu without its qk transform and
// K prepass. One CTA per (q tile of 128 rows, head, batch), 4 warps of 32 q
// rows; the Pallas sequential kv grid axis is a loop over 64-row K/V tiles,
// double-buffered in shared memory with cp.async. mma.sync m16n8k16 bf16
// with fp32 accumulators; each warp owns two 16-row mma tiles so every K/V
// fragment loaded from shared memory feeds two MMAs. Rows are padded to 136
// elements for conflict-free ldmatrix. No wgmma/TMA yet.

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
constexpr size_t SMEM_BYTES = size_t(BM + 4 * BN) * LDS * sizeof(__nv_bfloat16);

struct Params {
  const __nv_bfloat16 *q, *k, *v;  // [B, N, Sq|Skv, D]
  const int* k_lens;               // [B] or null
  __nv_bfloat16* out;              // [B, N, Sq, D]
  float *m, *l;                    // [B, N, Sq] (STATS only)
  int N, Sq, Skv, wl, wr;
  float scale;                     // folded into q before the bf16 rounding
};

template <bool STATS>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * LDS;      // two K tile buffers
  __nv_bfloat16* Vs = Ks + 2 * BN * LDS;  // two V tile buffers

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const size_t bh = size_t(b) * p.N + h;
  const __nv_bfloat16* qg = p.q + bh * p.Sq * D;
  const __nv_bfloat16* kg = p.k + bh * p.Skv * D;
  const __nv_bfloat16* vg = p.v + bh * p.Skv * D;

  int k_len = p.Skv;
  if (p.k_lens != nullptr) k_len = min(max(p.k_lens[b], 0), p.Skv);

  // kv tiles this q tile can see: up to k_len, and inside the window of at
  // least one of its rows
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
      const size_t off = size_t(valid ? row : 0) * D + c0;
      cp_async16(kb + r * LDS + c0, kg + off, valid);
      cp_async16(vb + r * LDS + c0, vg + off, valid);
    }
    cp_async_commit();
  };
  if (n_lo < n_hi) load_tile(n_lo, 0);  // in flight while the q tile scales

  // q tile: bf16(q * scale) once into shared memory; rows past Sq are zero
  for (int idx = tid; idx < BM * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS, c0 = (idx % CHUNKS) * 8;
    const int row = q0 + r;
    uint4 res = make_uint4(0u, 0u, 0u, 0u);
    if (row < p.Sq) {
      uint4 raw = *reinterpret_cast<const uint4*>(qg + size_t(row) * D + c0);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t* o32 = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(x2[i]);
        o32[i] = pack_bf16(f.x * p.scale, f.y * p.scale);
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * LDS + c0) = res;
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

  // per-lane ldmatrix row addresses: Q (A operand), K (B), V (B, transposed)
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

    // S = Qs K^T for this warp's MT x 16 rows x 64 keys
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

    // online softmax for each row: e = 0,1 (r = 0), 2,3 (r = 1); the stats
    // flavor's scores are natural-log, exp(x) = exp2(x * log2(e))
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
        const float alpha = STATS ? exp2f((m_run[mt][r] - m_new) * LOG2E_F)
                                  : exp2f(m_run[mt][r] - m_new);
        const bool none = m_new == NEG_INF;  // no visible key yet: P = 0
        m_run[mt][r] = m_new;
        float rowsum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[mt][j][2 * r + e] - m_new;
            const float pv = none ? 0.f : (STATS ? exp2f(x * LOG2E_F) : exp2f(x));
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
        __nv_bfloat16* dst = p.out + (bh * p.Sq + row) * D + tig * 2;
#pragma unroll
        for (int t = 0; t < 16; ++t)
          *reinterpret_cast<uint32_t*>(dst + t * 8) =
              pack_bf16(o[mt][t][2 * r] * inv, o[mt][t][2 * r + 1] * inv);
        if (STATS && tig == 0) {
          p.m[bh * p.Sq + row] = m_run[mt][r];
          p.l[bh * p.Sq + row] = l;
        }
      }
    }
  }
}

template <bool STATS>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BM - 1) / BM, p.N, B);
  flash_attention_kernel<STATS><<<grid, NTHREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; k_lens may be null
// (every key visible); m and l are written only when stats != 0. scale is
// sm_scale (stats) or sm_scale*log2(e) (inference). Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int vc_flash_attention(const void* q, const void* k, const void* v,
                                  const void* k_lens, void* out, void* m, void* l,
                                  int B, int N, int Sq, int Skv, int wl, int wr,
                                  int stats, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.k_lens = static_cast<const int*>(k_lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.N = N;
  p.Sq = Sq;
  p.Skv = Skv;
  p.wl = wl;
  p.wr = wr;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(stats ? launch<true>(p, B, s) : launch<false>(p, B, s));
}
