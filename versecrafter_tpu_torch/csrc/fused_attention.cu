// Fused qk-RMSNorm (+ RoPE) flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_attention_fused_pallas`
// (versecrafter_tpu/kernels/flash_attention.py:800, body `_fa_kernel` :94)
// in its three inference flavors:
//   ROPE=true  — self-attention (fused_rope_rms_attention): per-tile
//                bf16(x * rstat * g), then x*cosI + pairswap(x)*sinI;
//   ROPE=false — cross-attention (fused_rms_cross_attention): norm only;
//   INT8=true  — the self-attention flavor with int8 QK^T scoring
//                (`int8_score`, _fa_kernel :133-140, :171-185, :209-212,
//                :248-251, :277-281), described at the end of this note.
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
//
// INT8: the bf16-rounded q~/k~ rows are quantized per (row, head):
// sc = max(max|t|, 1e-20) / 127 in fp32, code = round_half_even(t / sc)
// (IEEE division, __float2int_rn; a row's 128 channels sit on 16 lanes, so
// the max is a 16-lane shuffle reduction). The prepass writes int8 K codes
// and an fp32 scale per (b, h, row) once, as the Pallas resident mode
// quantizes k once per (b, h); q is quantized in the main kernel's
// prologue. QK^T runs as mma.sync m16n8k32 s8 x s8 -> s32 (fragments from
// ldmatrix over 16-byte rows of codes, which lay out exactly as the s8
// A/B fragments want; vc_mma_s8_tile below lets a test check this), and
// each score is float(s32) * q scale * k scale, in that order, with
// sm_scale*log2(e) riding in the q statistic. The integer sums are exact
// (< 2^24), so the scores equal the plain version's whenever the codes do.
// The s32 -> fp32 conversion would run at the quarter-rate conversion pipe
// beside exp2, so the accumulators start from the bits of 1.5 * 2^23 and
// one FADD recovers float(s32) exactly.
// Mask, online softmax and bf16 PV are the bf16 flavor's. The int8 K tile
// is half the bytes of the bf16 one; the QK^T products run at the int8
// tensor-core rate, twice bf16's.

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
// INT8 layout (bytes): q codes [BM][LDQ8], 2 x k codes [BN][LDQ8], 2 x V
// [BN][LDS] bf16, 2 x k scales [BN], q scales [BM]
constexpr int LDQ8 = D + 16;    // padded code row: conflict-free ldmatrix
constexpr size_t SMEM_Q8 = size_t(BM) * LDQ8;
constexpr size_t SMEM_K8 = size_t(BN) * LDQ8;
constexpr size_t SMEM_V = size_t(BN) * LDS * sizeof(__nv_bfloat16);
constexpr size_t SMEM_BYTES_INT8 =
    SMEM_Q8 + 2 * SMEM_K8 + 2 * SMEM_V + 2 * BN * sizeof(float) + BM * sizeof(float);
// 1.5 * 2^23, bits 0x4B400000: an int added to these bits gives the float
// I2F_BIAS + int exactly while |int| < 2^22 (a 128-channel s8 dot is at
// most 128 * 127^2 < 2^21 in magnitude)
constexpr float I2F_BIAS = 12582912.f;

struct Params {
  const __nv_bfloat16 *q, *k, *v;  // k: the transformed K~ rows
  const int8_t* k8;              // INT8: K~ codes [B, Skv, N*D]
  const float* kscale;           // INT8: k scales [B, N, kscale_ld]
  int kscale_ld;                 // Skv rounded up to BN
  const float *rq, *rk;          // [B, Sq], [B, Skv] row statistics
  const float *gq, *gk;          // [N*D] norm scales
  const __nv_bfloat16 *cos, *sin;  // [>= max(Sq, Skv), D] interleaved tables
  const int *k_lens;             // [B] or null
  __nv_bfloat16 *out;            // [B, Sq, N*D]
  int Sq, Skv, N, wl, wr;
};

// 8 consecutive channels of one row: fp32 (x * rstat) * g, optional RoPE,
// one rounding to bf16, packed in 16 bytes. Invalid rows (past the
// sequence) give zeros.
template <bool ROPE>
__device__ __forceinline__ uint4 transform8(
    const __nv_bfloat16* src, float rstat, const float* g,
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
  return res;
}

// 8 bf16 values of a row whose 128 channels lie on 16 neighbouring lanes
// (lanes 0-15 or 16-31; every lane of the warp must call) -> 8 int8 codes
// in 8 bytes, channel order, and the row's scale max(max|t|, 1e-20) / 127.
__device__ __forceinline__ uint2 quantize8(const uint4& res, float& scale) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&res);
  float f[8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
    amax = fmaxf(amax, fmaxf(fabsf(p.x), fabsf(p.y)));
  }
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  scale = fmaxf(amax, 1e-20f) / 127.f;
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = __float2int_rn(f[i] / scale);  // IEEE division, half to even
    w[i >> 2] |= (uint32_t(c) & 0xffu) << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

// c += a (16x32 s8, row-major) * b (32x8 s8, column-major), s32
// accumulators held bit-cast in fp32 registers
__device__ __forceinline__ void mma_s8(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  int c0 = __float_as_int(c[0]), c1 = __float_as_int(c[1]);
  int c2 = __float_as_int(c[2]), c3 = __float_as_int(c[3]);
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  c[0] = __int_as_float(c0);
  c[1] = __int_as_float(c1);
  c[2] = __int_as_float(c2);
  c[3] = __int_as_float(c3);
}

__device__ __forceinline__ void ldmatrix_x4_b8(const int8_t* p, uint32_t& r0, uint32_t& r1,
                                               uint32_t& r2, uint32_t& r3) {
  ldmatrix_x4(reinterpret_cast<const __nv_bfloat16*>(p), r0, r1, r2, r3);
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
  *reinterpret_cast<uint4*>(out + off) =
      transform8<ROPE>(x + off, rstat[r], g + c, ROPE ? cos + size_t(s) * D + d0 : nullptr,
                       ROPE ? sin + size_t(s) * D + d0 : nullptr, true);
}

// INT8 prepass: int8 codes of K~ for every row in K's [B, Skv, N*D]
// layout, and one fp32 scale per (b, h, row) in [B, N, kscale_ld]. One
// 16-byte chunk per thread; a row-head's 16 chunks are 16 neighbouring
// lanes (no thread returns early: the scale's reduction needs all lanes).
template <bool ROPE>
__global__ void quantize_rows_kernel(const __nv_bfloat16* x, const float* rstat,
                                     const float* g, const __nv_bfloat16* cos,
                                     const __nv_bfloat16* sin, int8_t* out,
                                     float* scale, size_t rows, int S, int N,
                                     int scale_ld) {
  const size_t per_row = size_t(N) * CHUNKS;
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool valid = idx < rows * per_row;
  const size_t r = valid ? idx / per_row : 0;
  const int c = valid ? int(idx % per_row) * 8 : 0;  // column inside N*D
  const int s = int(r % S), d0 = c % D;
  const size_t off = r * per_row * 8 + c;
  const uint4 t = transform8<ROPE>(x + off, rstat[r], g + c,
                                   ROPE ? cos + size_t(s) * D + d0 : nullptr,
                                   ROPE ? sin + size_t(s) * D + d0 : nullptr, valid);
  float sc;
  const uint2 codes = quantize8(t, sc);
  if (valid) {
    *reinterpret_cast<uint2*>(out + off) = codes;
    if (d0 == 0) scale[(size_t(r / S) * N + c / D) * scale_ld + s] = sc;
  }
}

template <bool ROPE, bool INT8>
__global__ void __launch_bounds__(NTHREADS, 2)
fused_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // bf16: Q~ [BM][LDS], 2 x K~ [BN][LDS], 2 x V [BN][LDS];
  // INT8: q codes, 2 x k codes, 2 x V, 2 x k scales, q scales
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * LDS;
  __nv_bfloat16* Vs = INT8 ? reinterpret_cast<__nv_bfloat16*>(smem_raw + SMEM_Q8 + 2 * SMEM_K8)
                           : Ks + 2 * BN * LDS;
  int8_t* Q8 = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* K8 = Q8 + SMEM_Q8;
  float* ksc = reinterpret_cast<float*>(smem_raw + SMEM_Q8 + 2 * SMEM_K8 + 2 * SMEM_V);
  float* qsc = ksc + 2 * BN;

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
    __nv_bfloat16* vb = Vs + buf * BN * LDS;
    for (int idx = tid; idx < BN * CHUNKS; idx += NTHREADS) {
      const int r = idx / CHUNKS, c0 = (idx % CHUNKS) * 8;
      const int row = kv0 + r;
      const bool valid = row < p.Skv;
      const size_t off = (size_t(b) * p.Skv + (valid ? row : 0)) * stride + col_h + c0;
      if (!INT8) cp_async16(Ks + buf * BN * LDS + r * LDS + c0, p.k + off, valid);
      cp_async16(vb + r * LDS + c0, p.v + off, valid);
    }
    if (INT8) {
      for (int idx = tid; idx < BN * D / 16; idx += NTHREADS) {  // codes, 16 per chunk
        const int r = idx / (D / 16), c0 = (idx % (D / 16)) * 16;
        const int row = kv0 + r;
        const bool valid = row < p.Skv;
        cp_async16(K8 + buf * SMEM_K8 + r * LDQ8 + c0,
                   p.k8 + (size_t(b) * p.Skv + (valid ? row : 0)) * stride + col_h + c0, valid);
      }
      if (tid < BN / 4)  // the tile's k scales (the buffer is padded to BN rows)
        cp_async16(ksc + buf * BN + tid * 4,
                   p.kscale + (size_t(b) * p.N + h) * p.kscale_ld + kv0 + tid * 4, true);
    }
    cp_async_commit();
  };
  if (n_lo < n_hi) load_tile(n_lo, 0);  // in flight while the q tile transforms

  // q tile: normalise (+ rotate) once into shared memory (INT8: quantize)
  for (int idx = tid; idx < BM * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS, c0 = (idx % CHUNKS) * 8;
    const int row = q0 + r;
    const bool valid = row < p.Sq;
    const size_t grow = size_t(b) * p.Sq + (valid ? row : 0);
    const uint4 t = transform8<ROPE>(p.q + grow * stride + col_h + c0,
                                     valid ? p.rq[grow] : 0.f, p.gq + col_h + c0,
                                     ROPE ? p.cos + size_t(valid ? row : 0) * D + c0 : nullptr,
                                     ROPE ? p.sin + size_t(valid ? row : 0) * D + c0 : nullptr,
                                     valid);
    if (INT8) {  // a row's 16 chunks are 16 neighbouring lanes
      float sc;
      *reinterpret_cast<uint2*>(Q8 + r * LDQ8 + c0) = quantize8(t, sc);
      if (c0 == 0) qsc[r] = sc;
    } else {
      *reinterpret_cast<uint4*>(Qs + r * LDS + c0) = t;
    }
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
  // per-lane ldmatrix row addresses: Q (A operand) and K~ (B operand); the
  // int8 codes use the same pattern over 16-byte rows
  const __nv_bfloat16* qa = Qs + (warp * 16 * MT + (mat & 1) * 8 + mrow) * LDS + (mat >> 1) * 8;
  const int k_off = ((mat >> 1) * 8 + mrow) * LDS + (mat & 1) * 8;
  const int v_off = ((mat & 1) * 8 + mrow) * LDS + (mat >> 1) * 8;
  const int8_t* qa8 = Q8 + (warp * 16 * MT + (mat & 1) * 8 + mrow) * LDQ8 + (mat >> 1) * 16;
  const int k_off8 = ((mat >> 1) * 8 + mrow) * LDQ8 + (mat & 1) * 16;

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
    const __nv_bfloat16* vb = Vs + buf * BN * LDS;

    // S = Q K~^T for this warp's MT x 16 rows x 64 keys; each K~ fragment
    // feeds all MT row tiles
    float s[MT][8][4];
    if (INT8) {
      // the s32 accumulators live in s's registers, bit-cast, starting from
      // the bits of I2F_BIAS, so each holds I2F_BIAS + sum as a float
      const int8_t* kb8 = K8 + buf * SMEM_K8;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = I2F_BIAS;
      }
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4_b8(qa8 + mt * 16 * LDQ8 + kk * 32, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_b8(kb8 + jp * 16 * LDQ8 + k_off8 + kk * 32, b0, b1, b2, b3);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_s8(s[mt][2 * jp], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
            mma_s8(s[mt][2 * jp + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b2, b3);
          }
        }
      }
      // float(s32) * q scale * k scale, in that order; the exact float(s32)
      // is (I2F_BIAS + sum) - I2F_BIAS, a full-rate FADD instead of I2F
      const float* kc = ksc + buf * BN;
      float qs[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        qs[mt][0] = qsc[warp * 16 * MT + 16 * mt + grp];
        qs[mt][1] = qsc[warp * 16 * MT + 16 * mt + grp + 8];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 ks = *reinterpret_cast<const float2*>(kc + j * 8 + tig * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          s[mt][j][0] = (s[mt][j][0] - I2F_BIAS) * qs[mt][0] * ks.x;
          s[mt][j][1] = (s[mt][j][1] - I2F_BIAS) * qs[mt][0] * ks.y;
          s[mt][j][2] = (s[mt][j][2] - I2F_BIAS) * qs[mt][1] * ks.x;
          s[mt][j][3] = (s[mt][j][3] - I2F_BIAS) * qs[mt][1] * ks.y;
        }
      }
    } else {
      const __nv_bfloat16* kb = Ks + buf * BN * LDS;
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

template <bool ROPE, bool INT8>
cudaError_t launch(Params p, const __nv_bfloat16* k_raw, int B, cudaStream_t stream) {
  const size_t rows = size_t(B) * p.Skv;
  const size_t chunks = rows * p.N * CHUNKS;
  const unsigned blocks = unsigned((chunks + 255) / 256);
  if (INT8) {
    quantize_rows_kernel<ROPE><<<blocks, 256, 0, stream>>>(
        k_raw, p.rk, p.gk, p.cos, p.sin, const_cast<int8_t*>(p.k8),
        const_cast<float*>(p.kscale), rows, p.Skv, p.N, p.kscale_ld);
  } else {
    transform_rows_kernel<ROPE><<<blocks, 256, 0, stream>>>(
        k_raw, p.rk, p.gk, p.cos, p.sin, const_cast<__nv_bfloat16*>(p.k), rows,
        p.Skv, p.N);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = INT8 ? SMEM_BYTES_INT8 : SMEM_BYTES;
  err = cudaFuncSetAttribute(fused_attention_kernel<ROPE, INT8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BM - 1) / BM, p.N, B);
  fused_attention_kernel<ROPE, INT8><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// One 16x8x32 int8 tile product through the int8 flavor's fragment path
// (codes staged in shared memory at the padded row stride, ldmatrix, mma
// m16n8k32 s8): c[16][8] = a[16][32] . b[8][32]^T. One warp.
__global__ void mma_s8_tile_kernel(const int8_t* a, const int8_t* b, int* c) {
  __shared__ __align__(16) int8_t as[16 * LDQ8];
  __shared__ __align__(16) int8_t bs[16 * LDQ8];
  const int lane = threadIdx.x, mat = lane >> 3, mrow = lane & 7;
  const int grp = lane >> 2, tig = lane & 3;
  for (int i = lane; i < 16 * 32; i += 32) {
    as[(i / 32) * LDQ8 + i % 32] = a[i];
    bs[(i / 32) * LDQ8 + i % 32] = i < 8 * 32 ? b[i] : 0;
  }
  __syncwarp();
  uint32_t a0, a1, a2, a3, b0, b1, b2, b3;
  ldmatrix_x4_b8(as + ((mat & 1) * 8 + mrow) * LDQ8 + (mat >> 1) * 16, a0, a1, a2, a3);
  ldmatrix_x4_b8(bs + ((mat >> 1) * 8 + mrow) * LDQ8 + (mat & 1) * 16, b0, b1, b2, b3);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  mma_s8(acc, a0, a1, a2, a3, b0, b1);
  c[grp * 8 + tig * 2] = __float_as_int(acc[0]);
  c[grp * 8 + tig * 2 + 1] = __float_as_int(acc[1]);
  c[(grp + 8) * 8 + tig * 2] = __float_as_int(acc[2]);
  c[(grp + 8) * 8 + tig * 2 + 1] = __float_as_int(acc[3]);
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; cos/sin may be
// null when rope == 0, k_lens may be null (every key visible). k_scratch is
// a [B, Skv, N*128] buffer for the transformed K: bf16, or int8 codes when
// int8 != 0, which also needs k_scale, an fp32 [B, N, Skv rounded up to
// 64] buffer of zeros for the per-row k scales. int8 needs rope. Returns
// the cudaError_t of the launches (0 = launched).
extern "C" int vc_fused_attention(const void* q, const void* k, const void* v,
                                  const void* rq, const void* rk,
                                  const void* gq, const void* gk,
                                  const void* cos, const void* sin,
                                  const void* k_lens, void* k_scratch,
                                  void* k_scale, void* out,
                                  int B, int Sq, int Skv, int N, int wl, int wr,
                                  int rope, int int8, void* stream) {
  if (int8 && !rope) return int(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_scratch);
  p.k8 = static_cast<const int8_t*>(k_scratch);
  p.kscale = static_cast<const float*>(k_scale);
  p.kscale_ld = (Skv + BN - 1) / BN * BN;
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
  if (int8) return int(launch<true, true>(p, k_raw, B, s));
  return int(rope ? launch<true, false>(p, k_raw, B, s) : launch<false, false>(p, k_raw, B, s));
}

// c [16, 8] int32 = a [16, 32] int8 . b [8, 32] int8 ^T, through the int8
// flavor's ldmatrix + mma.sync m16n8k32 fragment path (a check of that
// layout). Device pointers; returns the launch's cudaError_t.
extern "C" int vc_mma_s8_tile(const void* a, const void* b, void* c, void* stream) {
  mma_s8_tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int*>(c));
  return int(cudaGetLastError());
}
