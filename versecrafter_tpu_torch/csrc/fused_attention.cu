// Fused qk-RMSNorm (+ RoPE) flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_attention_fused_pallas`
// (versecrafter_tpu/kernels/flash_attention.py:800, body `_fa_kernel` :94)
// in its three inference flavors:
//   ROPE=true  — self-attention (fused_rope_rms_attention): bf16(x * rstat
//                * g), then x*cosI + pairswap(x)*sinI, rounded once;
//   ROPE=false — cross-attention (fused_rms_cross_attention): norm only;
//   int8       — the self-attention flavor with int8 QK^T scoring
//                (`int8_score`, _fa_kernel :133-140, :171-185, :209-212,
//                :248-251, :277-281), described at the end of this note.
// q/k/v arrive raw in their flat [B, S, N*128] projection layout; a head is
// the columns h*128 .. h*128+127, so no relayout pass exists. rstat_q
// carries sm_scale*log2(e), so scores are in the exp2 domain. Online softmax
// in fp32; P is rounded to bf16 before PV with fp32 accumulation; l is
// summed from the fp32 P; a row with l == 0 writes 0. Masked keys (past
// k_len, past Skv, outside the window) contribute exactly zero — also in a
// row whose first visited tile holds none of its keys.
//
// What bounds it on an H100: at the 480p x 81f shape (S = 32,760, 12 heads,
// CFG batch 2) the self flavor does 4*2*12*S^2*128 = 1.3e13 FLOP against
// ~0.8 GB of I/O, so it is tensor-core bound (~13.3 ms at 989 TFLOP/s); the
// cross flavor (512 keys) does 2.1e11 FLOP against ~0.4 GB (~0.21 ms),
// with a q tile that is read, normalised and written back around only four
// key tiles.
//
// The bf16 flavors (fused_wgmma_kernel). A prepass normalises (+ rotates) K
// once per row into a scratch buffer the wrapper allocates (the Pallas
// resident-KV mode's "rotate K once per (b, h)"). The main kernel is
// persistent: each CTA walks work items (128 q rows of one (b, h), q tile
// fastest, so the CTAs in flight share one head's K~/V in L2). A CTA is a
// producer warp and two consumer warpgroups of 64 q rows each; setmaxnreg
// hands the producer's registers to the consumers (240 / 24). The producer
// feeds, by TMA over 3-D tensor maps of the flat layout ({N*128, S, B},
// boxes of 64 columns x 128 rows, 128-byte swizzle; rows past S read as
// zeros and a box never reaches the next batch element), the raw q tile of
// each item and a ring of STAGES [128-key K~, V] stages, with a full and an
// empty mbarrier a stage. The consumers normalise (+ rotate) their q rows in
// place in the swizzled tile (a thread owns one 16-byte chunk of a row:
// whole RoPE pairs), sync the warpgroup and load q~ as register A
// fragments (ldmatrix), which frees the q tile at once: the next item's raw
// rows load during this item. S = Q~ K~^T is wgmma m64n128k16 with A from
// registers and K~ K-major in shared memory; O += bf16(P) V is wgmma
// m64n128k16 with P from registers and V read MN-major. Inside a
// warpgroup, S of tile n and PV of tile n-1 are issued back to back and the
// softmax of tile n runs while PV of tile n-1 is in flight; O is rescaled
// just before the next PV is issued. The two warpgroups take turns at the
// tensor cores through two named barriers (ping-pong), so one's softmax
// also runs under the other's products. The `full` fast path skips the mask
// on tiles wholly inside k_len and the window; tiles outside [n_lo, n_hi)
// are never loaded. O leaves through 16-byte stores after a transpose
// inside each quad. No atomics and no split over keys: every output is
// reduced in a fixed order by one thread, so reruns are bit-identical.
// `vc_fused_layout_check` runs both product forms over 128-row tiles read
// through the flat map on integer-valued tiles; the CUDA tests hold it to
// the exact integer products.
//
// INT8 (int8_attention_kernel, warp-level MMA): the bf16-rounded q~/k~
// rows are quantized per (row, head): sc = max(max|t|, 1e-20) / 127 in
// fp32, code = round_half_even(t / sc) (IEEE division, __float2int_rn; a
// row's 128 channels sit on 16 lanes, so the max is a 16-lane shuffle
// reduction). The prepass writes int8 K codes and an fp32 scale per (b, h,
// row) once, as the Pallas resident mode quantizes k once per (b, h); q is
// quantized in the main kernel's prologue. One CTA per (128 q rows, head,
// batch), 4 warps of 32 rows, 64-key tiles double-buffered with cp.async.
// QK^T runs as mma.sync m16n8k32 s8 x s8 -> s32 (fragments from ldmatrix
// over 16-byte rows of codes, which lay out exactly as the s8 A/B fragments
// want; vc_mma_s8_tile below lets a test check this), and each score is
// float(s32) * q scale * k scale, in that order, with sm_scale*log2(e)
// riding in the q statistic. The integer sums are exact (< 2^24), so the
// scores equal the plain version's whenever the codes do. The s32 -> fp32
// conversion would run at the quarter-rate conversion pipe beside exp2, so
// the accumulators start from the bits of 1.5 * 2^23 and one FADD recovers
// float(s32) exactly. PV is mma.sync m16n8k16 bf16 on ldmatrix.trans
// fragments of V.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int D = 128;          // head_dim (the wrapper checks it)
constexpr int CHUNKS = D / 8;   // 16-byte chunks per row

// ---- int8 flavor (warp-level MMA) ------------------------------------------
constexpr int BM = 128;         // q rows per CTA
constexpr int BN = 64;          // kv rows per tile
constexpr int MT = 2;           // 16-row mma tiles per warp
constexpr int NTHREADS = 32 * BM / (16 * MT);  // 4 warps of 32 q rows
constexpr int LDS = D + 8;      // padded shared-memory row, in bf16 elements
// layout (bytes): q codes [BM][LDQ8], 2 x k codes [BN][LDQ8], 2 x V
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
  const __nv_bfloat16 *q, *v;
  const int8_t* k8;              // K~ codes [B, Skv, N*D]
  const float* kscale;           // k scales [B, N, kscale_ld]
  int kscale_ld;                 // Skv rounded up to BN
  const float *rq, *rk;          // [B, Sq], [B, Skv] row statistics
  const float *gq, *gk;          // [N*D] norm scales
  const __nv_bfloat16 *cos, *sin;  // [>= max(Sq, Skv), D] interleaved tables
  const int *k_lens;             // [B] or null
  __nv_bfloat16 *out;            // [B, Sq, N*D]
  int Sq, Skv, N, wl, wr;
};

// ---- bf16 flavors (wgmma + TMA) --------------------------------------------
constexpr int TQ = 128;         // q rows of a work item
constexpr int WG_ROWS = 64;     // of which each consumer warpgroup owns
constexpr int NWG = TQ / WG_ROWS;
constexpr int TK = 128;         // keys of a K~ / V tile
constexpr int STAGES = 3;       // ring depth of the K~ / V tiles
constexpr int WTHREADS = 128 * (NWG + 1);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// a [128 rows, 128 columns] tile: two boxes of [128 rows, 64 columns]
constexpr uint32_t BOX_BYTES = TK * SW_ROW_BYTES;
constexpr uint32_t RTILE_BYTES = 2 * BOX_BYTES;
constexpr uint32_t STAGE_BYTES = 2 * RTILE_BYTES;  // K~ and V
// shared memory from a 1024-byte aligned base: the q tile, the ring, the
// barriers (q full / empty, then full and empty per stage)
constexpr uint32_t RING_OFF = RTILE_BYTES;
constexpr uint32_t WBAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
constexpr size_t WSMEM_BYTES = WBAR_OFF + (2 + 2 * STAGES) * sizeof(uint64_t) + 1024;
// named barriers: the consumer warpgroups' turns at the tensor cores (one
// each), and each warpgroup's q transform
constexpr int BAR_TURN = 1, BAR_QROWS = 3;
static_assert(TQ == TK, "the q tile and the K~ / V tiles share one box shape");

struct WParams {
  const float* rq;                 // [B, Sq], sm_scale*log2(e) folded in
  const float* gq;                 // [N*D]
  const __nv_bfloat16 *cos, *sin;  // [>= Sq, D] interleaved tables (RoPE)
  const int* k_lens;               // [B] or null
  __nv_bfloat16* out;              // [B, Sq, N*D]
  int Sq, Skv, N, wl, wr;
  int q_tiles, items;              // q tiles of a (b, h); work items
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

__global__ void __launch_bounds__(NTHREADS, 2)
int8_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // q codes, 2 x k codes, 2 x V, 2 x k scales, q scales
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + SMEM_Q8 + 2 * SMEM_K8);
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
      cp_async16(vb + r * LDS + c0, p.v + off, valid);
    }
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
    cp_async_commit();
  };
  if (n_lo < n_hi) load_tile(n_lo, 0);  // in flight while the q tile transforms

  // q tile: normalise, rotate and quantize once into shared memory
  for (int idx = tid; idx < BM * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS, c0 = (idx % CHUNKS) * 8;
    const int row = q0 + r;
    const bool valid = row < p.Sq;
    const size_t grow = size_t(b) * p.Sq + (valid ? row : 0);
    const uint4 t = transform8<true>(p.q + grow * stride + col_h + c0,
                                     valid ? p.rq[grow] : 0.f, p.gq + col_h + c0,
                                     p.cos + size_t(valid ? row : 0) * D + c0,
                                     p.sin + size_t(valid ? row : 0) * D + c0, valid);
    float sc;  // a row's 16 chunks are 16 neighbouring lanes
    *reinterpret_cast<uint2*>(Q8 + r * LDQ8 + c0) = quantize8(t, sc);
    if (c0 == 0) qsc[r] = sc;
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
  // per-lane ldmatrix row addresses: q codes (A operand), k codes (B
  // operand, 16-byte rows) and V (B operand, transposed)
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

// ---- bf16 flavors ------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a work item: 128 q rows of one (b, h), and the key tiles they can see (up
// to k_len, and inside the window of at least one of the rows)
struct Item {
  int b, h, q0, k_len, n_lo, n_hi;
  __device__ __forceinline__ Item(const WParams& p, int item) {
    const int bh = item / p.q_tiles;
    q0 = (item - bh * p.q_tiles) * TQ;
    h = bh % p.N;
    b = bh / p.N;
    k_len = p.k_lens == nullptr ? p.Skv : min(max(p.k_lens[b], 0), p.Skv);
    n_lo = 0;
    n_hi = (k_len + TK - 1) / TK;
    if (p.wl >= 0) n_lo = max(q0 - p.wl, 0) / TK;
    if (p.wr >= 0) n_hi = min(n_hi, (q0 + TQ - 1 + p.wr) / TK + 1);
  }
};

struct WSmem {
  uint32_t q, ring, q_full, q_empty, full_bar, empty_bar;
  unsigned char* q_ptr;  // the q tile, for the consumers' in-place transform
  __device__ __forceinline__ explicit WSmem(unsigned char* raw) {
    const uint32_t a = smem_u32(raw);
    const uint32_t pad = ((a + 1023u) & ~1023u) - a;
    q = a + pad;
    q_ptr = raw + pad;
    ring = q + RING_OFF;
    q_full = q + WBAR_OFF;
    q_empty = q_full + 8;
    full_bar = q_empty + 8;
    empty_bar = full_bar + 8 * STAGES;
  }
  __device__ __forceinline__ uint32_t stage(int s) const { return ring + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return full_bar + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return empty_bar + 8 * s; }
  // one thread, before the block-wide barrier that precedes any use
  __device__ __forceinline__ void init_barriers() const {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * NWG);  // lane 0 of every consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NWG);
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

// The row statistics of thread t's q rows (see transform_q_rows), loaded
// before the q tile has arrived
__device__ __forceinline__ void q_row_stats(float (&rs)[WG_ROWS / 8], int t, const WParams& p,
                                            const Item& it, int q0w) {
#pragma unroll
  for (int j = 0; j < WG_ROWS / 8; ++j) {
    const int row = q0w + (t >> 4) + 8 * j;
    rs[j] = row < p.Sq ? p.rq[size_t(it.b) * p.Sq + row] : 0.f;
  }
}

// A consumer warpgroup's 64 rows of the raw q tile, normalised (+ rotated)
// in place in the swizzled layout. Thread t owns the 16-byte chunk t % 16 of
// rows t / 16 + 8j: whole RoPE pairs, one norm-scale slice, and every row
// it touches has the same swizzle phase (row & 7 == t / 16).
template <bool ROPE>
__device__ __forceinline__ void transform_q_rows(unsigned char* rows, int t, const WParams& p,
                                                 const Item& it, int q0w,
                                                 const float (&rs)[WG_ROWS / 8]) {
  const int chunk = t & 15, r0 = t >> 4;
  const float* g = p.gq + it.h * D + chunk * 8;
  unsigned char* base =
      rows + (chunk >> 3) * BOX_BYTES + r0 * SW_ROW_BYTES + (((chunk & 7) ^ r0) << 4);
#pragma unroll (ROPE ? 4 : 8)  // the tables' loads take registers
  for (int j = 0; j < WG_ROWS / 8; ++j) {
    const int row = q0w + r0 + 8 * j;
    const bool valid = row < p.Sq;
    const size_t trow = size_t(valid ? row : 0) * D + chunk * 8;
    __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(base + j * 8 * SW_ROW_BYTES);
    *reinterpret_cast<uint4*>(x) = transform8<ROPE>(
        x, rs[j], g, ROPE ? p.cos + trow : nullptr, ROPE ? p.sin + trow : nullptr, valid);
  }
}

// Online softmax (exp2 domain) of a [64, 128] score tile whose rows are q
// rows (row0, row0 + 8) and columns keys kv0 + ...: masks unless FULL,
// updates the running max and sum, and leaves P in place of S and, per row,
// the factor alpha that O must be scaled by before P V is added to it (O
// may still be in flight here)
template <bool FULL>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&alpha)[2],
                                               float (&m_run)[2], float (&l_run)[2], int row0,
                                               int kv0, int tig, int k_len, int wl, int wr) {
  if (!FULL) {
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + tig * 2 + (e & 1);
        const int row = row0 + (e < 2 ? 0 : 8);
        const bool ok = col < k_len && (wl < 0 || col >= row - wl) && (wr < 0 || col <= row + wr);
        if (!ok) s[4 * j + e] = NEG_INF;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    // no visible key yet: subtracting 0 keeps every masked score at
    // exp2(NEG_INF) = 0 (and alpha at 0 while O and l are still 0)
    const float m_use = m_new == NEG_INF ? 0.f : m_new;
    alpha[r] = ex2(m_run[r] - m_use);
    m_run[r] = m_new;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const float a = ex2(s[4 * j + 2 * r] - m_use), b = ex2(s[4 * j + 2 * r + 1] - m_use);
      s[4 * j + 2 * r] = a;
      s[4 * j + 2 * r + 1] = b;
      sum0 += a;
      sum1 += b;
    }
    l_run[r] = l_run[r] * alpha[r] + (sum0 + sum1);
  }
}

__device__ __forceinline__ void rescale(float (&o)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// One output row held by a quad (word j of thread tig: columns 8j + 2tig and
// 8j + 2tig + 1, packed bf16), written as 16-byte stores: a 4 x 4 word
// transpose inside the quad by two exchanges, after which thread tig holds
// column groups 4m + tig (m = 0..3) whole. Every lane takes part in the
// exchanges; only `valid` rows are written.
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const uint32_t (&w)[D / 8], int tig,
                                          bool valid) {
  const bool odd = tig & 1, high = tig & 2;
#pragma unroll
  for (int m = 0; m < D / 32; ++m) {
    const uint32_t a0 = w[4 * m], a1 = w[4 * m + 1], a2 = w[4 * m + 2], a3 = w[4 * m + 3];
    const uint32_t x = __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);
    const uint32_t y = __shfl_xor_sync(0xffffffffu, odd ? a2 : a3, 1);
    const uint32_t c0 = odd ? x : a0, c1 = odd ? a1 : x, c2 = odd ? y : a2, c3 = odd ? a3 : y;
    const uint32_t u = __shfl_xor_sync(0xffffffffu, high ? c0 : c2, 2);
    const uint32_t v = __shfl_xor_sync(0xffffffffu, high ? c1 : c3, 2);
    if (valid)
      *reinterpret_cast<uint4*>(dst + 8 * (4 * m + tig)) =
          high ? make_uint4(u, v, c2, c3) : make_uint4(c0, c1, u, v);
  }
}

template <bool ROPE>
__global__ void __launch_bounds__(WTHREADS, 1)
fused_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const WParams p) {
  extern __shared__ unsigned char smem_raw[];
  const WSmem sm(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the q tile and the ring full ---------
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 0) {
      Ring r;
      uint32_t q_phase = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const Item it(p, item);
        if (it.n_lo >= it.n_hi) continue;
        const int col = it.h * D;
        mbar_wait(sm.q_empty, q_phase ^ 1);
        q_phase ^= 1;
        mbar_arrive_expect_tx(sm.q_full, RTILE_BYTES);
        tma_load_3d(sm.q, &map_q, sm.q_full, col, it.q0, it.b);
        tma_load_3d(sm.q + BOX_BYTES, &map_q, sm.q_full, col + 64, it.q0, it.b);
        for (int n = it.n_lo; n < it.n_hi; ++n, r.next()) {
          const uint32_t st = sm.stage(r.s), bar = sm.full(r.s);
          mbar_wait(sm.empty(r.s), r.phase ^ 1);
          mbar_arrive_expect_tx(bar, STAGE_BYTES);
          tma_load_3d(st, &map_k, bar, col, n * TK, it.b);
          tma_load_3d(st + BOX_BYTES, &map_k, bar, col + 64, n * TK, it.b);
          tma_load_3d(st + RTILE_BYTES, &map_v, bar, col, n * TK, it.b);
          tma_load_3d(st + RTILE_BYTES + BOX_BYTES, &map_v, bar, col + 64, n * TK, it.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup --------------------------------
    reg_alloc<CONSUMER_REGS>();
    const int c = wg - 1, t = tid & 127;
    const int grp = lane >> 2, tig = lane & 3;
    const size_t stride = size_t(p.N) * D;
    const uint32_t qt = sm.q + c * WG_ROWS * SW_ROW_BYTES;  // this warpgroup's q~ rows
    Ring r;
    uint32_t q_phase = 0;
    float s[64], o[64];
    uint32_t pf[TK / 16][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    if (c == 1) bar_arrive(BAR_TURN, 256);  // the first warpgroup takes the first turn

    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const Item it(p, item);
      const int q0w = it.q0 + c * WG_ROWS;
      // this thread's rows: row0 (accumulator e = 0,1) and row0 + 8 (e = 2,3)
      const int row0 = q0w + warp * 16 + grp;
      float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;

      if (it.n_lo < it.n_hi) {
        float rs[WG_ROWS / 8];
        q_row_stats(rs, t, p, it, q0w);  // in flight under the wait
        mbar_wait(sm.q_full, q_phase);
        q_phase ^= 1;
        transform_q_rows<ROPE>(sm.q_ptr + c * WG_ROWS * SW_ROW_BYTES, t, p, it, q0w, rs);
        bar_sync(BAR_QROWS + c, 128);
        // q~ as register A operands: the q tile is free for the next item's
        // raw rows from here on
        uint32_t qa[D / 16][4];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          load_a_frag(qa[kk], qt, warp * 16, kk * 16, lane, BOX_BYTES);
        if (lane == 0) mbar_arrive(sm.q_empty);

        float alpha[2];
        auto softmax = [&](int n) {
          const int kv0 = n * TK;
          const bool full = kv0 + TK <= it.k_len &&
                            (p.wl < 0 || kv0 >= q0w + WG_ROWS - 1 - p.wl) &&
                            (p.wr < 0 || kv0 + TK - 1 <= q0w + p.wr);
          if (full)
            online_softmax<true>(s, alpha, m_run, l_run, row0, kv0, tig, it.k_len, p.wl, p.wr);
          else
            online_softmax<false>(s, alpha, m_run, l_run, row0, kv0, tig, it.k_len, p.wl, p.wr);
        };
        auto pack = [&] {  // bf16(P) as the register A operand of O += P V
#pragma unroll
          for (int kk = 0; kk < TK / 16; ++kk) pack_a_frag(pf[kk], s, kk);
        };
        auto issue_s = [&](int stage) {  // S = Q~ K~^T
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_m64n128k16_rs(s, qa[kk], desc_k_major(sm.stage(stage), kk * 16, BOX_BYTES),
                                kk > 0);
          wgmma_commit();
        };
        auto issue_pv = [&](int stage) {  // O += bf16(P) V
#pragma unroll
          for (int kk = 0; kk < TK / 16; ++kk)
            wgmma_m64n128k16_rs_bt(o, pf[kk],
                                   desc_mn_major(sm.stage(stage) + RTILE_BYTES, kk * 16, BOX_BYTES),
                                   1);
          wgmma_commit();
        };
        auto s_done = [&] {  // S has landed: pin its accumulators and the q~ it read
          fence_regs(s);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) fence_regs(qa[kk]);
        };
        auto release = [&](int stage) {
          fence_regs(o);
#pragma unroll
          for (int kk = 0; kk < TK / 16; ++kk) fence_regs(pf[kk]);
          if (lane == 0) mbar_arrive(sm.empty(stage));
        };

        // first key tile: S only
        mbar_wait(sm.full(r.s), r.phase);
        bar_sync(BAR_TURN + c, 256);
        wgmma_fence();
        issue_s(r.s);
        bar_arrive(BAR_TURN + (c ^ 1), 256);
        wgmma_wait<0>();
        s_done();
        softmax(it.n_lo);
        pack();
        int prev = r.s;
        r.next();
        // then S of tile n and PV of tile n - 1 back to back; the softmax of
        // tile n runs while PV of tile n - 1 is in flight
        for (int n = it.n_lo + 1; n < it.n_hi; ++n) {
          mbar_wait(sm.full(r.s), r.phase);
          rescale(o, alpha);  // to tile n - 1's running max, before its PV adds
          bar_sync(BAR_TURN + c, 256);
          wgmma_fence();
          issue_s(r.s);
          issue_pv(prev);
          bar_arrive(BAR_TURN + (c ^ 1), 256);
          wgmma_wait<1>();
          s_done();
          softmax(n);
          wgmma_wait<0>();
          release(prev);
          pack();
          prev = r.s;
          r.next();
        }
        // last PV
        rescale(o, alpha);
        bar_sync(BAR_TURN + c, 256);
        wgmma_fence();
        issue_pv(prev);
        bar_arrive(BAR_TURN + (c ^ 1), 256);
        wgmma_wait<0>();
        release(prev);
      }

      // out = O / l, l summed over the quad; l == 0 writes 0
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        float l = l_run[r2];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = l == 0.f ? 1.f : 1.f / l;
        uint32_t w[D / 8];
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          w[j] = pack_bf16(o[4 * j + 2 * r2] * inv, o[4 * j + 2 * r2 + 1] * inv);
        const int row = row0 + 8 * r2;
        store_row(p.out + (size_t(it.b) * p.Sq + row) * stride + it.h * D, w, tig, row < p.Sq);
      }
    }
    if (c == 0) bar_sync(BAR_TURN, 256);  // the other warpgroup's last hand-over
  }
}

// One CTA of two warpgroups, one [128, 128] tile pair read through the flat
// map (head h's columns of a [1, rows, cols] tensor; rows past `rows` read
// as zeros), in the bf16 flavors' product forms:
//   c_s  [128, 128] = A B^T, m64n128k16 with A (64 rows a warpgroup) as
//                     register fragments (ldmatrix from the swizzled 128-row
//                     tile) and B K-major in shared memory;
//   c_pv [128, 128] = bf16(c_s) B, the packed scores as register A and B
//                     read MN-major, as V is.
__global__ void __launch_bounds__(256, 1)
layout_check_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, int h, float* c_s, float* c_pv) {
  extern __shared__ unsigned char smem_raw[];
  const WSmem sm(smem_raw);
  const int tid = threadIdx.x, c = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const uint32_t at = sm.q, bt = sm.stage(0);
  if (tid == 0) {
    sm.init_barriers();
    mbar_arrive_expect_tx(sm.q_full, 2 * RTILE_BYTES);
    tma_load_3d(at, &map_a, sm.q_full, h * D, 0, 0);
    tma_load_3d(at + BOX_BYTES, &map_a, sm.q_full, h * D + 64, 0, 0);
    tma_load_3d(bt, &map_b, sm.q_full, h * D, 0, 0);
    tma_load_3d(bt + BOX_BYTES, &map_b, sm.q_full, h * D + 64, 0, 0);
  }
  __syncthreads();
  mbar_wait(sm.q_full, 0);

  float s[64], pv[64];
  uint32_t qa[D / 16][4], pf[TK / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a_frag(qa[kk], at + c * WG_ROWS * SW_ROW_BYTES, warp * 16, kk * 16, lane, BOX_BYTES);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_rs(s, qa[kk], desc_k_major(bt, kk * 16, BOX_BYTES), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) fence_regs(qa[kk]);
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) pack_a_frag(pf[kk], s, kk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
    wgmma_m64n128k16_rs_bt(pv, pf[kk], desc_mn_major(bt, kk * 16, BOX_BYTES), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(pv);
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) fence_regs(pf[kk]);

  const int row = c * WG_ROWS + warp * 16 + grp;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = row + ((i >> 1) & 1) * 8, col = (i >> 2) * 8 + tig * 2 + (i & 1);
    c_s[r * TK + col] = s[i];
    c_pv[r * D + col] = pv[i];
  }
}

// the K~ prepass, then the main kernel; 0, a cudaError_t or 100000 + the
// CUresult of a refused tensor map
template <bool ROPE>
int launch_wgmma(WParams p, const void* q, const void* k_raw, const void* v, const float* rk,
                 const float* gk, __nv_bfloat16* k_scratch, int B, cudaStream_t stream) {
  if (B == 0 || p.Sq == 0) return 0;  // nothing to write
  const size_t rows = size_t(B) * p.Skv;
  const size_t chunks = rows * p.N * CHUNKS;
  transform_rows_kernel<ROPE><<<unsigned((chunks + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(k_raw), rk, gk, p.cos, p.sin, k_scratch, rows, p.Skv,
      p.N);
  if (cudaError_t err = cudaGetLastError()) return int(err);
  const int cols = p.N * D;
  CUtensorMap maps[3];
  if (int err = make_flat_map(&maps[0], q, B, p.Sq, cols, TQ)) return err;
  if (int err = make_flat_map(&maps[1], k_scratch, B, p.Skv, cols, TK)) return err;
  if (int err = make_flat_map(&maps[2], v, B, p.Skv, cols, TK)) return err;
  if (cudaError_t err = cudaFuncSetAttribute(
          fused_wgmma_kernel<ROPE>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(WSMEM_BYTES)))
    return int(err);
  p.q_tiles = (p.Sq + TQ - 1) / TQ;
  p.items = p.q_tiles * p.N * B;
  int dev = 0, sms = 0;  // persistent: at most one CTA an SM
  if (cudaError_t err = cudaGetDevice(&dev)) return int(err);
  if (cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return int(err);
  const int grid = p.items < sms ? p.items : sms;
  fused_wgmma_kernel<ROPE><<<grid, WTHREADS, WSMEM_BYTES, stream>>>(maps[0], maps[1], maps[2], p);
  return int(cudaGetLastError());
}

// the int8 K prepass, then the int8 kernel
cudaError_t launch_int8(Params p, const __nv_bfloat16* k_raw, int B, cudaStream_t stream) {
  const size_t rows = size_t(B) * p.Skv;
  const size_t chunks = rows * p.N * CHUNKS;
  const unsigned blocks = unsigned((chunks + 255) / 256);
  quantize_rows_kernel<true><<<blocks, 256, 0, stream>>>(
      k_raw, p.rk, p.gk, p.cos, p.sin, const_cast<int8_t*>(p.k8),
      const_cast<float*>(p.kscale), rows, p.Skv, p.N, p.kscale_ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(int8_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM_BYTES_INT8));
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BM - 1) / BM, p.N, B);
  int8_attention_kernel<<<grid, NTHREADS, SMEM_BYTES_INT8, stream>>>(p);
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

// Plain C entry for ctypes. Pointers are device pointers, 16-byte aligned;
// cos/sin may be null when rope == 0, k_lens may be null (every key
// visible). k_scratch is a [B, Skv, N*128] buffer for the transformed K:
// bf16, or int8 codes when int8 != 0, which also needs k_scale, an fp32
// [B, N, Skv rounded up to 64] buffer of zeros for the per-row k scales.
// int8 needs rope. Returns 0, the cudaError_t of a launch, or 100000 + the
// CUresult of a refused tensor map.
extern "C" int vc_fused_attention(const void* q, const void* k, const void* v,
                                  const void* rq, const void* rk,
                                  const void* gq, const void* gk,
                                  const void* cos, const void* sin,
                                  const void* k_lens, void* k_scratch,
                                  void* k_scale, void* out,
                                  int B, int Sq, int Skv, int N, int wl, int wr,
                                  int rope, int int8, void* stream) {
  if (int8 && !rope) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) {
    Params p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.k8 = static_cast<const int8_t*>(k_scratch);
    p.kscale = static_cast<const float*>(k_scale);
    p.kscale_ld = (Skv + BN - 1) / BN * BN;
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
    return int(launch_int8(p, static_cast<const __nv_bfloat16*>(k), B, s));
  }
  WParams p = {};
  p.rq = static_cast<const float*>(rq);
  p.gq = static_cast<const float*>(gq);
  p.cos = static_cast<const __nv_bfloat16*>(cos);
  p.sin = static_cast<const __nv_bfloat16*>(sin);
  p.k_lens = static_cast<const int*>(k_lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.Sq = Sq;
  p.Skv = Skv;
  p.N = N;
  p.wl = wl;
  p.wr = wr;
  auto* ks = static_cast<__nv_bfloat16*>(k_scratch);
  const float *rkf = static_cast<const float*>(rk), *gkf = static_cast<const float*>(gk);
  return rope ? launch_wgmma<true>(p, q, k, v, rkf, gkf, ks, B, s)
              : launch_wgmma<false>(p, q, k, v, rkf, gkf, ks, B, s);
}

// c [16, 8] int32 = a [16, 32] int8 . b [8, 32] int8 ^T, through the int8
// flavor's ldmatrix + mma.sync m16n8k32 fragment path (a check of that
// layout). Device pointers; returns the launch's cudaError_t.
extern "C" int vc_mma_s8_tile(const void* a, const void* b, void* c, void* stream) {
  mma_s8_tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int*>(c));
  return int(cudaGetLastError());
}

// The bf16 flavors' wgmma / TMA layout check: a, b are bf16 [1, rows, cols]
// (rows <= 128, cols a multiple of 128), read at head h's columns; c_s and
// c_pv fp32 [128, 128] (see layout_check_kernel). Returns 0, a cudaError_t
// or 100000 + the CUresult of a refused tensor map.
extern "C" int vc_fused_layout_check(const void* a, const void* b, int rows, int cols, int h,
                                     void* c_s, void* c_pv, void* stream) {
  CUtensorMap map_a, map_b;
  if (int err = make_flat_map(&map_a, a, 1, rows, cols, TK)) return err;
  if (int err = make_flat_map(&map_b, b, 1, rows, cols, TK)) return err;
  if (cudaError_t err = cudaFuncSetAttribute(
          layout_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(WSMEM_BYTES)))
    return int(err);
  layout_check_kernel<<<1, 256, WSMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, h, static_cast<float*>(c_s), static_cast<float*>(c_pv));
  return int(cudaGetLastError());
}
