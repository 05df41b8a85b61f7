// Fused qk-RMSNorm (+ RoPE) flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_attention_fused_pallas`
// (versecrafter_tpu/kernels/flash_attention.py:800, body `_fa_kernel` :94)
// in its three inference flavors:
//   ROPE=true  — self-attention (fused_rope_rms_attention): bf16(x * rstat
//                * g), then x*cosI + pairswap(x)*sinI, rounded once;
//   ROPE=false — cross-attention (fused_rms_cross_attention): norm only;
//   INT8=true  — the self-attention flavor with int8 QK^T scoring
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
// ~0.8 GB of I/O, so it is tensor-core bound (~13.3 ms at 989 TFLOP/s; the
// int8 flavor's QK^T half at 1,979 TOP/s, ~10.0 ms); the cross flavor (512
// keys) does 2.1e11 FLOP against ~0.4 GB (~0.21 ms), with a q tile that is
// read, normalised and written back around only four key tiles.
//
// Design: a prepass normalises (+ rotates) K once per row into a scratch
// buffer the wrapper allocates (the Pallas resident-KV mode's "rotate K
// once per (b, h)"); the int8 flavor's prepass writes int8 codes and a
// scale per (row, head) instead. The main kernel runs the persistent
// schedule of csrc/attention_wgmma.cuh (producer warp, a 3-stage TMA ring
// of 128-key tiles, two consumer warpgroups of 64 q rows, ping-pong, S of
// tile n issued before PV of tile n-1 with the softmax under it) over 3-D
// tensor maps of the flat layout ({N*128, S, B}, boxes of 128 bytes x 128
// rows, 128-byte swizzle; rows past S read as zeros and a box never reaches
// the next batch element). The q prologue: the consumers normalise (+
// rotate) their raw q rows in place in the swizzled tile (a thread owns one
// 16-byte chunk of a row: whole RoPE pairs), sync the warpgroup and load
// q~ as register A fragments (ldmatrix), which frees the q tile at once:
// the next item's raw rows load during this item. S = Q~ K~^T is wgmma
// m64n128k16 with A from registers and K~ K-major in shared memory.
// `vc_fused_layout_check` runs both bf16 product forms over 128-row tiles
// read through the flat map on integer-valued tiles; the CUDA tests hold it
// to the exact integer products.
//
// INT8: the bf16-rounded q~/k~ rows are quantized per (row, head): sc =
// max(max|t|, 1e-20) / 127 in fp32, code = round_half_even(t / sc) (IEEE
// division, __float2int_rn; a row's 128 channels sit on 16 lanes, so the
// max is a 16-lane shuffle reduction). The prepass writes int8 K codes
// [B, Skv, N*128] and an fp32 scale per (b, h, row) in [B, N, Skv rounded
// up to 128]; q is quantized in the prologue, right after its transform,
// and its codes overwrite the warpgroup's rows of the q tile's first box
// (a head's 128 codes are one 128-byte swizzled row) before the ldmatrix
// that makes them register A fragments (16 registers against bf16 q~'s 32).
// A stage holds the 128-key code tile (one 16 KB box, K-major, as the s8
// form requires), the bf16 V tile and the tile's 128 k scales (a 512-byte
// bulk copy). QK^T is wgmma m64n128k32 s8 x s8 -> s32; the accumulators
// start from the bits of 1.5 * 2^23 (I2F_BIAS), so each holds I2F_BIAS +
// sum as a float (exact while |sum| < 2^22; a 128-channel s8 dot is below
// 2^21) and one FADD recovers float(s32) at full rate instead of the
// quarter-rate conversion pipe. The softmax takes u = float(s32) * k scale
// and the q row's scale as its factor c: p = exp2(fma(u, qs, -qs * m_u)),
// valid since qs > 0. That reorders one rounding against the plain
// version's float(s32) * qs * ks (ROADMAP §3). PV stays bf16.
// `vc_fused_layout_check(int8=1)` holds the s8 product form exact on
// integer codes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_wgmma.cuh"

namespace {

// 1.5 * 2^23, bits 0x4B400000: an int added to these bits gives the float
// I2F_BIAS + int exactly while |int| < 2^22
constexpr float I2F_BIAS = 12582912.f;
constexpr uint32_t I2F_BIAS_BITS = 0x4B400000u;

// a bf16 stage: the K~ tile, then the V tile
constexpr uint32_t BF16_STAGE = 2 * RTILE_BYTES;
// an int8 stage: the K code tile (one box), the V tile, the k scales; the
// stage is padded to keep the next stage's swizzle alignment
constexpr uint32_t I8_V_OFF = BOX_BYTES;
constexpr uint32_t I8_KS_OFF = BOX_BYTES + RTILE_BYTES;
constexpr uint32_t I8_STAGE_TX = I8_KS_OFF + TK * sizeof(float);
constexpr uint32_t I8_STAGE = (I8_STAGE_TX + 1023) / 1024 * 1024;

template <bool INT8>
using FusedSmem = WSmem<INT8 ? I8_STAGE : BF16_STAGE, INT8 ? TQ * sizeof(float) : 0>;

struct WParams {
  const float* rq;                 // [B, Sq], sm_scale*log2(e) folded in
  const float* gq;                 // [N*D]
  const __nv_bfloat16 *cos, *sin;  // [>= Sq, D] interleaved tables (RoPE)
  const int* k_lens;               // [B] or null
  const float* kscale;             // int8: k scales [B, N, kscale_ld]
  int kscale_ld;                   // int8: Skv rounded up to TK
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
  const uint4 t = transform8<true>(x + off, rstat[r], g + c, cos + size_t(s) * D + d0,
                                   sin + size_t(s) * D + d0, valid);
  float sc;
  const uint2 codes = quantize8(t, sc);
  if (valid) {
    *reinterpret_cast<uint2*>(out + off) = codes;
    if (d0 == 0) scale[(size_t(r / S) * N + c / D) * scale_ld + s] = sc;
  }
}

// The row statistics of thread t's q rows (see q_chunk), loaded before the
// q tile has arrived
__device__ __forceinline__ void q_row_stats(float (&rs)[WG_ROWS / 8], int t, const WParams& p,
                                            const Item& it, int q0w) {
#pragma unroll
  for (int j = 0; j < WG_ROWS / 8; ++j) {
    const int row = q0w + (t >> 4) + 8 * j;
    rs[j] = row < p.Sq ? p.rq[size_t(it.b) * p.Sq + row] : 0.f;
  }
}

// A consumer warpgroup's 64 rows of the raw q tile, normalised (+ rotated)
// in place in the swizzled layout; INT8 quantizes each row right after its
// transform: its codes go to the row of the first box (chunk c's 8 codes at
// bytes 8c of the 128-byte swizzled row) and its scale to qsc. A row's
// codes land only on bytes of that row, whose raw chunks the row's 16 lanes
// have read before the scale's shuffle reduction.
template <bool ROPE, bool INT8>
__device__ __forceinline__ void transform_q_rows(unsigned char* rows, float* qsc, int t,
                                                 const WParams& p, const Item& it, int q0w,
                                                 const float (&rs)[WG_ROWS / 8]) {
  const int chunk = t & 15, r0 = t >> 4;
  const float* g = p.gq + it.h * D + chunk * 8;
#pragma unroll (ROPE ? 4 : 8)  // the tables' loads take registers
  for (int j = 0; j < WG_ROWS / 8; ++j) {
    const int row = q0w + r0 + 8 * j;
    const bool valid = row < p.Sq;
    const size_t trow = size_t(valid ? row : 0) * D + chunk * 8;
    __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(q_chunk(rows, t, j));
    const uint4 tv = transform8<ROPE>(x, rs[j], g, ROPE ? p.cos + trow : nullptr,
                                      ROPE ? p.sin + trow : nullptr, valid);
    if constexpr (INT8) {
      float sc;
      const uint2 codes = quantize8(tv, sc);
      const int rr = r0 + 8 * j;
      *reinterpret_cast<uint2*>(rows + rr * SW_ROW_BYTES + (((chunk >> 1) ^ r0) << 4) +
                                (chunk & 1) * 8) = codes;
      if (chunk == 0) qsc[rr] = sc;
    } else {
      *reinterpret_cast<uint4*>(x) = tv;
    }
  }
}

template <bool ROPE, bool INT8>
__global__ void __launch_bounds__(WTHREADS, 1)
fused_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const WParams p) {
  static_assert(ROPE || !INT8, "the int8 flavor is the RoPE flavor's");
  using Sm = FusedSmem<INT8>;
  extern __shared__ unsigned char smem_raw[];
  const Sm sm(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  auto item_at = [&](int item) {
    return Item(item, p.q_tiles, p.N, p.k_lens, p.Skv, p.wl, p.wr);
  };

  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the q tile and the ring full ---------
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 0) {
      auto load_q = [&](const Item& it) {
        tma_load_3d(sm.q, &map_q, sm.q_full, it.h * D, it.q0, it.b);
        tma_load_3d(sm.q + BOX_BYTES, &map_q, sm.q_full, it.h * D + 64, it.q0, it.b);
      };
      auto load_stage = [&](uint32_t st, uint32_t bar, const Item& it, int n) {
        const int col = it.h * D, row = n * TK;
        tma_load_3d(st, &map_k, bar, col, row, it.b);
        if constexpr (INT8) {
          const uint32_t v = st + I8_V_OFF;
          tma_load_3d(v, &map_v, bar, col, row, it.b);
          tma_load_3d(v + BOX_BYTES, &map_v, bar, col + 64, row, it.b);
          bulk_load(st + I8_KS_OFF,
                    p.kscale + (size_t(it.b) * p.N + it.h) * p.kscale_ld + row,
                    TK * sizeof(float), bar);
        } else {
          tma_load_3d(st + BOX_BYTES, &map_k, bar, col + 64, row, it.b);
          tma_load_3d(st + RTILE_BYTES, &map_v, bar, col, row, it.b);
          tma_load_3d(st + RTILE_BYTES + BOX_BYTES, &map_v, bar, col + 64, row, it.b);
        }
      };
      produce(sm, p.items, INT8 ? I8_STAGE_TX : BF16_STAGE, item_at, load_q, load_stage);
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup --------------------------------
    reg_alloc<CONSUMER_REGS>();
    const int c = wg - 1, t = tid & 127;
    const int grp = lane >> 2, tig = lane & 3;
    const size_t stride = size_t(p.N) * D;
    const uint32_t qt = sm.q + c * WG_ROWS * SW_ROW_BYTES;  // this warpgroup's q rows
    unsigned char* q_rows = sm.q_ptr + c * WG_ROWS * SW_ROW_BYTES;
    float* qsc = reinterpret_cast<float*>(sm.extra) + c * WG_ROWS;
    Ring r;
    uint32_t q_phase = 0;
    float s[64], o[64];
    uint32_t si[64];  // INT8: the s32 accumulators
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    if (c == 1) bar_arrive(BAR_TURN, 256);  // the first warpgroup takes the first turn

    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const Item it = item_at(item);
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
        transform_q_rows<ROPE, INT8>(q_rows, qsc, t, p, it, q0w, rs);
        bar_sync(BAR_QROWS + c, 128);
        // q~ (or its codes) as register A operands: the q tile is free for
        // the next item's raw rows from here on
        constexpr int QK = INT8 ? D / 32 : D / 16;
        uint32_t qa[QK][4];
#pragma unroll
        for (int kk = 0; kk < QK; ++kk)
          load_a_frag(qa[kk], qt, warp * 16, kk * 16, lane, BOX_BYTES);
        // the int8 flavor's softmax factor: the q rows' scales
        float cf[2] = {1.f, 1.f};
        if constexpr (INT8) {
          cf[0] = qsc[warp * 16 + grp];
          cf[1] = qsc[warp * 16 + grp + 8];
        }
        release_q(sm, lane);

        auto before_s = [&] {
          if constexpr (INT8) {  // start from the bits of I2F_BIAS, pinned ahead of the fence
#pragma unroll
            for (int i = 0; i < 64; ++i) si[i] = I2F_BIAS_BITS;
            fence_regs(si);
          }
        };
        auto issue_s = [&](int stage) {  // S = Q~ K~^T
#pragma unroll
          for (int kk = 0; kk < QK; ++kk) {
            const uint64_t kd = desc_k_major(sm.stage(stage), kk * 16, BOX_BYTES);
            if constexpr (INT8)
              wgmma_m64n128k32_s8_rs(si, qa[kk], kd, 1);
            else
              wgmma_m64n128k16_rs(s, qa[kk], kd, kk > 0);
          }
        };
        auto softmax = [&](int n, int stage, float (&alpha)[2]) {
          // S has landed: pin its accumulators and the q it read
          if constexpr (!INT8) fence_regs(s);
#pragma unroll
          for (int kk = 0; kk < QK; ++kk) fence_regs(qa[kk]);
          if constexpr (INT8) {  // u = float(s32) * k scale
            fence_regs(si);
            const float* ks = reinterpret_cast<const float*>(
                sm.q_ptr + Sm::RING_OFF + stage * I8_STAGE + I8_KS_OFF);
#pragma unroll
            for (int j = 0; j < TK / 8; ++j) {
              const float2 k2 = *reinterpret_cast<const float2*>(ks + 8 * j + 2 * tig);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[4 * j + e] = (__uint_as_float(si[4 * j + e]) - I2F_BIAS) * (e & 1 ? k2.y : k2.x);
            }
          }
          tile_softmax<INT8>(s, alpha, m_run, l_run, cf, n, q0w, row0, tig, it.k_len, p.wl,
                             p.wr);
        };
        attend_tiles(sm, r, c, lane, it.n_lo, it.n_hi, INT8 ? I8_V_OFF : RTILE_BYTES, o, s,
                     before_s, issue_s, softmax);
      }

      store_rows(o, l_run, row0, p.Sq, tig, [&](int row) {
        return p.out + (size_t(it.b) * p.Sq + row) * stride + it.h * D;
      });
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
// With INT8, a and b are int8 codes and only c_s is written: the s8 form
// (m64n128k32, A fragments from the 128-byte code rows, B K-major) from
// I2F_BIAS-started accumulators, as float(s32).
template <bool INT8>
__global__ void __launch_bounds__(256, 1)
layout_check_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, int h, float* c_s, float* c_pv) {
  using Sm = FusedSmem<false>;
  extern __shared__ unsigned char smem_raw[];
  const Sm sm(smem_raw);
  const int tid = threadIdx.x, c = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const uint32_t at = sm.q, bt = sm.stage(0);
  if (tid == 0) {
    sm.init_barriers();
    mbar_arrive_expect_tx(sm.q_full, (INT8 ? 2 : 4) * BOX_BYTES);
    tma_load_3d(at, &map_a, sm.q_full, h * D, 0, 0);
    tma_load_3d(bt, &map_b, sm.q_full, h * D, 0, 0);
    if constexpr (!INT8) {
      tma_load_3d(at + BOX_BYTES, &map_a, sm.q_full, h * D + 64, 0, 0);
      tma_load_3d(bt + BOX_BYTES, &map_b, sm.q_full, h * D + 64, 0, 0);
    }
  }
  __syncthreads();
  mbar_wait(sm.q_full, 0);

  const uint32_t a_rows = at + c * WG_ROWS * SW_ROW_BYTES;
  const int row = c * WG_ROWS + warp * 16 + grp;
  float s[64];
  if constexpr (INT8) {
    uint32_t si[64], qa[D / 32][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) si[i] = I2F_BIAS_BITS;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) load_a_frag(qa[kk], a_rows, warp * 16, kk * 16, lane, BOX_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      wgmma_m64n128k32_s8_rs(si, qa[kk], desc_k_major(bt, kk * 16, BOX_BYTES), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(si);
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = __uint_as_float(si[i]) - I2F_BIAS;
  } else {
    float pv[64];
    uint32_t qa[D / 16][4], pf[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a_frag(qa[kk], a_rows, warp * 16, kk * 16, lane, BOX_BYTES);
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
#pragma unroll
    for (int i = 0; i < 64; ++i)
      c_pv[(row + ((i >> 1) & 1) * 8) * D + (i >> 2) * 8 + tig * 2 + (i & 1)] = pv[i];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i)
    c_s[(row + ((i >> 1) & 1) * 8) * TK + (i >> 2) * 8 + tig * 2 + (i & 1)] = s[i];
}

// the K prepass, then the main kernel; 0, a cudaError_t or 100000 + the
// CUresult of a refused tensor map
template <bool ROPE, bool INT8>
int launch(WParams p, const void* q, const void* k_raw, const void* v, const float* rk,
           const float* gk, void* k_scratch, float* k_scale, int B, cudaStream_t stream) {
  if (B == 0 || p.Sq == 0) return 0;  // nothing to write
  const size_t rows = size_t(B) * p.Skv;
  const size_t chunks = rows * p.N * CHUNKS;
  const unsigned blocks = unsigned((chunks + 255) / 256);
  const auto* kr = static_cast<const __nv_bfloat16*>(k_raw);
  if (chunks > 0) {
    if constexpr (INT8)
      quantize_rows_kernel<<<blocks, 256, 0, stream>>>(kr, rk, gk, p.cos, p.sin,
                                                       static_cast<int8_t*>(k_scratch), k_scale,
                                                       rows, p.Skv, p.N, p.kscale_ld);
    else
      transform_rows_kernel<ROPE><<<blocks, 256, 0, stream>>>(
          kr, rk, gk, p.cos, p.sin, static_cast<__nv_bfloat16*>(k_scratch), rows, p.Skv, p.N);
    if (cudaError_t err = cudaGetLastError()) return int(err);
  }
  const int cols = p.N * D, skv = p.Skv > 0 ? p.Skv : 1;  // an empty K is never loaded
  CUtensorMap maps[3];
  if (int err = make_flat_map(&maps[0], q, B, p.Sq, cols, TQ)) return err;
  if (int err = make_flat_map(&maps[1], k_scratch, B, skv, cols, TK, INT8 ? 1 : 2)) return err;
  if (int err = make_flat_map(&maps[2], v, B, skv, cols, TK)) return err;
  constexpr size_t smem = FusedSmem<INT8>::BYTES;
  if (cudaError_t err = cudaFuncSetAttribute(fused_wgmma_kernel<ROPE, INT8>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             int(smem)))
    return int(err);
  p.q_tiles = (p.Sq + TQ - 1) / TQ;
  p.items = p.q_tiles * p.N * B;
  int grid = 0;
  if (int err = persistent_grid(p.items, &grid)) return err;
  fused_wgmma_kernel<ROPE, INT8><<<grid, WTHREADS, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return int(cudaGetLastError());
}

template <bool INT8>
int layout_check(const void* a, const void* b, int rows, int cols, int h, void* c_s, void* c_pv,
                 cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (int err = make_flat_map(&map_a, a, 1, rows, cols, TK, INT8 ? 1 : 2)) return err;
  if (int err = make_flat_map(&map_b, b, 1, rows, cols, TK, INT8 ? 1 : 2)) return err;
  constexpr size_t smem = FusedSmem<false>::BYTES;
  if (cudaError_t err = cudaFuncSetAttribute(layout_check_kernel<INT8>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             int(smem)))
    return int(err);
  layout_check_kernel<INT8><<<1, 256, smem, stream>>>(map_a, map_b, h, static_cast<float*>(c_s),
                                                      static_cast<float*>(c_pv));
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers, 16-byte aligned;
// cos/sin may be null when rope == 0, k_lens may be null (every key
// visible). k_scratch is a [B, Skv, N*128] buffer for the transformed K:
// bf16, or int8 codes when int8 != 0, which also needs k_scale, an fp32
// [B, N, Skv rounded up to 128] buffer of zeros for the per-row k scales.
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
  WParams p = {};
  p.rq = static_cast<const float*>(rq);
  p.gq = static_cast<const float*>(gq);
  p.cos = static_cast<const __nv_bfloat16*>(cos);
  p.sin = static_cast<const __nv_bfloat16*>(sin);
  p.k_lens = static_cast<const int*>(k_lens);
  p.kscale = static_cast<const float*>(k_scale);
  p.kscale_ld = (Skv + TK - 1) / TK * TK;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.Sq = Sq;
  p.Skv = Skv;
  p.N = N;
  p.wl = wl;
  p.wr = wr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *rkf = static_cast<const float*>(rk), *gkf = static_cast<const float*>(gk);
  float* ksc = static_cast<float*>(k_scale);
  if (int8) return launch<true, true>(p, q, k, v, rkf, gkf, k_scratch, ksc, B, s);
  return rope ? launch<true, false>(p, q, k, v, rkf, gkf, k_scratch, ksc, B, s)
              : launch<false, false>(p, q, k, v, rkf, gkf, k_scratch, ksc, B, s);
}

// The fused flavors' wgmma / TMA layout checks: a, b are [1, rows, cols]
// (rows <= 128, cols a multiple of 128), bf16 or, with int8 != 0, int8
// codes, read at head h's columns; c_s fp32 [128, 128] and, bf16 only, c_pv
// fp32 [128, 128] (see layout_check_kernel). Returns 0, a cudaError_t or
// 100000 + the CUresult of a refused tensor map.
extern "C" int vc_fused_layout_check(const void* a, const void* b, int rows, int cols, int h,
                                     int int8, void* c_s, void* c_pv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? layout_check<true>(a, b, rows, cols, h, c_s, c_pv, s)
              : layout_check<false>(a, b, rows, cols, h, c_s, c_pv, s);
}
