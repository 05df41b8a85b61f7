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
// m = NEG_INF and l = 0. Rows past Sq (32,760 is no multiple of 128) load
// as zeros and are not written. No atomics: reruns are bit-identical.
//
// What bounds it on an H100: at the training shape (S = 32,760, 12 heads,
// batch 1) self-attention does 4*12*S^2*128 = 6.6e12 FLOP against ~0.3 GB
// of I/O: tensor-core bound, ~6.7 ms at 989 TFLOP/s. Cross-attention (512
// keys) does 1.0e11 FLOP against ~0.2 GB: ~0.1 ms either way.
//
// Design: the persistent schedule of csrc/attention_wgmma.cuh (producer
// warp, a 3-stage TMA ring of 128-key K / V tiles, two consumer
// warpgroups of 64 q rows with 240 registers, S = wgmma m64n128k16 with q
// from registers and K K-major, O += bf16(P) V with V MN-major, S of tile n
// issued before PV of tile n-1 with the softmax under it, ping-pong,
// 16-byte output stores) over 3-D tensor maps of [B*N, S, 128] with
// 128-row boxes: rows past S read as zeros without reaching the next head.
// Only the q prologue and the epilogue are this kernel's own: each consumer
// thread scales its 16-byte chunks of the raw q tile in place and rounds
// them to bf16 once (the rounding the backward's recompute relies on), the
// warpgroup loads its q rows as register A fragments and frees the q tile;
// the stats flavor's softmax factor is log2(e) (exp(s) = exp2(log2(e) s))
// and its epilogue also writes m and l.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_wgmma.cuh"

namespace {

using Smem = WSmem<2 * RTILE_BYTES>;  // a stage: the K tile, then the V tile

struct Params {
  const int* k_lens;   // [B] or null
  __nv_bfloat16* out;  // [B, N, Sq, D]
  float *m, *l;        // [B, N, Sq] (STATS only)
  int N, Sq, Skv, wl, wr;
  int q_tiles, items;  // q tiles of a (b, h); work items
  float scale;         // folded into q before the bf16 rounding
};

// bf16(x * scale) of 8 bf16 values packed in 16 bytes
__device__ __forceinline__ uint4 scale8(uint4 raw, float scale) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 res;
  uint32_t* o32 = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(x2[i]);
    o32[i] = pack_bf16(f.x * scale, f.y * scale);
  }
  return res;
}

template <bool STATS>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
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
        const int bh = it.b * p.N + it.h;
        tma_load_3d(sm.q, &map_q, sm.q_full, 0, it.q0, bh);
        tma_load_3d(sm.q + BOX_BYTES, &map_q, sm.q_full, 64, it.q0, bh);
      };
      auto load_stage = [&](uint32_t st, uint32_t bar, const Item& it, int n) {
        const int bh = it.b * p.N + it.h;
        tma_load_3d(st, &map_k, bar, 0, n * TK, bh);
        tma_load_3d(st + BOX_BYTES, &map_k, bar, 64, n * TK, bh);
        tma_load_3d(st + RTILE_BYTES, &map_v, bar, 0, n * TK, bh);
        tma_load_3d(st + RTILE_BYTES + BOX_BYTES, &map_v, bar, 64, n * TK, bh);
      };
      produce(sm, p.items, 2 * RTILE_BYTES, item_at, load_q, load_stage);
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup --------------------------------
    reg_alloc<CONSUMER_REGS>();
    const int c = wg - 1, t = tid & 127;
    const int grp = lane >> 2, tig = lane & 3;
    const uint32_t qt = sm.q + c * WG_ROWS * SW_ROW_BYTES;  // this warpgroup's q rows
    unsigned char* q_rows = sm.q_ptr + c * WG_ROWS * SW_ROW_BYTES;
    // the stats flavor's softmax factor: exp(s) = exp2(log2(e) s) for the
    // natural-log scores (the inference flavor has log2(e) in q)
    const float cf[2] = {LOG2E_F, LOG2E_F};
    Ring r;
    uint32_t q_phase = 0;
    float s[64], o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    if (c == 1) bar_arrive(BAR_TURN, 256);  // the first warpgroup takes the first turn

    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const Item it = item_at(item);
      const size_t bh = size_t(it.b) * p.N + it.h;
      const int q0w = it.q0 + c * WG_ROWS;
      // this thread's rows: row0 (accumulator e = 0,1) and row0 + 8 (e = 2,3)
      const int row0 = q0w + warp * 16 + grp;
      float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;

      if (it.n_lo < it.n_hi) {
        mbar_wait(sm.q_full, q_phase);
        q_phase ^= 1;
#pragma unroll
        for (int j = 0; j < WG_ROWS / 8; ++j) {  // bf16(q * scale), in place
          uint4* x = reinterpret_cast<uint4*>(q_chunk(q_rows, t, j));
          *x = scale8(*x, p.scale);
        }
        bar_sync(BAR_QROWS + c, 128);
        // q as register A operands: the q tile is free for the next item's
        // raw rows from here on
        uint32_t qa[D / 16][4];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          load_a_frag(qa[kk], qt, warp * 16, kk * 16, lane, BOX_BYTES);
        release_q(sm, lane);

        auto issue_s = [&](int stage) {  // S = Q K^T
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_m64n128k16_rs(s, qa[kk], desc_k_major(sm.stage(stage), kk * 16, BOX_BYTES),
                                kk > 0);
        };
        auto softmax = [&](int n, int, float (&alpha)[2]) {
          fence_regs(s);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) fence_regs(qa[kk]);
          tile_softmax<STATS>(s, alpha, m_run, l_run, cf, n, q0w, row0, tig, it.k_len, p.wl,
                              p.wr);
        };
        attend_tiles(sm, r, c, lane, it.n_lo, it.n_hi, RTILE_BYTES, o, s, [] {}, issue_s,
                     softmax);
      }

      store_rows(o, l_run, row0, p.Sq, tig,
                 [&](int row) { return p.out + (bh * p.Sq + row) * D; });
      if (STATS && tig == 0) {
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int row = row0 + 8 * r2;
          if (row < p.Sq) {
            p.m[bh * p.Sq + row] = m_run[r2];
            p.l[bh * p.Sq + row] = l_run[r2];
          }
        }
      }
    }
    if (c == 0) bar_sync(BAR_TURN, 256);  // the other warpgroup's last hand-over
  }
}

template <bool STATS>
int launch(Params p, const void* q, const void* k, const void* v, int B, cudaStream_t stream) {
  if (B == 0 || p.N == 0 || p.Sq == 0) return 0;  // nothing to write
  const int count = B * p.N, skv = p.Skv > 0 ? p.Skv : 1;  // an empty K is never loaded
  CUtensorMap maps[3];
  if (int err = make_rows_map(&maps[0], q, p.Sq, count, TQ)) return err;
  if (int err = make_rows_map(&maps[1], k, skv, count, TK)) return err;
  if (int err = make_rows_map(&maps[2], v, skv, count, TK)) return err;
  if (cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<STATS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             int(Smem::BYTES)))
    return int(err);
  p.q_tiles = (p.Sq + TQ - 1) / TQ;
  p.items = p.q_tiles * count;
  int grid = 0;
  if (int err = persistent_grid(p.items, &grid)) return err;
  flash_wgmma_kernel<STATS><<<grid, WTHREADS, Smem::BYTES, stream>>>(maps[0], maps[1], maps[2], p);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers, 16-byte aligned;
// k_lens may be null (every key visible); m and l are written only when
// stats != 0. scale is sm_scale (stats) or sm_scale*log2(e) (inference).
// Returns 0, the cudaError_t of the launch, or 100000 + the CUresult of a
// refused tensor map.
extern "C" int vc_flash_attention(const void* q, const void* k, const void* v,
                                  const void* k_lens, void* out, void* m, void* l,
                                  int B, int N, int Sq, int Skv, int wl, int wr,
                                  int stats, float scale, void* stream) {
  Params p = {};
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
  return stats ? launch<true>(p, q, k, v, B, s) : launch<false>(p, q, k, v, B, s);
}
