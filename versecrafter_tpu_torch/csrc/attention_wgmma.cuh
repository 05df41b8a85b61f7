// The persistent wgmma attention schedule shared by the forward attention
// kernels (csrc/fused_attention.cu: the fused bf16 and int8 flavors;
// csrc/flash_attention.cu: the plain head-major forward).
//
// A CTA is one producer warp and two consumer warpgroups of 64 q rows each;
// setmaxnreg hands the producer's registers to the consumers (240 / 24).
// CTAs walk work items (128 q rows of one (b, h), q tile fastest, so the
// CTAs in flight share one head's K / V in L2): item = blockIdx.x, then
// += gridDim.x. The producer TMA-loads each item's raw q tile and a ring of
// STAGES key tiles (128 keys: K and V, plus whatever else a flavor's stage
// holds) with a full and an empty mbarrier a stage; tiles outside the
// item's visible range [n_lo, n_hi) are never loaded. Each consumer
// warpgroup turns its q rows into register A fragments in a flavor's own
// prologue (which frees the q tile for the next item's raw rows), then runs
// attend_tiles: S of tile n is issued before PV of tile n - 1, the online
// softmax of tile n runs while that PV is in flight, O is rescaled just
// before the next PV (skipped while no row of the warp has moved its max),
// and the two warpgroups take turns at the tensor cores
// through two named barriers (ping-pong). PV is wgmma m64n128k16 with bf16
// P from registers and V read MN-major. O leaves through 16-byte stores
// after a transpose inside each quad (store_rows).
//
// Scores: a flavor hands the softmax fp32 scores u and, when SCALED, a
// per-row factor c with exp(score) = exp2(c * u): log2(e) for natural-log
// scores, the q row's int8 scale for the int8 flavor. p = exp2(fma(u, c,
// -c * m_u)) with m_u the running row max of u, which needs c > 0. Where
// log2(e) is folded into q (c = 1) it is exp2(u - m_u): ptxas keeps
// fma(u, 1, -m_u) as an FFMA, which costs the bf16 fused self flavor ~2 %. Masked keys (past k_len, outside the window) get P =
// 0 exactly, also in a row whose first visited tile holds none of its keys;
// a row that sees no key keeps l = 0 and writes 0. No atomics and no split
// over keys: reruns are bit-identical.
#pragma once

#include "wgmma_common.cuh"

namespace {

constexpr int D = 128;          // head_dim (the wrappers check it)
constexpr int CHUNKS = D / 8;   // 16-byte bf16 chunks of a row
constexpr int TQ = 128;         // q rows of a work item
constexpr int WG_ROWS = 64;     // of which each consumer warpgroup owns
constexpr int NWG = TQ / WG_ROWS;
constexpr int TK = 128;         // keys of a ring stage
constexpr int STAGES = 3;       // ring depth
constexpr int WTHREADS = 128 * (NWG + 1);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// a [128 rows, 128 bytes] box in the 128-byte swizzle; two make a [128,
// 128] bf16 tile
constexpr uint32_t BOX_BYTES = TK * SW_ROW_BYTES;
constexpr uint32_t RTILE_BYTES = 2 * BOX_BYTES;
// named barriers: the consumer warpgroups' turns at the tensor cores (one
// each), and each warpgroup's q prologue
constexpr int BAR_TURN = 1, BAR_QROWS = 3;
static_assert(TQ == TK, "the q tile and the key tiles share one box shape");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a work item: 128 q rows of one (b, h), and the key tiles they can see (up
// to k_len, and inside the window of at least one of the rows); the CPU
// tests (tests/test_torch_flash_geometry.py) hold a Python copy of this
// arithmetic and of tile_softmax's mask skip to the visible keys
struct Item {
  int b, h, q0, k_len, n_lo, n_hi;
  __device__ __forceinline__ Item(int item, int q_tiles, int N, const int* k_lens, int Skv,
                                  int wl, int wr) {
    const int bh = item / q_tiles;
    q0 = (item - bh * q_tiles) * TQ;
    h = bh % N;
    b = bh / N;
    k_len = k_lens == nullptr ? Skv : min(max(k_lens[b], 0), Skv);
    n_lo = 0;
    n_hi = (k_len + TK - 1) / TK;
    if (wl >= 0) n_lo = max(q0 - wl, 0) / TK;
    if (wr >= 0) n_hi = min(n_hi, (q0 + TQ - 1 + wr) / TK + 1);
    if (wl >= 0 && q0 - wl >= k_len) n_hi = n_lo;  // every window starts past k_len
  }
};

// Shared memory from a 1024-byte aligned base: the q tile, the ring of
// STAGES stages of STAGE bytes (a multiple of 1024), the barriers (q full /
// empty, then full and empty per stage), then EXTRA bytes for a flavor.
template <uint32_t STAGE, uint32_t EXTRA = 0>
struct WSmem {
  static constexpr uint32_t RING_OFF = RTILE_BYTES;
  static constexpr uint32_t BAR_OFF = RING_OFF + STAGES * STAGE;
  static constexpr uint32_t EXTRA_OFF = BAR_OFF + (2 + 2 * STAGES) * 8;
  static constexpr size_t BYTES = EXTRA_OFF + EXTRA + 1024;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");

  uint32_t q, ring, q_full, q_empty, full_bar, empty_bar;
  unsigned char* q_ptr;  // the q tile, for the consumers' in-place prologue
  unsigned char* extra;
  __device__ __forceinline__ explicit WSmem(unsigned char* raw) {
    const uint32_t a = smem_u32(raw);
    const uint32_t pad = ((a + 1023u) & ~1023u) - a;
    q = a + pad;
    q_ptr = raw + pad;
    extra = q_ptr + EXTRA_OFF;
    ring = q + RING_OFF;
    q_full = q + BAR_OFF;
    q_empty = q_full + 8;
    full_bar = q_empty + 8;
    empty_bar = full_bar + 8 * STAGES;
  }
  __device__ __forceinline__ uint32_t stage(int s) const { return ring + s * STAGE; }
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

// The producer thread's walk. item_at(i) gives item i; load_q(it) issues
// the TMA loads of its raw q tile (RTILE_BYTES) against sm.q_full;
// load_stage(stage address, full barrier, it, n) those of key tile n
// (stage_tx bytes).
template <class Sm, class ItemAt, class LoadQ, class LoadStage>
__device__ __forceinline__ void produce(const Sm& sm, int items, uint32_t stage_tx,
                                        ItemAt item_at, LoadQ load_q, LoadStage load_stage) {
  Ring r;
  uint32_t q_phase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = item_at(item);
    if (it.n_lo >= it.n_hi) continue;
    mbar_wait(sm.q_empty, q_phase ^ 1);
    q_phase ^= 1;
    mbar_arrive_expect_tx(sm.q_full, RTILE_BYTES);
    load_q(it);
    for (int n = it.n_lo; n < it.n_hi; ++n, r.next()) {
      const uint32_t bar = sm.full(r.s);
      mbar_wait(sm.empty(r.s), r.phase ^ 1);
      mbar_arrive_expect_tx(bar, stage_tx);
      load_stage(sm.stage(r.s), bar, it, n);
    }
  }
}

// Thread t of a consumer warpgroup owns the 16-byte chunk t % 16 of the
// warpgroup's q rows t / 16 + 8j (j = 0..7) of the raw [128 rows, 128 bf16]
// q tile: whole RoPE pairs, and every row it touches has the same swizzle
// phase (row & 7 == t / 16). Its address in row j:
__device__ __forceinline__ unsigned char* q_chunk(unsigned char* wg_rows, int t, int j) {
  const int chunk = t & 15, r0 = t >> 4;
  return wg_rows + (chunk >> 3) * BOX_BYTES + (r0 + 8 * j) * SW_ROW_BYTES +
         (((chunk & 7) ^ r0) << 4);
}

// The warpgroup holds its q rows in registers: the q tile goes back to the
// producer (lane 0 of each warp arrives). The consumers rewrote the tile in
// place through the generic proxy and the next item's rows arrive by TMA
// through the async proxy, so every thread fences its accesses first:
// without it, back-to-back launches at 32,760 x 192 corrupted rows of later
// items.
template <class Sm>
__device__ __forceinline__ void release_q(const Sm& sm, int lane) {
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(sm.q_empty);
}

// Online softmax of a [64, 128] score tile (see the note at the top) whose
// rows are q rows (row0, row0 + 8) and columns keys kv0 + ...: masks unless
// FULL, updates the running max and sum, and leaves P in place of the
// scores and, per row, the factor alpha that O must be scaled by before
// P V is added to it (O may still be in flight here)
template <bool FULL, bool SCALED>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&alpha)[2],
                                               float (&m_run)[2], float (&l_run)[2],
                                               const float (&c)[2], int row0, int kv0, int tig,
                                               int k_len, int wl, int wr) {
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
    // exp2(c * NEG_INF) = 0 (and alpha at 0 while O and l are still 0)
    const float m_use = m_new == NEG_INF ? 0.f : m_new;
    const float cm = SCALED ? -c[r] * m_use : -m_use;
    // an unmoved max gives alpha = 1 exactly, which lets rescale skip O
    alpha[r] = m_new == m_run[r] ? 1.f
                                 : ex2(SCALED ? fmaf(m_run[r], c[r], cm) : m_run[r] + cm);
    m_run[r] = m_new;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const float u0 = s[4 * j + 2 * r], u1 = s[4 * j + 2 * r + 1];
      const float a = ex2(SCALED ? fmaf(u0, c[r], cm) : u0 + cm);
      const float b = ex2(SCALED ? fmaf(u1, c[r], cm) : u1 + cm);
      s[4 * j + 2 * r] = a;
      s[4 * j + 2 * r + 1] = b;
      sum0 += a;
      sum1 += b;
    }
    l_run[r] = l_run[r] * alpha[r] + (sum0 + sum1);
  }
}

// The softmax of key tile n for the warpgroup whose rows start at q0w: the
// mask is skipped when the whole tile is inside k_len and every row's window
template <bool SCALED>
__device__ __forceinline__ void tile_softmax(float (&s)[64], float (&alpha)[2], float (&m_run)[2],
                                             float (&l_run)[2], const float (&c)[2], int n,
                                             int q0w, int row0, int tig, int k_len, int wl,
                                             int wr) {
  const int kv0 = n * TK;
  const bool full = kv0 + TK <= k_len && (wl < 0 || kv0 >= q0w + WG_ROWS - 1 - wl) &&
                    (wr < 0 || kv0 + TK - 1 <= q0w + wr);
  if (full)
    online_softmax<true, SCALED>(s, alpha, m_run, l_run, c, row0, kv0, tig, k_len, wl, wr);
  else
    online_softmax<false, SCALED>(s, alpha, m_run, l_run, c, row0, kv0, tig, k_len, wl, wr);
}

// O *= alpha, skipped when no row of the warp moved its max (every alpha is
// then exactly 1): after the first key tiles most rows keep theirs
__device__ __forceinline__ void rescale(float (&o)[64], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// One consumer warpgroup's pass over an item's key tiles [n_lo, n_hi).
// before_s() runs ahead of each S product, before the wgmma fence (where a
// flavor may set its accumulators' start values); issue_s(stage) issues
// the S product of the tile in `stage` (without committing); softmax(n,
// stage, alpha) runs once S has landed: it pins S's registers, turns the
// scores into P in `p` and sets alpha. The V tile sits v_off bytes into its
// stage. Ends with O complete and every stage released.
template <class Sm, class BeforeS, class IssueS, class Softmax>
__device__ __forceinline__ void attend_tiles(const Sm& sm, Ring& r, int c, int lane, int n_lo,
                                             int n_hi, uint32_t v_off, float (&o)[64],
                                             const float (&p)[64], BeforeS before_s,
                                             IssueS issue_s, Softmax softmax) {
  uint32_t pf[TK / 16][4];
  float alpha[2];
  auto pack = [&] {  // bf16(P) as the register A operand of O += P V
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) pack_a_frag(pf[kk], p, kk);
  };
  auto issue_pv = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_m64n128k16_rs_bt(o, pf[kk], desc_mn_major(sm.stage(stage) + v_off, kk * 16, BOX_BYTES),
                             1);
    wgmma_commit();
  };
  auto release = [&](int stage) {  // PV has landed: pin O and P, free the stage
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) fence_regs(pf[kk]);
    if (lane == 0) mbar_arrive(sm.empty(stage));
  };

  // first key tile: S only
  before_s();
  mbar_wait(sm.full(r.s), r.phase);
  bar_sync(BAR_TURN + c, 256);
  wgmma_fence();
  issue_s(r.s);
  wgmma_commit();
  bar_arrive(BAR_TURN + (c ^ 1), 256);
  wgmma_wait<0>();
  softmax(n_lo, r.s, alpha);
  pack();
  int prev = r.s;
  r.next();
  // then S of tile n and PV of tile n - 1 back to back; the softmax of tile
  // n runs while PV of tile n - 1 is in flight
  for (int n = n_lo + 1; n < n_hi; ++n) {
    before_s();
    mbar_wait(sm.full(r.s), r.phase);
    rescale(o, alpha);  // to tile n - 1's running max, before its PV adds
    bar_sync(BAR_TURN + c, 256);
    wgmma_fence();
    issue_s(r.s);
    wgmma_commit();
    issue_pv(prev);
    bar_arrive(BAR_TURN + (c ^ 1), 256);
    wgmma_wait<1>();
    softmax(n, r.s, alpha);
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

// out = O / l for this thread's rows row0 (accumulator e = 0, 1) and row0 +
// 8 (e = 2, 3), l summed over the quad (l_run holds the sums afterwards);
// l == 0 writes 0. row_ptr(row) is the row's first output element; rows at
// or past `rows` are not written.
template <class RowPtr>
__device__ __forceinline__ void store_rows(const float (&o)[64], float (&l_run)[2], int row0,
                                           int rows, int tig, RowPtr row_ptr) {
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    float l = l_run[r2];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_run[r2] = l;
    const float inv = l == 0.f ? 1.f : 1.f / l;
    uint32_t w[D / 8];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      w[j] = pack_bf16(o[4 * j + 2 * r2] * inv, o[4 * j + 2 * r2 + 1] * inv);
    const int row = row0 + 8 * r2;
    store_row(row_ptr(row), w, tig, row < rows);
  }
}

}  // namespace
