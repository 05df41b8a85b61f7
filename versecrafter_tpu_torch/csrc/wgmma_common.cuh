// Hopper (sm_90a) building blocks for every kernel of the port, all built
// on warpgroup MMA: wgmma.mma_async bf16 -> fp32 with A from shared memory
// or registers and B from shared memory in either major, s8 -> s32 with A
// from registers, 128-byte swizzled tiles fed by the Tensor Memory
// Accelerator (cp.async.bulk.tensor) with mbarrier completion, register
// hand-over between warpgroups (setmaxnreg), 16-byte row stores of a
// quad's accumulator words, bf16 packing and the softmax constants, and
// the host side of a tensor map and of a persistent grid with nothing
// linked but the CUDA runtime.
//
// Shared-memory tile convention used throughout: a [64 rows, 128 columns]
// bf16 tile is two halves of 64 columns, each an 8 KB block of 64 rows x
// 128 bytes in the 128-byte swizzle (the 16-byte chunk c of row r sits at
// chunk c ^ (r & 7)); half 1 follows half 0. Tile bases are 1024-byte
// aligned, which the swizzle pattern needs. A [128 rows, 128 columns] tile
// (the fused attention kernel's) is the same with 16 KB halves: the
// descriptor helpers take the half's size.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -0.7f * 3.40282346638528859812e+38f;
constexpr float LOG2E_F = 1.44269504088896340736f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr uint32_t SW_ROW_BYTES = 128;                 // one swizzled row
constexpr uint32_t SW_GROUP_BYTES = 8 * SW_ROW_BYTES;  // 8 rows: the swizzle period
constexpr uint32_t HALF_TILE_BYTES = 64 * SW_ROW_BYTES;
constexpr uint32_t TILE_BYTES = 2 * HALF_TILE_BYTES;  // [64, 128] bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// spins until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion adds the box's bytes to the barrier's transaction count
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` (16-byte aligned) into
// shared memory, completing on the barrier like a tensor load
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a [64, 128] tile (rows row0.., matrix `bh`) of a map made by
// make_rows_map with 64-row boxes: two 64-column boxes; rows past the matrix read as zeros
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int row0, int bh) {
  tma_load_3d(dst, map, bar, 0, row0, bh);
  tma_load_3d(dst + HALF_TILE_BYTES, map, bar, 64, row0, bh);
}

// ---- barriers between warpgroups and proxies --------------------------------

// orders this thread's earlier shared-memory accesses (generic proxy) before
// the async-proxy accesses (TMA) that a later barrier hand-over permits
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads) over `n` threads: wait, or
// count this thread's arrival without waiting
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- wgmma ---------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers an in-flight wgmma writes (or reads) at this point of the
// program: the compiler may not move their uses above it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// K-major operand ([rows, k] with k contiguous, as the tile stores a
// matrix's rows): 16 k-columns starting at column k0 of the tile at `tile`,
// whose 64-column halves are `half` bytes apart. Row groups of 8 are
// SW_GROUP_BYTES apart; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int k0,
                                                 uint32_t half = HALF_TILE_BYTES) {
  return smem_desc(tile + (k0 >> 6) * half + (k0 & 63) * 2, 16, SW_GROUP_BYTES);
}

// MN-major B operand over the same tile read as [k = tile row, n = tile
// column]: 16 k-rows starting at row k0, all 128 columns. The two
// 64-column halves are `half` bytes apart (leading offset), 8-row groups
// SW_GROUP_BYTES apart (stride offset).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int k0,
                                                  uint32_t half = HALF_TILE_BYTES) {
  return smem_desc(tile + k0 * SW_ROW_BYTES, half, SW_GROUP_BYTES);
}

#define VC_F8(d, i)                                                             \
  "+f"((d)[i]), "+f"((d)[i + 1]), "+f"((d)[i + 2]), "+f"((d)[i + 3]),           \
      "+f"((d)[i + 4]), "+f"((d)[i + 5]), "+f"((d)[i + 6]), "+f"((d)[i + 7])
#define VC_F32(d, i) VC_F8(d, i), VC_F8(d, i + 8), VC_F8(d, i + 16), VC_F8(d, i + 24)

#define VC_D32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}"
#define VC_D64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"

#define VC_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, " \
  "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared
// memory; `accumulate` false overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VC_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VC_F32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same with A from registers (the m16n8k16 A fragment of each warp's 16
// rows), B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : VC_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, A from registers, B K-major in
// shared memory
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VC_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : VC_F32(d, 0), VC_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers, B MN-major in
// shared memory (the transposed read of a row-major tile)
__device__ __forceinline__ void wgmma_m64n128k16_rs_bt(float (&d)[64],
                                                       const uint32_t (&a)[4], uint64_t b,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VC_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : VC_F32(d, 0), VC_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], A K-major and B MN-major in
// shared memory (the transposed read of a row-major [k, n] tile, its
// 64-column blocks the descriptor's leading offset apart: desc_mn_major)
__device__ __forceinline__ void wgmma_m64n256k16_ss_bt(float (&d)[128], uint64_t a, uint64_t b,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " VC_D128
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : VC_F32(d, 0), VC_F32(d, 32), VC_F32(d, 64), VC_F32(d, 96)
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same at n = 128, into the first 64 registers of d (an accumulator
// sized for either width)
template <int NA>
__device__ __forceinline__ void wgmma_m64n128k16_ss_bt(float (&d)[NA], uint64_t a, uint64_t b,
                                                       int accumulate) {
  static_assert(NA >= 64, "an m64n128 accumulator is 64 registers a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VC_D64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : VC_F32(d, 0), VC_F32(d, 32)
      : "l"(a), "l"(b), "r"(accumulate));
}

#define VC_U8(d, i)                                                             \
  "+r"((d)[i]), "+r"((d)[i + 1]), "+r"((d)[i + 2]), "+r"((d)[i + 3]),           \
      "+r"((d)[i + 4]), "+r"((d)[i + 5]), "+r"((d)[i + 6]), "+r"((d)[i + 7])
#define VC_U32(d, i) VC_U8(d, i), VC_U8(d, i + 8), VC_U8(d, i + 16), VC_U8(d, i + 24)

// d[64 x 128] (+)= A[64 x 32] B[128 x 32]^T in s8 x s8 -> s32, A from
// registers, B K-major in shared memory (the integer form takes no
// transpose). The A fragment of 32 codes is the bf16 k16 fragment of the
// same bytes: a[0] row g, bytes 4t..4t+3; a[1] row g + 8; a[2], a[3] the
// same rows at bytes 16 + 4t.
__device__ __forceinline__ void wgmma_m64n128k32_s8_rs(uint32_t (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " VC_D64
      ", {%64, %65, %66, %67}, %68, p;\n}\n"
      : VC_U32(d, 0), VC_U32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The accumulator of an m64nN wgmma, per thread: warp w of the warpgroup
// holds rows 16w .. 16w+15; with g = lane / 4 and t = lane % 4, d[4j] and
// d[4j+1] are row 16w+g, columns 8j+2t and 8j+2t+1; d[4j+2] and d[4j+3]
// the same columns of row 16w+g+8.
//
// Columns 16kk .. 16kk+15 of a [64, 16*KT] accumulator, rounded to bf16, as
// the register A operand of the next product
template <int N>
__device__ __forceinline__ void pack_a_frag(uint32_t (&a)[4], const float (&x)[N], int kk) {
  a[0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// The register A operand for columns k0 .. k0+15 of this warp's 16 rows
// (rows r16 .. r16+15 of the swizzled tile at `tile`, whose 64-column halves
// are `half` bytes apart), by ldmatrix
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], uint32_t tile, int r16, int k0,
                                            int lane, uint32_t half = HALF_TILE_BYTES) {
  const int mat = lane >> 3, mrow = lane & 7;
  const int r = r16 + (mat & 1) * 8 + mrow;
  const int chunk = ((k0 & 63) >> 3) + (mat >> 1);
  const uint32_t addr = tile + (k0 >> 6) * half + r * SW_ROW_BYTES + ((chunk ^ (r & 7)) << 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// ---- stores ----------------------------------------------------------------

// One output row held by a quad (word j of thread tig: columns 8j + 2tig and
// 8j + 2tig + 1, packed bf16), written as 16-byte stores: a 4 x 4 word
// transpose inside the quad by two exchanges, after which thread tig holds
// column groups 4m + tig (m = 0..3) whole. Every lane takes part in the
// exchanges; only `valid` rows are written.
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const uint32_t (&w)[16], int tig,
                                          bool valid) {
  const bool odd = tig & 1, high = tig & 2;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
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

// ---- register hand-over between warpgroups --------------------------------

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host side -------------------------------------------------------------

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library links nothing but the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) !=
        cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Tensor map over `count` row-major bf16 matrices [rows, 128] stored back
// to back at `base` (16-byte aligned), boxes of `box_rows` rows x 64
// columns in the 128-byte swizzle. The matrix index is its own dimension,
// so a box never runs into the next matrix: rows past `rows` are filled
// with zeros. Returns 0 or a non-zero error code.
inline int make_rows_map(CUtensorMap* map, const void* base, int rows, int count,
                         int box_rows = 64) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return int(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {128, cuuint64_t(rows), cuuint64_t(count)};
  const cuuint64_t strides[2] = {128 * sizeof(__nv_bfloat16),
                                 cuuint64_t(rows) * 128 * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                              const_cast<void*>(base), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 100000 + int(res);
}

// Tensor map over a flat row-major [batch, rows, cols] tensor of bf16
// (elem_bytes 2) or int8 codes (elem_bytes 1) at `base` (16-byte aligned,
// cols * elem_bytes a multiple of 16), as a projection stores [B, S,
// N*128]: dims {cols, rows, batch}, boxes of `box_rows` rows x 128 bytes
// (64 bf16 or 128 codes) in the 128-byte swizzle. A head's columns are
// addressed by the column coordinate (h*128, and h*128 + 64 for bf16's
// second box). Rows are their own dimension, so rows past `rows` read as
// zeros and a box never runs into the next batch element. Returns 0 or a
// non-zero error code.
inline int make_flat_map(CUtensorMap* map, const void* base, int batch, int rows, int cols,
                         int box_rows, int elem_bytes = 2) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return int(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * elem_bytes,
                                 cuuint64_t(rows) * cols * elem_bytes};
  const cuuint32_t box[3] = {cuuint32_t(SW_ROW_BYTES / elem_bytes), cuuint32_t(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 100000 + int(res);
}

// The persistent grid: at most one CTA an SM
inline int persistent_grid(int items, int* grid) {
  int dev = 0, sms = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return int(err);
  if (cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return int(err);
  *grid = items < sms ? items : sms;
  return 0;
}

}  // namespace
