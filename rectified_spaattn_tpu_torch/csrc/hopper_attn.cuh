// The Hopper attention mainloop shared by K1/K1s and K2 (block_sparse.cu),
// K3 (dense_flash.cu) and the S3 / S2 ablations of K1 and K2 (variants.cu),
// with the mbarrier and TMA helpers, and the parts K1q's kernel adds to it
// (block_sparse.cu, hopper_attn_q_kernel): int8 tiles by TMA, their exact
// conversion to 16 bits, and the int8 wgmma.  The int8 probe S1
// (int8_probe.cu) runs the mainloop's CTA shape, TMA copies and wgmma
// instructions on its own loop.
//
// One CTA owns 128 query rows of one (batch, head): 384 threads, two
// consumer warpgroups of 64 rows each (threads 0-255) and one producer
// warpgroup (threads 256-383) whose first thread issues every copy, the
// others leaving at once; setmaxnreg moves the producer's registers to the
// consumers (40 / 232 of the 168 a thread starts with).
//
//   * The head_dim D is the policy's (P::D, a compile-time 128 or 64;
//     MainloopDefaults is 128).  The q tile (128 x D: 32 KB at 128, 16 KB
//     at 64) arrives once per tile by TMA; a unit is 128 keys (one mask
//     block) of K and V (64 KB at 128, 32 KB at 64), copied by TMA
//     (cp.async.bulk.tensor, 64 x 64 boxes, 128-byte swizzle) into a ring of
//     HA_STAGES stages, one "full" and one "empty" mbarrier per stage.
//   * S = Q K^T: wgmma.m64n128k16 with Q and K read from shared memory,
//     D / 16 steps, fp32 accumulation.  O += P V (m64nDk16): P rounded to
//     the K/V type in registers (the S accumulator's layout is the
//     A-register fragment's), V read from shared memory as the transposed
//     B operand; nothing is transposed by hand.  m, l and O stay in fp32
//     registers.
//   * The caller's policy (a struct of static device functions) gives the
//     tiles a CTA walks, the copies of each, the score mask of a unit, and
//     the epilogue.  The mask is branch-free: each unit computes its key
//     window once and applies it to the 64 scores of a thread by selects.
//   * The ablations' hooks (MainloopDefaults below; with the defaults the
//     mainloop computes what it computes without them): the ring depth,
//     the unit's copy, no copies at all, a load-only consumer, the
//     scripts' linear stand-in for exp, and the producer's cursor over a
//     tile's units.
//
// Shared memory (1024-byte aligned for the swizzle): q [D / 64 column
// halves][128 rows][128 B], then the ring: per stage K then V in the same layout,
// then the barriers and 1 KB of per-warpgroup floats for the epilogue.
//
// fp32 inputs (T = float; JAX computes fp32 q, K and V in fp32).  Every
// operand x is split into bf16 hi = bf16(x) and lo = bf16(x - hi), 16 of
// its 24 significant bits, and each product runs as three bf16 wgmma
// (hi hi + hi lo + lo hi, the lo lo term below 2^-16 of it) on the same
// ss / rs paths as the 16-bit types, V still the transposed B operand
// (tf32 wgmma reads both operands K-major only: V would have to be
// transposed in shared memory, and its three passes run at half the
// bf16 rate).  One pass of TF32 would keep 11 bits, ~5e-4 relative.
//   * q (times sm_scale where the policy scales q) is read from global
//     memory by each consumer warpgroup for its own 64 rows at a tile's
//     start and split into a hi and a lo tile (no TMA copy of q).
//   * K and V: the whole producer warpgroup reads a unit's fp32 rows from
//     global memory (16-byte loads, a warp on whole rows) and writes the
//     ring's hi and lo tiles in the swizzled layout; a row past the
//     policy's last reads as zero.  K and V have a full and an empty
//     barrier each, so that K of the next unit is converted while the
//     consumers run this unit's softmax and P V.
//   * P is split in registers; a unit's ph vh + ph vl + pl vh goes to an
//     accumulator of its own that is added to O by FADD: the tensor
//     cores round their fp32 accumulation toward zero, which over 10^5
//     keys in one accumulator moved O by 2.7e-4 of its std on the H100
//     (the windowed dense at the HunyuanVideo site), where one unit's 24
//     steps keep it below 1e-5.
//   * Shared memory: q hi and lo (2 tiles) and per stage K hi, K lo, V hi,
//     V lo (4 tiles): one stage at D = 128 (198,704 bytes; two would need
//     329,808), two at D = 64 (165,968).
//   * Registers: the producer converts (setmaxnreg 72, four rows of loads
//     in flight a thread), the consumers keep 216 (ph and pl take 64
//     registers where the 16-bit P takes 32, the unit's accumulator D /
//     2 more); 128 x 72 + 256 x 216 is the 384 x 168 the CTA starts with,
//     as 40 / 232.
#pragma once

#include <cuda.h>   // CUtensorMap (the encoder is reached through the runtime)
#include <type_traits>

#include "attn_common.cuh"

namespace {

// ------------------------------------------------ mbarriers and TMA copies

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// the box at (column c0, row c1) of a 2-D tensor map into shared memory
// by the copy engine, completion counted on `bar`
__device__ __forceinline__ void tma_load(void* smem, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(smem)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

// ------------------------------------------------------ the mainloop's parts

constexpr int HA_ROWS = 128;          // query rows per CTA
constexpr int HA_KEYS = 128;          // keys per unit (one mask block)
constexpr int HA_D = 128;             // head_dim of K1q, K3, S1 and the ablations
constexpr int HA_THREADS = 384;       // 2 consumer warpgroups + 1 producer
constexpr int HA_CONSUMERS = 256;
constexpr int HA_STAGES = 2;
constexpr int HA_BOX = 64 * 128;      // a 64 x 64 box of 16-bit elements: 8 KB
constexpr int HA_HALF = 2 * HA_BOX;   // 128 rows x 64 columns: 16 KB
constexpr int HA_TILE = 2 * HA_HALF;  // 128 rows x 128 columns: 32 KB
constexpr int HA_STAGE = 2 * HA_TILE; // K and V of one unit: 64 KB
// a tile at head_dim d (64 or 128): d / 64 column halves, 16 KB at 64
__host__ __device__ constexpr int ha_tile(int d) { return d / 64 * HA_HALF; }
// the dynamic shared memory of a ring of `stages` stages at head_dim d:
// 165,936 bytes at 2 stages and d = 128, 231,488 at 3 (of the 232,448 a
// CTA can have); 84,016 at 2 stages and d = 64.  `split` (fp32 inputs):
// q, K and V each as a hi and a lo tile, K and V with their own barriers
constexpr int ha_smem(int stages, int d = HA_D, bool split = false) {
  return split ? 1024 + 2 * ha_tile(d) + stages * 4 * ha_tile(d) +
                     8 * (2 + 4 * stages) + 2 * 128 * 4
               : 1024 + ha_tile(d) + stages * 2 * ha_tile(d) +
                     8 * (2 + 2 * stages) + 2 * 128 * 4;
}

// one box of each 64-column half (128 columns of 16-bit elements) from
// row `row` of head `head`, batch `batch`, of a 4-D map (D, row, head,
// batch), into the halves of a tile at `dst`: with the 64-row boxes of
// encode_rows_map's default, rows row .. row + 63 into a tile's first 64
// rows; with box_rows 128 (S3c), rows row .. row + 127, the whole tile in
// tma_tile's layout (the swizzle repeats every 8 rows)
__device__ __forceinline__ void tma_halves(unsigned char* dst,
                                           const CUtensorMap* map, int row,
                                           int head, int batch,
                                           uint64_t* bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_addr(dst + h * HA_HALF)), "l"(m), "r"(64 * h), "r"(row),
           "r"(head), "r"(batch), "r"(smem_addr(bar))
        : "memory");
  }
}

// a 128-row x D-column tile of 16-bit elements (rows from `row` of head
// `head`, batch `batch`; rows past the tensor are zero-filled) as 64 x 64
// boxes of a 4-D map (D, row, head, batch), one column half after the
// other: four boxes at D = 128, two at 64
template <int D = HA_D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, int row,
                                         int head, int batch, uint64_t* bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
#pragma unroll
  for (int h = 0; h < D / 64; ++h) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
          :: "r"(smem_addr(dst + h * HA_HALF + r * HA_BOX)), "l"(m),
             "r"(64 * h), "r"(row + 64 * r), "r"(head), "r"(batch),
             "r"(smem_addr(bar))
          : "memory");
    }
  }
}

// A 4-D map (D = d, 128 or 64, rows, heads, batch) of bf16 (dtype 0) or
// fp16 (1) elements with the given strides in elements, in boxes of 64
// columns x `box_rows` rows (at most 256) with the 128-byte swizzle; rows
// past `rows` read as zeros.  The stride of an axis of extent 1 is never
// applied, so it is replaced by a valid one.
int encode_rows_map(CUtensorMap* map, int dtype, const void* base,
                    long long rows, long long heads, long long batch,
                    long long row_stride, long long head_stride,
                    long long batch_stride, int box_rows = 64, int d = HA_D) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return -2;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                        (cuuint64_t)heads, (cuuint64_t)batch};
  long long st[4] = {1, row_stride, head_stride, batch_stride};
  for (int i = 1; i < 4; ++i)
    if (dims[i] == 1) st[i] = st[i - 1] * (long long)dims[i - 1];
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[3] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// mbar_wait that traps after ~2^34 cycles (seconds): a copy that never
// lands ends the kernel with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// wgmma operand descriptor of a 128-byte-swizzled tile: rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO); `lbo` is the distance between the
// two 64-column halves (read only for the transposed V operand)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads of wgmma accumulators, or writes to
// its register operands, across the wait (the asm of the wgmma does not
// name its completion)
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    asm volatile("" : "+r"(r[i >> 2][i & 3]) :: "memory");
}

#define HA_R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}, "
#define HA_F8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HA_F64                                                      \
  HA_F8(0), HA_F8(8), HA_F8(16), HA_F8(24), HA_F8(32), HA_F8(40),   \
      HA_F8(48), HA_F8(56)
#define HA_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}, "
#define HA_F32 HA_F8(0), HA_F8(8), HA_F8(16), HA_F8(24)
// d (64 x 128 fp32 of a warpgroup) += A B for one 16-deep step:
//   ss: A (64 x 16) and B (128 x 16, K-major) from shared memory; d is
//       overwritten where scale_d == 0
//   rs: A from registers (the m16n8k16 A fragment of each warp's 16 rows),
//       B (16 x 128) from shared memory as it is stored, a row per key with
//       its 128 columns contiguous: the transposed (MN-major) operand; on
//       a 64 x 64 d (32 floats a thread), m64n64k16 with B 16 x 64, one
//       column half (head_dim 64's O += P V)
#define HA_WGMMA(T, TY)                                                      \
  template <> struct Wgmma<T> {                                              \
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,    \
                                              uint64_t b, int scale_d) {     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"              \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY  \
                   " " HA_R64 "%64, %65, p, 1, 1, 0, 0;\n}\n"                \
                   : HA_F64 : "l"(a), "l"(b), "r"(scale_d));                 \
    }                                                                        \
    static __device__ __forceinline__ void rs(float (&d)[64],                \
                                              const uint32_t (&a)[4],        \
                                              uint64_t b) {                  \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"              \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY  \
                   " " HA_R64 "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
                   : HA_F64                                                  \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),     \
                     "r"(1));                                                \
    }                                                                        \
    static __device__ __forceinline__ void rs(float (&d)[32],                \
                                              const uint32_t (&a)[4],        \
                                              uint64_t b) {                  \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"              \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY   \
                   " " HA_R32 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
                   : HA_F32                                                  \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),     \
                     "r"(1));                                                \
    }                                                                        \
  };
template <typename T> struct Wgmma;
HA_WGMMA(__nv_bfloat16, "bf16")
HA_WGMMA(__half, "f16")
#undef HA_WGMMA
#define HA_I8(i)                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),      \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
// d (64 x 128 int32 of a warpgroup) += A B for one 32-deep step of int8:
// A (64 x 32) and B (128 x 32) K-major from shared memory (8-bit wgmma
// takes no transposed operand), d overwritten where scale_d == 0; the s32
// fragment has the f32 accumulator's layout
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HA_R64
               "%64, %65, p;\n}\n"
               : HA_I8(0), HA_I8(8), HA_I8(16), HA_I8(24), HA_I8(32),
                 HA_I8(40), HA_I8(48), HA_I8(56)
               : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void fence_regs(int (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}
#undef HA_I8
#undef HA_F32
#undef HA_R32
#undef HA_F64
#undef HA_F8
#undef HA_R64

// ------------------------------------------- int8 tiles (K1q's payload) ---
//
// The payload kv [rows, 256] int8 (K in bytes [0, 128) of a row, V in
// [128, 256)) is read by TMA in 128-row x 128-byte boxes with the 128-byte
// swizzle: row r at byte 128 r, its 16-byte chunk c at position c ^ (r & 7).
// That is the K-major layout the s8 wgmma reads as it stands (D = 128 is one
// swizzle row); a converter turns such a tile into the ring's 16-bit tile
// (two 64-column halves of 128 rows, the same swizzle), exactly.

constexpr int HA_TILE8 = 128 * 128;   // one int8 box: 16 KB

// A 2-D map over `rows` rows of `row_bytes` bytes (uint8, rows packed) in
// 128-row x 128-byte boxes with the 128-byte swizzle: a box is a K-major
// tile that the s8 wgmma reads as it stands.  K1q's payload has rows of
// 256 (K at column 0, V at 128), S1's a and b^T rows of 128.  0 on success.
int encode_rows8_map(CUtensorMap* map, const void* base, long long rows,
                     int row_bytes) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return -2;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {128, 128};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                            const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

// 8 int8 values (two words, lowest byte first) as 8 16-bit values, exactly,
// two at a time in bf16x2 / f16x2 arithmetic.  bf16: byte b (x = b as
// int8) gives 128 + (b & 127) (bits 0x4300 | b & 127) and -128 or -256
// (bits 0xC300 | b & 128), whose sum is x; fp16: bits 0x64uu hold 1024 + u
// with u = x + 128, minus 1152.
template <typename T> struct Cvt8;
template <> struct Cvt8<__nv_bfloat16> {
  static __device__ __forceinline__ uint4 run(uint2 w) {
    const uint32_t x[2] = {w.x, w.y};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t t = __byte_perm(x[i >> 1], 0u,
                                     (i & 1) ? 0x4342u : 0x4140u);
      const uint32_t a = (t & 0x007F007Fu) | 0x43004300u;
      const uint32_t c = (t & 0x00800080u) | 0xC300C300u;
      asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(o[i]) : "r"(a), "r"(c));
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Cvt8<__half> {
  static __device__ __forceinline__ uint4 run(uint2 w) {
    const uint32_t x[2] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t h = __byte_perm(x[i >> 1], 0x64u,
                                     (i & 1) ? 0x4342u : 0x4140u);
      asm("sub.f16x2 %0, %1, %2;\n" : "=r"(o[i]) : "r"(h), "r"(0x64806480u));
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

// one int8 tile (`src`, a swizzled box) into a 16-bit tile (`dst`) by a
// warpgroup: thread i converts columns 8 (i % 16) .. + 7 of rows i / 16 + 8 t,
// t = 0 .. 15.  Those rows share their swizzle, so the addresses step by
// 1024 bytes, and a warp's loads and stores are conflict-free.
template <typename T>
__device__ __forceinline__ void convert_tile(unsigned char* dst,
                                             const unsigned char* src,
                                             int i) {
  const int r = i >> 4, j = i & 15, x = r & 7;
  const unsigned char* s = src + r * 128 + (((j >> 1) ^ x) << 4) + ((j & 1) << 3);
  unsigned char* d = dst + (j >> 3) * HA_HALF + r * 128 + (((j & 7) ^ x) << 4);
#pragma unroll 8
  for (int t = 0; t < 16; ++t)
    *reinterpret_cast<uint4*>(d + t * 1024) =
        Cvt8<T>::run(*reinterpret_cast<const uint2*>(s + t * 1024));
}

// ---------------------------------------------- fp32 tiles (T = float) ---

// Where a unit's key rows, or a tile's q rows, lie in global memory: the
// first row, the row stride in elements, and the rows that exist from
// there (later rows read as zeros)
struct Rows {
  const float* p;
  long long stride;
  int n;
};

// ROWS rows of D fp32 columns (times `scale`) into the bf16 tiles `hi`
// (bf16(x)) and `lo` (bf16(x - hi)) in tma_tile's swizzled layout, by 128
// threads: thread i splits columns 8 (i % (D / 8)) .. + 7 of every
// (128 / (D / 8))-th row from row i / (D / 8), two 16-byte loads and a
// 16-byte store into each tile a row; a warp reads whole rows.
template <int D, int ROWS>
__device__ __forceinline__ void split_rows(unsigned char* hi,
                                           unsigned char* lo,
                                           const Rows& src, int i,
                                           float scale) {
  constexpr int CH = D / 8, STEP = 128 / CH;
  const int j = i % CH, r0 = i / CH;
  const float* g = src.p + 8 * j;
#pragma unroll 4
  for (int t = 0; t < ROWS / STEP; ++t) {
    const int r = r0 + t * STEP;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r < src.n) {
      const float4* x = reinterpret_cast<const float4*>(g + r * src.stride);
      a = __ldg(x);
      b = __ldg(x + 1);
    }
    const float v[8] = {a.x * scale, a.y * scale, a.z * scale, a.w * scale,
                        b.x * scale, b.y * scale, b.z * scale, b.w * scale};
    uint32_t h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = Type<__nv_bfloat16>::pack(v[2 * k], v[2 * k + 1]);
      const float2 f = Type<__nv_bfloat16>::unpack(h[k]);
      l[k] = Type<__nv_bfloat16>::pack(v[2 * k] - f.x, v[2 * k + 1] - f.y);
    }
    const int off = (j >> 3) * HA_HALF + r * 128 + (((j & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// One consumer thread's view of its warpgroup's 64 rows: rows
// 16 * warp + g (r = 0) and + 8 (r = 1) with g = lane / 4; column
// 8 j + 2 (lane % 4) + e of a 128-wide accumulator is element 4 j + 2 r + e.
struct Frag {
  int wg;       // consumer warpgroup, 0 or 1: rows 64 wg .. 64 wg + 63
  int wtid;     // thread within the warpgroup
  int row;      // the tile row of r = 0 (r = 1 is row + 8)
  int t4;       // lane % 4
};

// The head_dim and the ablations' hooks, which a policy inherits from
// MainloopBase<D> (MainloopDefaults: D = 128) and may hide:
//   D           the head_dim, 64 or 128: a q, K or V tile holds D / 64
//               column halves, O is 64 x D a warpgroup (D / 2 floats a
//               thread) and O += P V runs m64nDk16;
//   STAGES      the ring's depth;
//   copy(p, tile, row, dst, full): the unit's copies into ring stage dst,
//               counted on its full barrier: K and V, COPY_BYTES (64 KB
//               at D = 128, 32 KB at 64);
//   COPIES      false: the walk copies nothing; the producer fills each
//               stage at its first use with keys 0-63 of the tile's K and
//               V in both 64-row halves, and later only arrives on it;
//   LOAD_ONLY   true: the consumers wait for each unit, call
//               load_only(p, tile, u, k_stage, o, frag) and hand the stage
//               back (no products, no softmax);
//   LINEAR      true: exp replaced by the scripts' linear form, alpha =
//               m_prev - m_next + 1 and p = s - m_next;
//   Cursor      the producer's state across one tile's units, made anew
//               (value-initialised) for each tile and handed to key_row;
//               by default empty.
template <int D_>
struct MainloopBase {
  static constexpr int D = D_;
  static constexpr int STAGES = HA_STAGES;
  static constexpr bool COPIES = true;
  static constexpr int TILE_BYTES = ha_tile(D_);
  static constexpr int COPY_BYTES = 2 * TILE_BYTES;
  static constexpr bool LOAD_ONLY = false;
  static constexpr bool LINEAR = false;
  template <class Params, class Tile>
  static __device__ __forceinline__ void copy(const Params& p, const Tile& c,
                                              int row, unsigned char* dst,
                                              uint64_t* full) {
    tma_tile<D_>(dst, &p.tmk, row, c.kv_head, c.kv_batch, full);
    tma_tile<D_>(dst + TILE_BYTES, &p.tmv, row, c.kv_head, c.kv_batch, full);
  }
  struct Cursor {};
};
using MainloopDefaults = MainloopBase<HA_D>;

// The ring's depth: the policy's, but one stage for fp32 at D = 128 (two
// would not fit: ha_smem)
template <typename T, class P>
__host__ __device__ constexpr int ha_stages() {
  return std::is_same<T, float>::value && P::D == HA_D ? 1 : P::STAGES;
}

// The shared mainloop.  P (the policy, a MainloopDefaults) provides
//   Params (with CUtensorMap tmq, tmk, tmv), Tile, Window, SCALE_Q,
//   first(p) / count(p) / stride(p): the tiles this CTA walks,
//   tile(p, t): a tile's copies (q and kv coordinates, units u0 .. u1),
//   next(p, tile, u): the first unit >= u that the tile walks (u itself
//     for a policy that walks every unit),
//   key_row(p, tile, u, cursor): the first key row of unit u, read by the
//     producer with its Cursor (a hook above),
//   window(p, tile, u, frag) -> Window: unit u's key window, once,
//   mask(p, window, s): the thread's 64 scores of the unit masked (and
//     scaled) by selects,
//   finish(p, tile, o, m, l, frag, sums): what follows the walk;
//   for T = float also q_rows(p, tile) and kv_rows(p, tile, kv, row) ->
//     Rows: the tile's q rows, and K (kv = 0) or V (1) from key row `row`.
template <typename T, class P>
__global__ void __launch_bounds__(HA_THREADS, 1)
hopper_attn_kernel(const __grid_constant__ typename P::Params p) {
  constexpr bool F32 = std::is_same<T, float>::value;
  // the operands' type on the tensor cores (fp32: bf16 hi and lo)
  using W = typename std::conditional<F32, __nv_bfloat16, T>::type;
  constexpr int NS = ha_stages<T, P>();
  constexpr int D = P::D;
  constexpr int TILE = ha_tile(D);    // a q, K or V tile
  constexpr int KV = F32 ? 2 * TILE : TILE;   // K (or V): fp32 hi and lo
  constexpr int STAGE = 2 * KV;       // K and V of one unit
  constexpr int NB = F32 ? 2 * NS : NS;   // fp32: K and V barriers apart
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static_assert(P::COPIES || D == HA_D, "the copy-free walk fills 128 columns");
  static_assert(!F32 || (P::COPIES && !P::LOAD_ONLY),
                "fp32 takes the walk that copies and computes");
  extern __shared__ unsigned char ha_raw[];
  unsigned char* sq = ha_raw + ((1024u - (smem_addr(ha_raw) & 1023u)) & 1023u);
  unsigned char* ring = sq + KV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + NS * STAGE);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + NB;
  float* sums = reinterpret_cast<float*>(bars + 2 + 2 * NB);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, HA_CONSUMERS);
    for (int s = 0; s < NB; ++s) {
      // fp32: the producer warpgroup's threads arrive
      mbar_init(&full[s], F32 ? HA_THREADS - HA_CONSUMERS : 1);
      mbar_init(&empty[s], HA_CONSUMERS);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (tid >= HA_CONSUMERS) {
    if constexpr (F32) {
      // producer: every thread splits a unit's fp32 K rows, then its V
      // rows, into the stage's hi and lo tiles (K of the next unit while
      // the consumers still read this unit's V)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
      const int ci = tid - HA_CONSUMERS;
      int st = 0;
      uint32_t ph = 0;
      for (int t = P::first(p); t < P::count(p); t += P::stride(p)) {
        const typename P::Tile c = P::tile(p, t);
        typename P::Cursor cur{};
        for (int u = P::next(p, c, c.u0); u < c.u1; u = P::next(p, c, u + 1)) {
          const int row = P::key_row(p, c, u, cur);
          unsigned char* dst = ring + st * STAGE;
#pragma unroll 1
          for (int kv = 0; kv < 2; ++kv) {
            mbar_wait_or_trap(&empty[2 * st + kv], ph ^ 1);
            split_rows<D, HA_KEYS>(dst + kv * KV, dst + kv * KV + TILE,
                                   P::kv_rows(p, c, kv, row), ci, 1.f);
            // the generic writes, visible to wgmma (the async proxy)
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(&full[2 * st + kv]);
          }
          if (++st == NS) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    } else {
    // producer: one thread issues the copies; the ring's parity starts
    // flipped so that its first wait on each empty stage passes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == HA_CONSUMERS) {
      int st = 0, filled = 0;
      uint32_t ph = 0, qph = 0;
      for (int t = P::first(p); t < P::count(p); t += P::stride(p)) {
        const typename P::Tile c = P::tile(p, t);
        mbar_wait_or_trap(q_empty, qph ^ 1);
        mbar_expect_tx(q_full, TILE);
        tma_tile<D>(sq, &p.tmq, c.q_row, c.q_head, c.q_batch, q_full);
        qph ^= 1;
        typename P::Cursor cur{};
        for (int u = P::next(p, c, c.u0); u < c.u1; u = P::next(p, c, u + 1)) {
          const int row = P::key_row(p, c, u, cur);   // loads overlap the wait
          mbar_wait_or_trap(&empty[st], ph ^ 1);
          if constexpr (P::COPIES) {
            mbar_expect_tx(&full[st], P::COPY_BYTES);
            unsigned char* dst = ring + st * STAGE;
            P::copy(p, c, row, dst, &full[st]);
          } else if (filled < NS) {
            // the stage's first use: keys 0-63 of K and V, in both halves
            ++filled;
            mbar_expect_tx(&full[st], HA_STAGE);
            unsigned char* dst = ring + st * HA_STAGE;
#pragma unroll
            for (int kv = 0; kv < 2; ++kv) {
              const CUtensorMap* map = kv ? &p.tmv : &p.tmk;
              tma_halves(dst + kv * HA_TILE, map, 0, c.kv_head, c.kv_batch,
                         &full[st]);
              tma_halves(dst + kv * HA_TILE + HA_BOX, map, 0, c.kv_head,
                         c.kv_batch, &full[st]);
            }
          } else {
            mbar_arrive(&full[st]);   // the stage still holds that tile
          }
          if (++st == NS) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    }
  } else {
    if constexpr (F32)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    Frag f;
    f.wg = tid >> 7;
    f.wtid = tid & 127;
    f.row = 64 * f.wg + 16 * (f.wtid >> 5) + ((tid & 31) >> 2);
    f.t4 = tid & 3;
    const unsigned char* qw = sq + f.wg * HA_BOX;   // this warpgroup's rows
    int st = 0;
    uint32_t ph = 0, qph = 0;
    for (int t = P::first(p); t < P::count(p); t += P::stride(p)) {
      const typename P::Tile c = P::tile(p, t);
      if constexpr (F32) {
        // this warpgroup's 64 q rows (times sm_scale where the policy
        // scales q) split into its rows of the hi and lo tiles; its own
        // products of the previous tile are done
        Rows src = P::q_rows(p, c);
        src.p += 64 * f.wg * src.stride;
        src.n -= 64 * f.wg;
        split_rows<D, 64>(sq + f.wg * HA_BOX, sq + TILE + f.wg * HA_BOX, src,
                          f.wtid, P::SCALE_Q ? p.sm_scale : 1.f);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync(f.wg);
      } else {
      mbar_wait_or_trap(q_full, qph);
      qph ^= 1;
      if constexpr (P::SCALE_Q) {
        // q * sm_scale in fp32, rounded to T, in place (elementwise, so
        // the swizzle does not matter); then visible to wgmma
#pragma unroll
        for (int i = 0; i < 4 * (D / 64); ++i) {
          uint4* v = reinterpret_cast<uint4*>(
              sq + (i >> 2) * HA_HALF + f.wg * HA_BOX) + (i & 3) * 128 + f.wtid;
          uint4 x = *v;
          uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 a = Type<T>::unpack(w[j]);
            w[j] = Type<T>::pack(a.x * p.sm_scale, a.y * p.sm_scale);
          }
          *v = x;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync(f.wg);
      }
      }
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {neg_inf(), neg_inf()};
      float l[2] = {0.f, 0.f};   // this thread's 32 columns of each row
      for (int u = P::next(p, c, c.u0), un; u < c.u1; u = un) {
        // the unit's key window, read before the waits hide its loads
        const typename P::Window win = P::window(p, c, u, f);
        mbar_wait_or_trap(&full[F32 ? 2 * st : st], ph);
        const unsigned char* ks = ring + st * STAGE;
        if constexpr (P::LOAD_ONLY) {
          P::load_only(p, c, u, ks, o, f);
          un = P::next(p, c, u + 1);
          if (un >= c.u1) mbar_arrive(q_empty);
          mbar_arrive(&empty[st]);
          if (++st == NS) {
            st = 0;
            ph ^= 1;
          }
          continue;
        }
        const unsigned char* vs = ks + KV;
        float s[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk >> 2) * HA_HALF + (kk & 3) * 32;
          Wgmma<W>::ss(s, sw128_desc(qw + off, 16), sw128_desc(ks + off, 16),
                       kk);
          if constexpr (F32) {
            // + q hi K lo + q lo K hi
            Wgmma<W>::ss(s, sw128_desc(qw + off, 16),
                         sw128_desc(ks + TILE + off, 16), 1);
            Wgmma<W>::ss(s, sw128_desc(qw + TILE + off, 16),
                         sw128_desc(ks + off, 16), 1);
          }
        }
        wgmma_commit();
        un = P::next(p, c, u + 1);   // its loads overlap the products
        wgmma_wait_all();
        fence_regs(s);
        if constexpr (F32)
          mbar_arrive(&empty[2 * st]);   // K is read no more
        else if (un >= c.u1)
          mbar_arrive(q_empty);   // q is read no more
        P::mask(p, win, s);

        // online softmax over the unit (a row's 128 scores sit in the
        // 4 threads of a quad)
        float mc[2] = {neg_inf(), neg_inf()};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          mc[0] = fmaxf(mc[0], fmaxf(s[4 * j], s[4 * j + 1]));
          mc[1] = fmaxf(mc[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
          mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
          const float m_new = fmaxf(m[r], mc[r]);
          if constexpr (P::LINEAR)
            alpha[r] = m[r] - m_new + 1.f;
          else
            alpha[r] = __expf(m[r] - m_new);
          m[r] = m_new;
        }
        float ls[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          float e;
          if constexpr (P::LINEAR)
            e = s[i] - m[(i >> 1) & 1];
          else
            e = __expf(s[i] - m[(i >> 1) & 1]);
          s[i] = e;
          ls[(i >> 1) & 1] += e;
        }
        l[0] = alpha[0] * l[0] + ls[0];
        l[1] = alpha[1] * l[1] + ls[1];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        uint32_t pa[8][4];
        uint32_t pl[F32 ? 8 : 1][4];   // fp32: P's lo part
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            pa[kk][q] = Type<W>::pack(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
            if constexpr (F32) {
              const float2 h = Type<W>::unpack(pa[kk][q]);
              pl[kk][q] = Type<W>::pack(s[8 * kk + 2 * q] - h.x,
                                        s[8 * kk + 2 * q + 1] - h.y);
            }
          }
        }
        if constexpr (F32) {
          // this unit's P V (ph vh + ph vl + pl vh) in an accumulator of
          // its own, added to O in fp32 on the CUDA cores: the tensor
          // cores' accumulation rounds toward zero, and a running sum
          // there over 10^5 keys drifts by ~1e-4 of O
          float ou[D / 2];
#pragma unroll
          for (int i = 0; i < D / 2; ++i) ou[i] = 0.f;
          mbar_wait_or_trap(&full[2 * st + 1], ph);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            Wgmma<W>::rs(ou, pa[kk], sw128_desc(vs + kk * 2048, HA_HALF));
            Wgmma<W>::rs(ou, pa[kk],
                         sw128_desc(vs + TILE + kk * 2048, HA_HALF));
            Wgmma<W>::rs(ou, pl[kk], sw128_desc(vs + kk * 2048, HA_HALF));
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(ou);
          fence_regs(pa);
          fence_regs(pl);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] += ou[i];
        } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          Wgmma<W>::rs(o, pa[kk], sw128_desc(vs + kk * 2048, HA_HALF));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);
        }
        mbar_arrive(&empty[F32 ? 2 * st + 1 : st]);
        if (++st == NS) {
          st = 0;
          ph ^= 1;
        }
      }
      if (!F32 && P::next(p, c, c.u0) >= c.u1)
        mbar_arrive(q_empty);   // a tile without units
      P::finish(p, c, o, m, l, f, sums + 128 * f.wg);
    }
  }
}

// l summed over the quad that holds a row; inv = 1 / l (1 where l == 0)
__device__ __forceinline__ void quad_sum(float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
  }
}

template <typename T, class P>
int launch_hopper_attn(const typename P::Params& p, dim3 grid,
                       cudaStream_t stream) {
  constexpr int smem = ha_smem(ha_stages<T, P>(), P::D,
                               std::is_same<T, float>::value);
  auto kern = hopper_attn_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, HA_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
