// S1: the int8 tensor-core probe for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _loop_kernel of scripts/bench_int8mxu.py
// (:30, launched at :50), which asks whether int8 x int8 -> int32 dots run
// natively on the matrix unit at the gather kernel's tile shape: a [128, 128]
// by [128, 2048] dot looped REPS = 64 times from resident buffers, each
// adding its first 128 columns times (i + 1) to an fp32 [128, 128] output.
// The mxu8 mode of K1q depends on that primitive.  On Hopper the question
// is the attention mainloop's own instructions: int8 runs
// wgmma.m64n128k32.s32.s8.s8 (K1q mxu8's QK^T), bf16 wgmma.m64n128k16 with
// fp32 accumulation (K1 / K2 / K3's S = QK^T), both operands read from
// shared memory K-major, fed by TMA.
//
// Design: the mainloop's CTA (hopper_attn.cuh) and its parts.  384 threads:
// one producer warp issues the TMA copies (setmaxnreg 40), two consumer
// warpgroups (232) each own 64 rows of `a`.  The grid is persistent: CTA
// i walks pairs i, i + grid, ...  Per pair, `a` arrives once (one 128 x
// 128-byte box for int8, two 64-column halves for bf16, 128-byte swizzle)
// and b^T (k contiguous, from the wrapper) in tiles of 128 columns x 128 k
// (16 KB int8, 32 KB bf16) into a ring of mbarrier stages.  Every tile is
// multiplied REPS times before its stage is released (the same set of
// dots as the loop over REPS of whole products, in another order), so the
// probe never waits on device memory: 4.3 G operations per pair against
// 0.5 MB (bf16) of b.  Tiles t > 0 (columns 128-2047, discarded) chain
// their REPS products on one accumulator and wait once per tile; on the
// t = 0 tile a warpgroup folds each product into the output as it
// completes, while the other warpgroup's product runs.  (Two accumulator
// banks a warpgroup, so that its own next product runs during the fold,
// need 2 x 64 + 64 registers: ptxas allocates a 384-thread CTA 168 a
// thread whatever setmaxnreg gives at run time, and that design spilled
// 364-548 bytes and serialized its wgmma.)  The fold sums in the Pallas
// kernel's order without contraction, so the int8 result equals the
// plain version bit for bit: each int32 product c (|c| <= 2^21) becomes
// fp32 by the magic number 1.5 * 2^23, and fmaf(c + 1.5 * 2^23, w,
// -1.5 * 2^23 * w) is c * w rounded once, which is __fmul_rn((float)c, w):
// one integer add and one fma in place of a conversion and a multiply
// (the SM issues conversions at a lower rate).
//
// What bounds it on the H100: tensor-core operations, 2 * 128 * 128 *
// 2048 * 64 = 4.29 G a pair (1,979 TOP/s int8, 989 TFLOP/s bf16 dense).
// Each m64n128 wgmma reads 6 KB of shared memory for 64 cycles of the
// SM's tensor cores: 96 bytes a cycle of the 128 the SM has, the
// instruction shape's own ceiling, which the probe measures.

#include <type_traits>

#include "hopper_attn.cuh"

namespace {

constexpr int M = 128, D = 128, N = 2048, REPS = 64;
constexpr int TN = 128;            // columns of b per shared-memory tile
constexpr int NT = N / TN;         // tiles a pair
constexpr int STAGES = 4;

template <bool INT8>
struct Probe {
  using Acc = typename std::conditional<INT8, int, float>::type;
  // a and a b^T tile: 128 rows of D elements (16 KB int8, 32 KB bf16)
  static constexpr int TILE = M * D * (INT8 ? 1 : 2);
  static constexpr int KS = INT8 ? 4 : 8;   // k-steps of 32 bytes
  static constexpr int SMEM = 1024 + (1 + STAGES) * TILE + 8 * (2 + 2 * STAGES);

  struct Params {
    CUtensorMap tma, tmb;   // the rows of a and of b^T
    float* out;             // [pairs, 128, 128]
    int pairs;
    int zero;               // 0 (see the tiles t > 0)
  };

  // k-step kk of a tile: int8 rows are 128 bytes, 32 a step; bf16 rows
  // lie in two 64-column halves of 128 bytes (the mainloop's q and K
  // layout)
  static __device__ __forceinline__ int koff(int kk) {
    return INT8 ? 32 * kk : (kk >> 2) * HA_HALF + (kk & 3) * 32;
  }

  // d = a_w (64 x 128) times the tile's 128 columns: KS wgmma, the
  // first with scale_d `first` (0: d is overwritten)
  static __device__ __forceinline__ void product(Acc (&d)[64],
                                                 const unsigned char* aw,
                                                 const unsigned char* bs,
                                                 int first) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t da = sw128_desc(aw + koff(kk), 16);
      const uint64_t db = sw128_desc(bs + koff(kk), 16);
      if constexpr (INT8)
        wgmma_s8(d, da, db, kk ? 1 : first);
      else
        Wgmma<__nv_bfloat16>::ss(d, da, db, kk ? 1 : first);
    }
  }

  // acc += c * w, each step rounded (see the file's head for int8)
  static __device__ __forceinline__ void fold(float (&acc)[64],
                                              const Acc (&c)[64], int rep) {
    const float w = (float)(rep + 1);
    if constexpr (INT8) {
      const float cw = -12582912.f * w;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i] = __fadd_rn(acc[i], __fmaf_rn(__int_as_float(c[i] + 0x4B400000),
                                             w, cw));
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(c[i], w));
    }
  }

  static __device__ __forceinline__ void load(unsigned char* dst,
                                              const CUtensorMap* map, int row,
                                              uint64_t* bar) {
    if constexpr (INT8)
      tma_load(dst, map, 0, row, bar);
    else
      tma_halves(dst, map, row, 0, 0, bar);
  }
};

template <bool INT8>
__global__ void __launch_bounds__(HA_THREADS, 1)
loop_kernel(const __grid_constant__ typename Probe<INT8>::Params p) {
  using P = Probe<INT8>;
  using Acc = typename P::Acc;
  extern __shared__ unsigned char probe_raw[];
  unsigned char* sa = probe_raw + ((1024u - (smem_addr(probe_raw) & 1023u)) & 1023u);
  unsigned char* ring = sa + P::TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * P::TILE);
  uint64_t* a_full = bars;
  uint64_t* a_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(a_full, 1);
    mbar_init(a_empty, HA_CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], HA_CONSUMERS);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (tid >= HA_CONSUMERS) {
    // producer: one thread issues the copies; the parities start flipped
    // so that the first wait on each empty barrier passes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == HA_CONSUMERS) {
      int st = 0;
      uint32_t ph = 0, aph = 0;
      for (int pair = blockIdx.x; pair < p.pairs; pair += gridDim.x) {
        mbar_wait_or_trap(a_empty, aph ^ 1);
        aph ^= 1;
        mbar_expect_tx(a_full, P::TILE);
        P::load(sa, &p.tma, pair * M, a_full);
        for (int t = 0; t < NT; ++t) {
          mbar_wait_or_trap(&empty[st], ph ^ 1);
          mbar_expect_tx(&full[st], P::TILE);
          P::load(ring + st * P::TILE, &p.tmb, pair * N + t * TN, &full[st]);
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  Frag f;
  f.wg = tid >> 7;
  f.wtid = tid & 127;
  f.row = 64 * f.wg + 16 * (f.wtid >> 5) + ((tid & 31) >> 2);
  f.t4 = tid & 3;
  const unsigned char* aw = sa + f.wg * HA_BOX;   // this warpgroup's 64 rows
  int st = 0;
  uint32_t ph = 0, aph = 0;
  for (int pair = blockIdx.x; pair < p.pairs; pair += gridDim.x) {
    mbar_wait_or_trap(a_full, aph);
    aph ^= 1;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    Acc c[64];
    for (int t = 0; t < NT; ++t) {
      mbar_wait_or_trap(&full[st], ph);
      const unsigned char* bs = ring + st * P::TILE;
      if (t == 0) {
        // the output's columns: each product is folded as it completes,
        // while the other warpgroup's product runs
#pragma unroll 1
        for (int r = 0; r < REPS; ++r) {
          wgmma_fence();
          P::product(c, aw, bs, 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(c);
          P::fold(acc, c, r);
        }
      } else {
        // columns past the output: REPS products chained on one
        // accumulator, one wait.  Their first k-step's scale_d is
        // p.zero (0) and c is stored if p.zero is set: the compiler
        // cannot prove the products dead, and drops none
        wgmma_fence();
#pragma unroll 4
        for (int r = 0; r < REPS; ++r) P::product(c, aw, bs, p.zero);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(c);
        if (p.zero) {
#pragma unroll
          for (int i = 0; i < 64; ++i)
            p.out[(long long)pair * M * TN + 256 * i + tid] = (float)c[i];
        }
      }
      if (t == NT - 1) mbar_arrive(a_empty);   // a is read no more
      mbar_arrive(&empty[st]);
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    // the accumulator fragment (Frag): rows row and row + 8, columns
    // 8 j + 2 t4 + e at element 4 j + 2 r + e
    float* o = p.out + ((long long)pair * M + f.row) * TN + 2 * f.t4;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(o + r * 8 * TN + 8 * j) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <bool INT8>
int launch(const void* a, const void* bt, float* out, int pairs,
           cudaStream_t stream) {
  using P = Probe<INT8>;
  typename P::Params p{};
  const long long arows = (long long)pairs * M, brows = (long long)pairs * N;
  const int bad =
      INT8 ? (encode_rows8_map(&p.tma, a, arows, D) ||
              encode_rows8_map(&p.tmb, bt, brows, D))
           : (encode_rows_map(&p.tma, 0, a, arows, 1, 1, D, 0, 0, 128) ||
              encode_rows_map(&p.tmb, 0, bt, brows, 1, 1, D, 0, 0, 128));
  if (bad) return -2;
  p.out = out;
  p.pairs = pairs;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  auto kern = loop_kernel<INT8>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<pairs < sms ? pairs : sms, HA_THREADS, P::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a [pairs, 128, 128], bt [pairs, 2048, 128] (b transposed), both bf16
// (int8 = 0) or int8 (int8 = 1), 16-byte aligned; out [pairs, 128, 128]
// fp32.  Returns a cudaError_t value (0 on success), -2 if a tensor map
// cannot be encoded.
int rsa_s1_launch(const void* a, const void* bt, float* out, int pairs,
                  int int8, void* stream) {
  return int8 ? launch<true>(a, bt, out, pairs, (cudaStream_t)stream)
              : launch<false>(a, bt, out, pairs, (cudaStream_t)stream);
}

const char* rsa_error_string(int code) {
  if (code == -2) return "cuTensorMapEncodeTiled failed (S1's tensor maps)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
