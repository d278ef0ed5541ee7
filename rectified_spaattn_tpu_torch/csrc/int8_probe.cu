// S1: the int8 tensor-core probe for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _loop_kernel of scripts/bench_int8mxu.py
// (:30, launched at :50), which asks whether int8 x int8 -> int32 dots run
// natively on the matrix unit at the gather kernel's tile shape: a [128, 128]
// by [128, 2048] dot looped REPS = 64 times from resident buffers, each
// adding its first 128 columns times (i + 1) to an fp32 [128, 128] output.
// The mxu8 mode of K1q depends on that primitive.
//
// One thread block computes that output for one independent (a, b) pair,
// and the wrapper launches enough pairs to fill every SM.  The operand
// arrangement is K1's: each of 8 warps holds its 16 rows of `a` as mma.sync A
// fragments in registers; `b` comes in 128-column tiles (b transposed, k
// contiguous, by the wrapper) into shared memory and is read with ldmatrix.
// Every tile is multiplied REPS times before the next one loads (the same
// set of dots as the loop over REPS of whole products, in another order), so
// the probe never waits on device memory: 4.3 G operations per pair against
// 0.5 MB (bf16) of b.  What bounds it is mma.sync and the ldmatrix operand
// traffic of K1's arrangement, which is the question.  bf16 runs
// mma.sync.m16n8k16 with fp32
// accumulation, int8 mma.sync.m16n8k32 with int32 accumulation.  The output
// sums in the Pallas kernel's order without contraction (__fmul_rn /
// __fadd_rn), so the int8 result equals the plain version bit for bit.

#include <type_traits>

#include "attn_common.cuh"

namespace {

constexpr int M = 128, D = 128, N = 2048, REPS = 64;
constexpr int TN = 128;          // columns of b per shared-memory tile
constexpr int NTHREADS = 256;    // 8 warps x 16 rows

template <bool INT8>
constexpr int probe_smem_bytes() {
  return (M + TN) * (D * (INT8 ? 1 : 2) + 16);
}

template <bool INT8>
__global__ void __launch_bounds__(NTHREADS)
loop_kernel(const void* a, const void* bt, float* out) {
  constexpr int ROWB = D * (INT8 ? 1 : 2);   // bytes per row of a / b^T
  constexpr int LDB = ROWB + 16;             // padded smem row
  constexpr int KS = INT8 ? D / 32 : D / 16; // k-steps of 32 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sA = smem_raw;              // [M][LDB]
  unsigned char* sB = smem_raw + M * LDB;    // [TN][LDB]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;
  const unsigned char* ag =
      static_cast<const unsigned char*>(a) + (long long)blockIdx.x * M * ROWB;
  const unsigned char* bg =
      static_cast<const unsigned char*>(bt) + (long long)blockIdx.x * N * ROWB;

  for (int i = tid; i < M * ROWB / 16; i += NTHREADS) {
    const int r = i / (ROWB / 16), c = (i % (ROWB / 16)) * 16;
    cp_async16(sA + r * LDB + c, ag + r * ROWB + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t af[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(af[kk], sA + (warp * 16 + (lane & 15)) * LDB + kk * 32 + (lane >> 4) * 16);

  float acc[TN / 8][4];
#pragma unroll
  for (int n = 0; n < TN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < N / TN; ++t) {
    __syncthreads();   // the previous tile is consumed
    for (int i = tid; i < TN * ROWB / 16; i += NTHREADS) {
      const int r = i / (ROWB / 16), c = (i % (ROWB / 16)) * 16;
      cp_async16(sB + r * LDB + c, bg + (long long)(t * TN + r) * ROWB + c);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int rep = 0; rep < REPS; ++rep) {
      using C = typename std::conditional<INT8, int, float>::type;
      C c[TN / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < TN / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, sB + (np * 16 + (mi >> 1) * 8 + r8) * LDB + kk * 32 + (mi & 1) * 16);
          if constexpr (INT8) {
            mma_s8(c[2 * np], af[kk], bf[0], bf[1]);
            mma_s8(c[2 * np + 1], af[kk], bf[2], bf[3]);
          } else {
            Type<__nv_bfloat16>::mma(c[2 * np], af[kk], bf[0], bf[1]);
            Type<__nv_bfloat16>::mma(c[2 * np + 1], af[kk], bf[2], bf[3]);
          }
        }
      }
      if (t == 0) {   // the output folds in the first 128 columns
        const float w = (float)(rep + 1);
#pragma unroll
        for (int n = 0; n < TN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = __fadd_rn(acc[n][e], __fmul_rn((float)c[n][e], w));
      }
    }
  }
  float* o0 = out + ((long long)blockIdx.x * M + warp * 16 + g) * TN + 2 * t4;
  float* o1 = o0 + 8 * TN;
#pragma unroll
  for (int n = 0; n < TN / 8; ++n) {
    *reinterpret_cast<float2*>(o0 + n * 8) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(o1 + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
}

template <bool INT8>
int launch(const void* a, const void* bt, float* out, int pairs,
           cudaStream_t stream) {
  constexpr int smem = probe_smem_bytes<INT8>();
  auto kern = loop_kernel<INT8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<pairs, NTHREADS, smem, stream>>>(a, bt, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a [pairs, 128, 128], bt [pairs, 2048, 128] (b transposed), both bf16
// (int8 = 0) or int8 (int8 = 1); out [pairs, 128, 128] fp32.  Returns a
// cudaError_t value (0 on success).
int rsa_s1_launch(const void* a, const void* bt, float* out, int pairs,
                  int int8, void* stream) {
  return int8 ? launch<true>(a, bt, out, pairs, (cudaStream_t)stream)
              : launch<false>(a, bt, out, pairs, (cudaStream_t)stream);
}

const char* rsa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
