// Device helpers shared by the port's kernels (hopper_attn.cuh and its
// users): the masked-score constant, -inf, the 16-bit packing of bf16 and
// fp16 pairs, and the shared-memory address of a pointer.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

template <typename T> struct Type;

template <> struct Type<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  }
};

template <> struct Type<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<__half2*>(&x));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

}  // namespace
