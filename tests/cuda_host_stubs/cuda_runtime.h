// Host-compiler stand-ins for the CUDA names that the port's kernel sources
// use (rectified_spaattn_tpu_torch/csrc), so that tests/test_torch_csrc.py
// can run g++ -fsyntax-only over them where there is no nvcc: every
// template the sources instantiate is checked for names, types and
// syntax.  No code is generated; inline PTX is not checked.  A source that
// uses a CUDA name missing here needs its declaration added.
#pragma once
#include <cstddef>
#include <cstdint>
#include <cmath>
#include <algorithm>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
#define __align__(n)
using std::min; using std::max; using std::isfinite;
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
extern uint3 threadIdx, blockIdx, blockDim; extern dim3 gridDim;
typedef int cudaError_t; enum { cudaSuccess = 0 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int);
cudaError_t cudaGetLastError();
const char* cudaGetErrorString(cudaError_t);
cudaError_t cudaGetDevice(int*);
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess };
enum { cudaEnableDefault = 0 };
cudaError_t cudaGetDriverEntryPoint(const char*, void**, unsigned long long, cudaDriverEntryPointQueryResult*);
struct uint4 { unsigned x, y, z, w; }; struct uint2 { unsigned x, y; };
struct float2 { float x, y; }; struct float4 { float x, y, z, w; };
uint4 make_uint4(unsigned, unsigned, unsigned, unsigned); uint2 make_uint2(unsigned, unsigned);
float2 make_float2(float, float); float4 make_float4(float, float, float, float);
float4 __ldg(const float4*); uint4 __ldg(const uint4*);
float __shfl_xor_sync(unsigned, float, int); int __shfl_xor_sync(unsigned, int, int);
int __reduce_add_sync(unsigned, int); int __reduce_min_sync(unsigned, int); int __reduce_max_sync(unsigned, int);
float __expf(float); float __int_as_float(int); int __float_as_int(float); float __fmul_rn(float, float); float __fadd_rn(float, float); float __fmaf_rn(float, float, float);
int __float2int_rn(float); unsigned __byte_perm(unsigned, unsigned, unsigned);
void __syncthreads(); void __trap(); long long clock64();
size_t __cvta_generic_to_shared(const void*);
