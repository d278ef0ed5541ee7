// Host-compiler stand-in (see cuda_runtime.h beside this file).
#pragma once
#include <cstdint>
typedef uint32_t cuuint32_t; typedef uint64_t cuuint64_t;
struct CUtensorMap { alignas(64) unsigned long long opaque[16]; };
typedef int CUresult; enum { CUDA_SUCCESS = 0 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_128B };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_128B };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE };
