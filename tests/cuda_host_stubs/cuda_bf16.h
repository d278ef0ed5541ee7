// Host-compiler stand-in (see cuda_runtime.h beside this file).
#pragma once
struct __nv_bfloat16 { unsigned short x; }; struct __nv_bfloat162 { __nv_bfloat16 x, y; };
__nv_bfloat162 __floats2bfloat162_rn(float, float); float2 __bfloat1622float2(__nv_bfloat162); float __bfloat162float(__nv_bfloat16);
