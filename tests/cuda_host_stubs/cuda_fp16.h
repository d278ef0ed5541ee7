// Host-compiler stand-in (see cuda_runtime.h beside this file).
#pragma once
struct __half { unsigned short x; }; struct __half2 { __half x, y; };
__half2 __floats2half2_rn(float, float); float2 __half22float2(__half2); float __half2float(__half);
