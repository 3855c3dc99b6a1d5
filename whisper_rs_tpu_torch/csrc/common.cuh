// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Every library exports this, so the Python wrapper can name a launch error.
extern "C" const char* kernel_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Four consecutive elements as f32 (one 16-byte load for f32, 8 bytes for
// bf16, 4 for int8); the pointer must be aligned to the vector.
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    return make_float4(c.x, c.y, c.z, c.w);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// Round an f32 value to the precision of T and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
    return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
