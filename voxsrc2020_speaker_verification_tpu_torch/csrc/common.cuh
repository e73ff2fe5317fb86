// Shared helpers of the port's kernels: dtype conversion at the rounding
// points of the compute dtype, and the error string of a returned code.
//
// Every kernel source exposes plain C functions (loaded with ctypes) that
// launch on the caller's stream and return cudaGetLastError() as an int.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vsv {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value to T and back: where the JAX model casts an
// intermediate to its compute dtype, the kernels round at the same point.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Four consecutive elements in one vector access (16 B fp32, 8 B bf16).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<unsigned int*>(&lo);
  q.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

}  // namespace vsv

extern "C" const char* vsv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
