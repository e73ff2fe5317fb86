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

// V consecutive elements: a 4-element vector access (V = 4) or one element
// (V = 1, the kernels' path for channel counts that are not multiples of 4).
template <int V, typename T>
__device__ __forceinline__ void load_v(const T* p, float* v) {
  if constexpr (V == 4) load4(p, v);
  else v[0] = to_f(*p);
}
template <int V, typename T>
__device__ __forceinline__ void store_v(T* p, const float* v) {
  if constexpr (V == 4) store4(p, v);
  else *p = from_f<T>(v[0]);
}

// One 16-byte vector: 4 fp32 or 8 bf16 elements (the pointer argument
// only picks the element type).
__device__ __forceinline__ void unpack16(uint4 q, float* v, const float*) {
  v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack16(uint4 q, float* v, const __nv_bfloat16*) {
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  unsigned int w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<unsigned int*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Returned, beside the CUDA codes, where the caller's launch plan gives a
// shared-memory size other than the kernel's own layout needs.
constexpr int kPlanMismatch = 10001;
// Returned where a kernel does not take the shape it was given (its C entry
// point says which shapes it takes).
constexpr int kShapeUnsupported = 10002;

}  // namespace vsv

extern "C" const char* vsv_error_string(int code) {
  if (code == vsv::kPlanMismatch)
    return "the launch plan's shared memory differs from the kernel's layout";
  if (code == vsv::kShapeUnsupported)
    return "the kernel does not take this shape (see its C entry point)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
