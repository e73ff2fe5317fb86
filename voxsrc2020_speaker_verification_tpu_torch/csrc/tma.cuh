// Tensor Memory Accelerator copies completing on shared-memory mbarriers,
// as K4 / K4b's column design (stats_pool.cuh) stages its tiles: the
// mbarrier operations, the 4-D tensor copy (a box of a tensor map into
// shared memory, the box's parts past the tensor's edge filled with zeros;
// its first element must lie on a 16-byte boundary), and the host's
// tensor-map encoder, which the CUDA runtime hands out by
// cudaGetDriverEntryPoint (no link to the driver library).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace vsv {
namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier of arrival count 1: the thread that arms it for each phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
// After a thread's mbar_init calls: visible to the copy engine.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive, expecting `bytes` of copies to complete this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// This thread's earlier shared-memory accesses (and, after a barrier, the
// other threads') come before its next copies' writes.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// dst (128-byte aligned), its bytes completing on bar.
__device__ __forceinline__ void copy_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                        int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled, or null where the runtime finds none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major tensor of `rank` dims (dims and element strides innermost
// first; strides[0] is 1 and not passed) as a tiled map of `box` boxes,
// zeros past its edges. False where the encoder refuses it: base not
// 16-byte aligned, a stride in bytes no multiple of 16, or no encoder.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, int rank,
                   const void* base, const unsigned long long* dims,
                   const unsigned long long* strides, const unsigned* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0 || rank > 5) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    unit[i] = 1;
    if (i > 0) {
      s[i - 1] = strides[i - 1] * static_cast<cuuint64_t>(elem_bytes);
      if (s[i - 1] % 16 != 0) return false;
    }
  }
  return fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), d, s, b, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
}  // namespace vsv
