// K6: sub-center cos-margin head (sc_cm_linear) with softmax cross-entropy,
// forward and backward.
//
// Replaces: voxsrc2020_speaker_verification_tpu/losses/projections.py:
// MarginProjection for kind "sc_cm_linear" (lines 96-140, from the max over
// centers on) and the cross-entropy and accuracy of training/trainer.py:
// 152-154, with their JAX autodiff, which XLA compiled on the TPU.
//
// Input: cos_all (K, B, C) fp32, the products of the l2-normalized
// embeddings and the l2-normalized sub-center kernel (a torch matmul), and
// int64 labels (B,). Per row b, with y = labels[b]:
//
//   v[c]     = clip(max_k cos_all[k, b, c], -1, 1)
//   logit[c] = scale * (c == y ? v cos m - sqrt(max(1 - v^2, 0)) sin m - m1 : v)
//   loss[b]  = logsumexp(logit) - logit[y],  correct[b] = (argmax logit == y)
//
// (first-index argmax, as jnp.argmax.) Class-sharded (partial) mode, for a
// head whose classes are split over the ranks of a model group: cos_all
// holds classes [class_offset, class_offset + C) of the row, the label is
// global (its column is y - class_offset, or none here), and the forward
// writes for each row the shard's running max of the logits, the sum of
// exp(logit - max), the target logit (0 where the label lies in another
// shard) and the first-index argmax (global index) instead of the loss:
// the caller all-reduces these over the model group into the row's
// log-sum-exp, loss and argmax (losses/projections.py), and the backward
// takes that global log-sum-exp. The backward recomputes the row and
// writes dcos_all: (softmax - onehot) * scale * dloss, times
// cos m + sin m * v / sin(theta) at the target, zero where the clip is
// active and, by rule, at the target where |v| = 1 (class_grad), routed to
// the maximal center(s), ties split evenly (the gradient of jnp.max).
//
// Bound on the card: bytes. (K, B, C) fp32 is read once forward and read and
// written once backward, at ~10 flops and one exp per class.
//
// Design: one CTA of 16 warps a row b. Thread 0 stages the row's K center
// rows (K x C fp32, 48 KB at the training shape) into a shared-memory slab
// with one bulk asynchronous copy per center (the Tensor Memory
// Accelerator's 1-D form) completing on one mbarrier, so each row leaves
// HBM once per direction and a whole row's bytes are in flight at once
// (two CTAs an SM at the training shape: ~96 KB in flight per SM). A center
// row starts 16-byte aligned only when (k * B + b) * C is a multiple of 4,
// so each copy starts at the 16-byte boundary at or below the row and ends
// at the one at or above its end (both inside the 16-byte granules that
// hold the row's first and last bytes, so inside mapped memory); the
// kernels index the slab past that shift. Every pass then reads the slab:
//   forward: pass 1 takes the max over centers, the logit (stored over the
//     slab) and the first-index argmax; pass 2 the sum of exp(logit - max),
//     with no per-element rescale branch;
//   backward: one pass turns each center's value into its gradient in place
//     (the max, tie count and routing all from the slab), then the slab is
//     written out with 16-byte stores wherever the output row's alignment
//     allows (4-byte stores at its ragged ends).
// Reductions: a thread visits its classes in increasing order, warps reduce
// by shuffles, and warp 0 reduces the warps' values in warp order, so
// reruns agree bit for bit. A row whose slab does not fit (more than 8
// centers, or over 200 KB) takes the streaming kernels instead: the same
// passes read from global memory. The entry points pick the path by shape
// (slab_bytes), never on failure; margin_ce_plan reports the choice.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCenters = 8;

struct Margin {
  float scale, cos_m, sin_m, m1;
};

__device__ __forceinline__ float target_logit(float v, const Margin& mg) {
  const float st = sqrtf(fmaxf(1.f - v * v, 0.f));
  return mg.scale * (v * mg.cos_m - st * mg.sin_m - mg.m1);
}

__device__ __forceinline__ float clip1(float v) {
  return fminf(fmaxf(v, -1.f), 1.f);
}

// The gradient of the row's loss with respect to the center maximum v of a
// class (before the tie split): (softmax - onehot) * scale * dloss, times
// cos m + sin m * v / sin(theta) at the target. Zero where the clip holds
// v, and, by rule, at the target where |v| = 1 (sin theta = 0: the
// derivative of the sqrt is unbounded there); the plain version applies the
// same rule (losses/projections.py:target_phi).
__device__ __forceinline__ float class_grad(float v, bool target, float lse, float dloss,
                                            const Margin& mg) {
  const float vc = clip1(v);
  bool zero = v < -1.f || v > 1.f;
  float dv;
  if (target) {
    const float st = sqrtf(fmaxf(1.f - vc * vc, 0.f));
    zero = zero || st == 0.f;
    const float p = expf(target_logit(vc, mg) - lse);
    dv = (p - 1.f) * dloss * mg.scale * (mg.cos_m + mg.sin_m * vc / st);
  } else {
    dv = expf(mg.scale * vc - lse) * dloss * mg.scale;
  }
  return zero ? 0.f : dv;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// floats from the 16-byte boundary at or below p to p
__device__ __forceinline__ int shift_of(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// Floats of one center's slab: room for a shift of up to 3 floats, a
// multiple of 4 so every slab starts 16-byte aligned.
__host__ __device__ __forceinline__ int slab_stride(int classes) {
  return (classes + 3 + 3) & ~3;
}

// Stage row b of every center into the slab; on return base[k] is the slab
// index of cos_all[k, b, 0]. Every thread waits for the copies.
__device__ __forceinline__ void stage_row(const float* __restrict__ cos_all, int centers,
                                          int batch, int classes, float* slab, int* base,
                                          uint64_t* bar) {
  const int b = blockIdx.x, stride = slab_stride(classes);
  if (threadIdx.x < centers) {
    const float* row = cos_all + (static_cast<long long>(threadIdx.x) * batch + b) * classes;
    base[threadIdx.x] = threadIdx.x * stride + shift_of(row);
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    uint32_t total = 0;
    for (int k = 0; k < centers; ++k) {
      const float* row = cos_all + (static_cast<long long>(k) * batch + b) * classes;
      total += static_cast<uint32_t>((shift_of(row) + classes + 3) & ~3) * 4u;
    }
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(total)
                 : "memory");
    for (int k = 0; k < centers; ++k) {
      const float* row = cos_all + (static_cast<long long>(k) * batch + b) * classes;
      const int sh = shift_of(row);
      const uint32_t bytes = static_cast<uint32_t>((sh + classes + 3) & ~3) * 4u;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_u32(slab + k * stride)),
          "l"(row - sh), "r"(bytes), "r"(smem_u32(bar))
          : "memory");
    }
  }
  __syncthreads();  // the mbarrier is initialized, base[] written
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(0u)
        : "memory");
}

// Max over centers of class c, read from the slab.
__device__ __forceinline__ float center_max(const float* slab, const int* base, int centers,
                                            int c) {
  float v = slab[base[0] + c];
  for (int k = 1; k < centers; ++k) v = fmaxf(v, slab[base[k] + c]);
  return v;
}

// Block-wide (value, index) max, the smallest index among equal values; the
// result is returned to every thread. red_* hold kWarps entries.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red_v[lane] : -INFINITY;
    i = lane < kWarps ? red_i[lane] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) {
      red_v[0] = v;
      red_i[0] = i;
    }
  }
  __syncthreads();
  v = red_v[0];
  i = red_i[0];
}

// Block-wide sum in a fixed order (shuffle tree, then the warps' sums in
// warp order by the same tree); returned to thread 0 only.
__device__ __forceinline__ float block_sum(float s, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __syncthreads();  // red may still be read by the caller's last use
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  return s;
}

// Row outputs of the forward: loss, correct and lse (whole-class), or in
// partial mode the shard's max, sum of exp(logit - max), target logit and
// global argmax, each (batch,) at out[k * batch + b].
template <bool kPartial>
__device__ __forceinline__ void write_row(int b, int batch, int y, int classes, int offset,
                                          float best, int best_c, float sumexp, float target,
                                          float* __restrict__ out) {
  if constexpr (kPartial) {
    out[b] = best;
    out[batch + b] = sumexp;
    out[2 * batch + b] = (y >= 0 && y < classes) ? target : 0.f;
    out[3 * batch + b] = static_cast<float>(best_c + offset);
  } else {
    const float lse = best + logf(sumexp);
    out[b] = lse - target;
    out[batch + b] = best_c == y ? 1.f : 0.f;
    out[2 * batch + b] = lse;
  }
}

template <bool kPartial>
__global__ void __launch_bounds__(kThreads) margin_ce_fwd_kernel(
    const float* __restrict__ cos_all, const long long* __restrict__ labels, int centers,
    int batch, int classes, int offset, Margin mg, float* __restrict__ out) {
  extern __shared__ __align__(16) float slab[];
  __shared__ uint64_t bar;
  __shared__ int base[kMaxCenters];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  stage_row(cos_all, centers, batch, classes, slab, base, &bar);

  const int b = blockIdx.x;
  const int y = static_cast<int>(labels[b] - offset);
  // pass 1: logits (over center 0's slab), their max and first argmax
  float best = -INFINITY;
  int best_c = 0x7fffffff;
  for (int c = threadIdx.x; c < classes; c += kThreads) {
    const float v = clip1(center_max(slab, base, centers, c));
    const float l = c == y ? target_logit(v, mg) : mg.scale * v;
    slab[base[0] + c] = l;
    if (l > best) {
      best = l;
      best_c = c;
    }
  }
  block_argmax(best, best_c, red_v, red_i);  // its barriers publish the logits
  // pass 2: sum of exp(logit - max), no rescale
  float s = 0.f;
  for (int c = threadIdx.x; c < classes; c += kThreads) s += expf(slab[base[0] + c] - best);
  s = block_sum(s, red_v);
  if (threadIdx.x == 0)
    write_row<kPartial>(b, batch, y, classes, offset, best, best_c, s,
                        (y >= 0 && y < classes) ? slab[base[0] + y] : 0.f, out);
}

__global__ void __launch_bounds__(kThreads) margin_ce_bwd_kernel(
    const float* __restrict__ cos_all, const long long* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ dloss, int centers, int batch,
    int classes, int offset, Margin mg, float* __restrict__ dcos_all) {
  extern __shared__ __align__(16) float slab[];
  __shared__ uint64_t bar;
  __shared__ int base[kMaxCenters];
  stage_row(cos_all, centers, batch, classes, slab, base, &bar);

  const int b = blockIdx.x;
  const int y = static_cast<int>(labels[b] - offset);
  const float l0 = lse[b], g0 = dloss[b];
  // each center's value becomes its gradient, in place
  for (int c = threadIdx.x; c < classes; c += kThreads) {
    const float v = center_max(slab, base, centers, c);
    int ties = 0;
    for (int k = 0; k < centers; ++k) ties += slab[base[k] + c] == v;
    const float dv = class_grad(v, c == y, l0, g0, mg) / static_cast<float>(ties);
    for (int k = 0; k < centers; ++k) {
      float* e = slab + base[k] + c;
      *e = *e == v ? dv : 0.f;
    }
  }
  __syncthreads();
  // write out: 16-byte stores from the output row's first 16-byte boundary
  for (int k = 0; k < centers; ++k) {
    float* out = dcos_all + (static_cast<long long>(k) * batch + b) * classes;
    const float* src = slab + base[k];
    const int head = min((4 - shift_of(out)) & 3, classes);
    const int groups = (classes - head) >> 2;
    const bool aligned = ((base[k] + head) & 3) == 0;
    for (int c = threadIdx.x; c < head; c += kThreads) out[c] = src[c];
    for (int g = threadIdx.x; g < groups; g += kThreads) {
      const int c = head + 4 * g;
      const float4 q = aligned ? *reinterpret_cast<const float4*>(src + c)
                               : make_float4(src[c], src[c + 1], src[c + 2], src[c + 3]);
      *reinterpret_cast<float4*>(out + c) = q;
    }
    for (int c = head + 4 * groups + threadIdx.x; c < classes; c += kThreads) out[c] = src[c];
  }
}

// The streaming path, for rows whose slab does not fit shared memory (more
// than kMaxCenters centers, or a slab over 200 KB: e.g. K = 2 at C > 25,597).
// The same CTA a row, the same per-thread class order and the same
// reductions, but every pass reads the row from global memory (L2 holds it
// between passes at these sizes): the forward reads it twice (max and
// argmax, then the sum of exp), the backward once, and writes dcos_all
// directly. So it returns what the slab path would, bit for bit.
template <bool kPartial>
__global__ void __launch_bounds__(kThreads) margin_ce_stream_fwd_kernel(
    const float* __restrict__ cos_all, const long long* __restrict__ labels, int centers,
    int batch, int classes, int offset, Margin mg, float* __restrict__ out) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int b = blockIdx.x;
  const int y = static_cast<int>(labels[b] - offset);
  const long long kstride = static_cast<long long>(batch) * classes;
  const float* row = cos_all + static_cast<long long>(b) * classes;
  auto logit = [&](int c) {
    float v = row[c];
    for (int k = 1; k < centers; ++k) v = fmaxf(v, row[k * kstride + c]);
    v = clip1(v);
    return c == y ? target_logit(v, mg) : mg.scale * v;
  };
  float best = -INFINITY;
  int best_c = 0x7fffffff;
  for (int c = threadIdx.x; c < classes; c += kThreads) {
    const float l = logit(c);
    if (l > best) {
      best = l;
      best_c = c;
    }
  }
  block_argmax(best, best_c, red_v, red_i);
  float s = 0.f;
  for (int c = threadIdx.x; c < classes; c += kThreads) s += expf(logit(c) - best);
  s = block_sum(s, red_v);
  if (threadIdx.x == 0)
    write_row<kPartial>(b, batch, y, classes, offset, best, best_c, s,
                        (y >= 0 && y < classes) ? logit(y) : 0.f, out);
}

__global__ void __launch_bounds__(kThreads) margin_ce_stream_bwd_kernel(
    const float* __restrict__ cos_all, const long long* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ dloss, int centers, int batch,
    int classes, int offset, Margin mg, float* __restrict__ dcos_all) {
  const int b = blockIdx.x;
  const int y = static_cast<int>(labels[b] - offset);
  const long long kstride = static_cast<long long>(batch) * classes;
  const long long roff = static_cast<long long>(b) * classes;
  const float l0 = lse[b], g0 = dloss[b];
  for (int c = threadIdx.x; c < classes; c += kThreads) {
    float v = cos_all[roff + c];
    for (int k = 1; k < centers; ++k) v = fmaxf(v, cos_all[k * kstride + roff + c]);
    int ties = 0;
    for (int k = 0; k < centers; ++k) ties += cos_all[k * kstride + roff + c] == v;
    const float dv = class_grad(v, c == y, l0, g0, mg) / static_cast<float>(ties);
    for (int k = 0; k < centers; ++k) {
      const long long e = k * kstride + roff + c;
      dcos_all[e] = cos_all[e] == v ? dv : 0.f;
    }
  }
}

// Dynamic shared memory of a row's slab, or 0 if it does not fit a CTA.
size_t slab_bytes(int centers, int classes) {
  if (centers < 1 || centers > kMaxCenters || classes < 1) return 0;
  const size_t bytes = sizeof(float) * static_cast<size_t>(centers) * slab_stride(classes);
  return bytes <= 200 * 1024 ? bytes : 0;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  return static_cast<int>(err);
}

}  // namespace

// The path margin_ce_fwd / margin_ce_bwd take for (centers, classes):
// *slab_bytes_out is a row's shared-memory slab, or 0 for the streaming
// kernels. For reports and launch counts; a launch needs none of it.
extern "C" int margin_ce_plan(int centers, int classes, int* slab_bytes_out) {
  if (centers < 1 || classes < 1) return vsv::kShapeUnsupported;
  *slab_bytes_out = static_cast<int>(slab_bytes(centers, classes));
  return 0;
}

// cos_all: (centers, batch, classes) fp32; labels: (batch,) int64. Writes
// loss, correct (0/1) and lse, each (batch,) fp32. One CTA a row; the row
// is staged in shared memory when its slab fits (at most 8 centers and a
// 200 KB slab), else every pass streams it from global memory.
namespace {

template <bool kPartial>
int forward(const float* cos_all, const long long* labels, int centers, int batch,
            int classes, int offset, const Margin& mg, float* out, void* stream) {
  if (centers < 1 || classes < 1) return vsv::kShapeUnsupported;
  const size_t smem = slab_bytes(centers, classes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem == 0) {
    margin_ce_stream_fwd_kernel<kPartial><<<batch, kThreads, 0, st>>>(
        cos_all, labels, centers, batch, classes, offset, mg, out);
  } else {
    if (const int err = prepare(margin_ce_fwd_kernel<kPartial>, smem)) return err;
    margin_ce_fwd_kernel<kPartial><<<batch, kThreads, smem, st>>>(
        cos_all, labels, centers, batch, classes, offset, mg, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int backward(const float* cos_all, const long long* labels, const float* lse,
             const float* dloss, int centers, int batch, int classes, int offset,
             const Margin& mg, float* dcos_all, void* stream) {
  if (centers < 1 || classes < 1) return vsv::kShapeUnsupported;
  const size_t smem = slab_bytes(centers, classes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem == 0) {
    margin_ce_stream_bwd_kernel<<<batch, kThreads, 0, st>>>(
        cos_all, labels, lse, dloss, centers, batch, classes, offset, mg, dcos_all);
  } else {
    if (const int err = prepare(margin_ce_bwd_kernel, smem)) return err;
    margin_ce_bwd_kernel<<<batch, kThreads, smem, st>>>(
        cos_all, labels, lse, dloss, centers, batch, classes, offset, mg, dcos_all);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: (3, batch) fp32, rows loss, correct (0/1) and lse.
extern "C" int margin_ce_fwd(const float* cos_all, const long long* labels,
                             int centers, int batch, int classes, float scale,
                             float cos_m, float sin_m, float m1, float* out, void* stream) {
  return forward<false>(cos_all, labels, centers, batch, classes, 0,
                        Margin{scale, cos_m, sin_m, m1}, out, stream);
}

// Class-sharded mode: cos_all holds classes [class_offset, class_offset +
// classes) of a head; labels are global. out: (4, batch) fp32, rows the
// shard's max logit, sum of exp(logit - max), target logit (0 where the
// label is another shard's) and first-index argmax (a global class index).
extern "C" int margin_ce_partial_fwd(const float* cos_all, const long long* labels,
                                     int centers, int batch, int classes, int class_offset,
                                     float scale, float cos_m, float sin_m, float m1,
                                     float* out, void* stream) {
  return forward<true>(cos_all, labels, centers, batch, classes, class_offset,
                       Margin{scale, cos_m, sin_m, m1}, out, stream);
}

// dloss: (batch,) fp32, the gradient of the per-row loss. Writes every
// element of dcos_all (centers, batch, classes), on the forward's path.
extern "C" int margin_ce_bwd(const float* cos_all, const long long* labels,
                             const float* lse, const float* dloss, int centers,
                             int batch, int classes, float scale, float cos_m,
                             float sin_m, float m1, float* dcos_all,
                             void* stream) {
  return backward(cos_all, labels, lse, dloss, centers, batch, classes, 0,
                  Margin{scale, cos_m, sin_m, m1}, dcos_all, stream);
}

// Class-sharded mode: lse is the row's global log-sum-exp (all-reduced from
// margin_ce_partial_fwd's outputs); writes this shard's dcos_all.
extern "C" int margin_ce_partial_bwd(const float* cos_all, const long long* labels,
                                     const float* lse, const float* dloss, int centers,
                                     int batch, int classes, int class_offset, float scale,
                                     float cos_m, float sin_m, float m1, float* dcos_all,
                                     void* stream) {
  return backward(cos_all, labels, lse, dloss, centers, batch, classes, class_offset,
                  Margin{scale, cos_m, sin_m, m1}, dcos_all, stream);
}
