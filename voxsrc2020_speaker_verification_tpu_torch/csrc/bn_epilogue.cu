// K3: eval-mode batch norm with its relu / residual / time-mask epilogue.
//
// Replaces: voxsrc2020_speaker_verification_tpu/ops/nn.py:BatchNorm, eval
// branch (lines 206-215), with the relu, residual add and mask_time around it
// (models/res2net.py:137-141, 148-151, 207-212, and the stride-2 groups at
// 61-64), which XLA fused on the TPU.
//
//   y = (x - mean) * rsqrt(var + eps)                    rounded to the dtype
//   y = y + [(s - mean_s) * rsqrt(var_s + eps) | s]      each term rounded
//   y = relu(y) * mask[b, t]                             (each step optional)
//
// One elementwise pass over a channels-last (B, T, F, C) tensor: the stem, bn1,
// bn3 with its shortcut (the projection BN fused in) and the stride-2 groups.
//
// Bound on the card: bytes. A few flops per element against 4-12 B moved,
// far below Hopper's ridge. The kernel reads each input once and writes the
// output once with 16 B (fp32) or 8 B (bf16) vector accesses; the per-channel
// scale and shift sit in shared memory.
//
// Any channel count. Where C % 4 != 0 (dpn68's 10-channel stem) the first
// design took single elements (V = 1): 2-byte accesses and two 64-bit
// divisions an element (its channel, its mask row), 30% of the bound at the
// stem. The folded path takes its place where it can: k = vec / gcd(C, vec)
// consecutive positions (rows of C channels, vec the elements of 16 bytes)
// fill whole 16-byte vectors (4 rows of 10 bf16 channels are 5 vectors),
// and in the channels-last layout they are contiguous. A thread keeps one
// lane of such super-rows, so its elements' channels ((lane * vec + j) %
// C) and their statistics are read from the shared table once, into
// registers; with F % k == 0 the k positions of a super-row share their
// (b, t), so the mask index is computed once a super-row; index math is
// 32-bit where the tensor has fewer than 2^31 elements. The shapes the fold
// cannot take (F % k != 0, unaligned tensors) keep V = 1; the C entry point
// takes the path the wrapper names (ops/nn.py:bn_act_plan). An element's
// arithmetic is written alike on every path: the 4-channel path's outputs
// are the vector-only kernel's bit for bit, and the folded path's equal the
// single-element path's, except in float32 with a raw shortcut, where the
// compiler fuses the shortcut's add into the product on one path and not
// the other (one rounding; dpn68's 10-channel calls take no shortcut).
#include "common.cuh"

namespace {

// The per-channel statistics in shared memory: mean and 1 / sqrt(var + eps)
// [and the shortcut's], C floats each.
__device__ __forceinline__ void stage_stats(float* stats, const float* mean, const float* var,
                                            const float* sc_mean, const float* sc_var,
                                            int channels, int sc_mode, float eps) {
  float* mu = stats;
  float* inv = mu + channels;
  float* smu = inv + channels;
  float* sinv = smu + channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    mu[c] = mean[c];
    inv[c] = 1.f / sqrtf(var[c] + eps);
    if (sc_mode == 2) {
      smu[c] = sc_mean[c];
      sinv[c] = 1.f / sqrtf(sc_var[c] + eps);
    }
  }
  __syncthreads();
}

template <typename T, int V>
__global__ void bn_act_kernel(const T* __restrict__ x,
                              const float* __restrict__ mean,
                              const float* __restrict__ var,
                              const T* __restrict__ sc,
                              const float* __restrict__ sc_mean,
                              const float* __restrict__ sc_var,
                              const float* __restrict__ mask,
                              T* __restrict__ out, long long nvec, int channels,
                              int flen, int relu, int sc_mode, float eps) {
  extern __shared__ __align__(16) float stats[];
  stage_stats(stats, mean, var, sc_mean, sc_var, channels, sc_mode, eps);
  const float* mu = stats;
  const float* inv = mu + channels;
  const float* smu = inv + channels;
  const float* sinv = smu + channels;

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    const long long e = v * V;
    const int c = static_cast<int>(e % channels);
    // position (b * T + t) * F + f, so position / F indexes the (B, T) mask
    const float m = mask != nullptr ? mask[(e / channels) / flen] : 1.f;
    float xv[V], sv[V], o[V];
    vsv::load_v<V>(x + e, xv);
    if (sc_mode != 0) vsv::load_v<V>(sc + e, sv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y = vsv::round_to<T>((xv[j] - mu[c + j]) * inv[c + j]);
      if (sc_mode == 2)
        y = vsv::round_to<T>(y + vsv::round_to<T>((sv[j] - smu[c + j]) * sinv[c + j]));
      else if (sc_mode == 1)
        y = vsv::round_to<T>(y + sv[j]);
      if (relu) y = fmaxf(y, 0.f);
      if (mask != nullptr) y *= m;
      o[j] = y;
    }
    vsv::store_v<V>(out + e, o);
  }
}

// The folded path: nsr super-rows of nv 16-byte vectors (fold positions of
// C channels each); a block of blockDim = nv * per threads takes `per`
// super-rows at a time, each thread one lane of them; a super-row's mask
// index is its index / rows_per_mask (F / fold). I: the index type, 32-bit
// where the tensor has fewer than 2^31 elements.
template <typename T, typename I>
__global__ void bn_act_fold_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                                   const float* __restrict__ var, const T* __restrict__ sc,
                                   const float* __restrict__ sc_mean,
                                   const float* __restrict__ sc_var,
                                   const float* __restrict__ mask, T* __restrict__ out, I nsr,
                                   int nv, int channels, I rows_per_mask, int relu, int sc_mode,
                                   float eps) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) float stats[];
  stage_stats(stats, mean, var, sc_mean, sc_var, channels, sc_mode, eps);
  const int per = blockDim.x / nv;
  const int lane = threadIdx.x % nv;
  float mu[V], inv[V], smu[V], sinv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = (lane * V + j) % channels;
    mu[j] = stats[c];
    inv[j] = stats[channels + c];
    smu[j] = sc_mode == 2 ? stats[2 * channels + c] : 0.f;
    sinv[j] = sc_mode == 2 ? stats[3 * channels + c] : 0.f;
  }
  const uint4* xq = reinterpret_cast<const uint4*>(x);
  const uint4* sq = reinterpret_cast<const uint4*>(sc);
  uint4* oq = reinterpret_cast<uint4*>(out);
  // one super-row: the first design's element arithmetic, text for text
  // (the compiler contracts the float32 adds alike: bit-equal outputs)
  auto row = [&](I q, uint4 xr, uint4 sr) {
    float m = 1.f;
    if (mask != nullptr) m = mask[q / rows_per_mask];
    float xv[V], sv[V], o[V];
    vsv::unpack16(xr, xv, x);
    if (sc_mode != 0) vsv::unpack16(sr, sv, x);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y = vsv::round_to<T>((xv[j] - mu[j]) * inv[j]);
      if (sc_mode == 2)
        y = vsv::round_to<T>(y + vsv::round_to<T>((sv[j] - smu[j]) * sinv[j]));
      else if (sc_mode == 1)
        y = vsv::round_to<T>(y + sv[j]);
      if (relu) y = fmaxf(y, 0.f);
      if (mask != nullptr) y *= m;
      o[j] = y;
    }
    vsv::store16(reinterpret_cast<T*>(oq + q * nv + lane), o);
  };
  // two super-rows a round, both loaded before either is computed: twice
  // the bytes in flight a thread. Plain loads under branches: a load the
  // compiler may not hoist past its guard (the shortcut, the mask or the
  // second row may not exist)
  const I step = static_cast<I>(gridDim.x) * per;
  for (I q = static_cast<I>(blockIdx.x) * per + threadIdx.x / nv; q < nsr; q += 2 * step) {
    const I q2 = q + step;
    const bool two = q2 < nsr;
    uint4 x0 = xq[q * nv + lane], s0 = {}, x1 = {}, s1 = {};
    if (sc_mode != 0) s0 = sq[q * nv + lane];
    if (two) {
      x1 = xq[q2 * nv + lane];
      if (sc_mode != 0) s1 = sq[q2 * nv + lane];
    }
    row(q, x0, s0);
    if (two) row(q2, x1, s1);
  }
}

size_t stats_smem(int channels, int sc_mode) {
  return sizeof(float) * channels * (sc_mode == 2 ? 4 : 2);
}

unsigned grid_blocks(long long items, int threads, int num_sms) {
  long long blocks = (items + threads - 1) / threads;
  const long long cap = static_cast<long long>(num_sms) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

template <typename T, int V>
int launch(const void* x, const float* mean, const float* var, const void* sc,
           const float* sc_mean, const float* sc_var, const float* mask,
           void* out, long long numel, int channels, int flen, int relu,
           int sc_mode, float eps, int num_sms, cudaStream_t stream) {
  constexpr int threads = 256;
  const long long nvec = numel / V;
  const size_t smem = stats_smem(channels, sc_mode);
  cudaFuncSetAttribute(bn_act_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  bn_act_kernel<T, V><<<grid_blocks(nvec, threads, num_sms), threads, smem, stream>>>(
      static_cast<const T*>(x), mean, var, static_cast<const T*>(sc), sc_mean,
      sc_var, mask, static_cast<T*>(out), nvec, channels, flen, relu, sc_mode,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int launch_fold_as(const void* x, const float* mean, const float* var, const void* sc,
                   const float* sc_mean, const float* sc_var, const float* mask, void* out,
                   long long nsr, int nv, int channels, long long rows_per_mask, int relu,
                   int sc_mode, float eps, int num_sms, cudaStream_t stream) {
  const int per = 256 / nv;
  const int threads = per * nv;
  const size_t smem = stats_smem(channels, sc_mode);
  cudaFuncSetAttribute(bn_act_fold_kernel<T, I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  bn_act_fold_kernel<T, I><<<grid_blocks(nsr, per, num_sms), threads, smem, stream>>>(
      static_cast<const T*>(x), mean, var, static_cast<const T*>(sc), sc_mean, sc_var, mask,
      static_cast<T*>(out), static_cast<I>(nsr), nv, channels, static_cast<I>(rows_per_mask),
      relu, sc_mode, eps);
  return static_cast<int>(cudaGetLastError());
}

// Super-rows of `fold` positions: they must fill whole 16-byte vectors (at
// most 256 a super-row), F must be a multiple of fold (one mask row a
// super-row), and the tensors 16-byte aligned.
template <typename T>
int launch_fold(const void* x, const float* mean, const float* var, const void* sc,
                const float* sc_mean, const float* sc_var, const float* mask, void* out,
                long long numel, int channels, int flen, int fold, int relu, int sc_mode,
                float eps, int num_sms, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long width = static_cast<long long>(channels) * fold;
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15) != 0;
  };
  if (width % V || width / V > 256 || flen % fold || numel % width || misaligned(x) ||
      misaligned(out) || (sc_mode != 0 && misaligned(sc)))
    return vsv::kShapeUnsupported;
  const long long nsr = numel / width;
  const int nv = static_cast<int>(width / V);
  const long long rows_per_mask = flen / fold;
  if (numel < (1LL << 31))
    return launch_fold_as<T, unsigned>(x, mean, var, sc, sc_mean, sc_var, mask, out, nsr, nv,
                                       channels, rows_per_mask, relu, sc_mode, eps, num_sms,
                                       stream);
  return launch_fold_as<T, unsigned long long>(x, mean, var, sc, sc_mean, sc_var, mask, out, nsr,
                                               nv, channels, rows_per_mask, relu, sc_mode, eps,
                                               num_sms, stream);
}

template <typename T>
int launch_any(const void* x, const float* mean, const float* var, const void* sc,
               const float* sc_mean, const float* sc_var, const float* mask, void* out,
               long long numel, int channels, int flen, int fold, int relu, int sc_mode,
               float eps, int num_sms, cudaStream_t stream) {
  if (fold > 0)
    return launch_fold<T>(x, mean, var, sc, sc_mean, sc_var, mask, out, numel, channels, flen,
                          fold, relu, sc_mode, eps, num_sms, stream);
  if (channels % 4 == 0)
    return launch<T, 4>(x, mean, var, sc, sc_mean, sc_var, mask, out, numel, channels, flen,
                        relu, sc_mode, eps, num_sms, stream);
  return launch<T, 1>(x, mean, var, sc, sc_mean, sc_var, mask, out, numel, channels, flen,
                      relu, sc_mode, eps, num_sms, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. sc_mode: 0 none, 1 add the shortcut as it
// is, 2 add the shortcut normalized with (sc_mean, sc_var). mask may be null.
// fold: 0 takes 4-channel vectors where channels % 4 == 0, single elements
// otherwise; fold > 0 the folded path, super-rows of `fold` positions that
// fill 16-byte vectors (kShapeUnsupported where they do not, F % fold != 0
// or a tensor is not 16-byte aligned).
extern "C" int bn_act(int dtype, const void* x, const float* mean,
                      const float* var, const void* sc, const float* sc_mean,
                      const float* sc_var, const float* mask, void* out,
                      long long numel, int channels, int flen, int relu,
                      int sc_mode, float eps, int num_sms, int fold, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_any<float>(x, mean, var, sc, sc_mean, sc_var, mask, out, numel,
                             channels, flen, fold, relu, sc_mode, eps, num_sms, s);
  if (dtype == 1)
    return launch_any<__nv_bfloat16>(x, mean, var, sc, sc_mean, sc_var, mask, out,
                                     numel, channels, flen, fold, relu, sc_mode, eps,
                                     num_sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
