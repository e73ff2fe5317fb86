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
// Any channel count: where C % 4 != 0 (dpn68's 10-channel stem) a thread
// takes single elements instead of 4-channel vectors (V = 1), chosen by
// shape in the C entry point; the arithmetic of an element is the same, so the
// 4-channel path's outputs are those of the vector-only kernel, bit for bit.
#include "common.cuh"

namespace {

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

template <typename T, int V>
int launch(const void* x, const float* mean, const float* var, const void* sc,
           const float* sc_mean, const float* sc_var, const float* mask,
           void* out, long long numel, int channels, int flen, int relu,
           int sc_mode, float eps, int num_sms, cudaStream_t stream) {
  constexpr int threads = 256;
  const long long nvec = numel / V;
  long long blocks = (nvec + threads - 1) / threads;
  const long long cap = static_cast<long long>(num_sms) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = sizeof(float) * channels * (sc_mode == 2 ? 4 : 2);
  cudaFuncSetAttribute(bn_act_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  bn_act_kernel<T, V><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(x), mean, var, static_cast<const T*>(sc), sc_mean,
      sc_var, mask, static_cast<T*>(out), nvec, channels, flen, relu, sc_mode,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const void* x, const float* mean, const float* var, const void* sc,
               const float* sc_mean, const float* sc_var, const float* mask, void* out,
               long long numel, int channels, int flen, int relu, int sc_mode, float eps,
               int num_sms, cudaStream_t stream) {
  if (channels % 4 == 0)
    return launch<T, 4>(x, mean, var, sc, sc_mean, sc_var, mask, out, numel, channels, flen,
                        relu, sc_mode, eps, num_sms, stream);
  return launch<T, 1>(x, mean, var, sc, sc_mean, sc_var, mask, out, numel, channels, flen,
                      relu, sc_mode, eps, num_sms, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. sc_mode: 0 none, 1 add the shortcut as it
// is, 2 add the shortcut normalized with (sc_mean, sc_var). mask may be null.
// Any channel count: 4-channel vectors where channels % 4 == 0, single
// elements otherwise.
extern "C" int bn_act(int dtype, const void* x, const float* mean,
                      const float* var, const void* sc, const float* sc_mean,
                      const float* sc_var, const float* mask, void* out,
                      long long numel, int channels, int flen, int relu,
                      int sc_mode, float eps, int num_sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_any<float>(x, mean, var, sc, sc_mean, sc_var, mask, out, numel,
                             channels, flen, relu, sc_mode, eps, num_sms, s);
  if (dtype == 1)
    return launch_any<__nv_bfloat16>(x, mean, var, sc, sc_mean, sc_var, mask, out,
                                     numel, channels, flen, relu, sc_mode, eps,
                                     num_sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
