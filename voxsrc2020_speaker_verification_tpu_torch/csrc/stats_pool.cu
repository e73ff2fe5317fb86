// K4: masked statistics pooling over time, mean || sqrt(var + eps).
//
// Replaces: voxsrc2020_speaker_verification_tpu/ops/nn.py:stats_pool
// (lines 487-497) with _masked_moments (440-454), which XLA reduced on the TPU.
//
// Input channels-last (B, T, F, C); mask (B, T) of 0/1 or null. Output
// (B, F, 2C) (the pooled (B, 2C, 1, F) tensor in channels-last memory, i.e.
// the JAX package's NHWC (B, 1, W, 2C)), cast to the input dtype. Moments are
// fp32 and two-pass, as _masked_moments computes them, with the denominator
// max(sum(mask), 1).
//
// Bound on the card: bytes. Three flops per element read. One thread owns one
// (b, f, c) and walks T; neighbouring threads own neighbouring channels, so
// every step of the walk is one coalesced row. The second pass re-reads the
// thread's column, mostly from L2.
#include "common.cuh"

namespace {

template <typename T>
__global__ void stats_pool_kernel(const T* __restrict__ x,
                                  const float* __restrict__ mask,
                                  T* __restrict__ out, int batch, int tlen,
                                  int flen, int channels, float eps) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = static_cast<long long>(batch) * flen * channels;
  if (idx >= n) return;
  const int c = static_cast<int>(idx % channels);
  const long long bf = idx / channels;  // b * F + f
  const int f = static_cast<int>(bf % flen);
  const long long b = bf / flen;
  const T* xp = x + (b * tlen * flen + f) * channels + c;
  const long long step = static_cast<long long>(flen) * channels;
  const float* mp = mask != nullptr ? mask + b * tlen : nullptr;

  float msum = 0.f, sum = 0.f;
  for (int t = 0; t < tlen; ++t) {
    const float m = mp != nullptr ? mp[t] : 1.f;
    msum += m;
    sum += vsv::to_f(xp[t * step]) * m;
  }
  const float denom = fmaxf(msum, 1.f);
  const float mean = sum / denom;
  float sq = 0.f;
  for (int t = 0; t < tlen; ++t) {
    const float m = mp != nullptr ? mp[t] : 1.f;
    const float d = vsv::to_f(xp[t * step]) - mean;
    sq += d * d * m;
  }
  const float var = sq / denom;
  T* o = out + bf * 2 * channels;
  o[c] = vsv::from_f<T>(mean);
  o[channels + c] = vsv::from_f<T>(sqrtf(var + eps));
}

template <typename T>
int launch(const void* x, const float* mask, void* out, int batch, int tlen,
           int flen, int channels, float eps, cudaStream_t stream) {
  constexpr int threads = 256;
  const long long n = static_cast<long long>(batch) * flen * channels;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  stats_pool_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), mask, static_cast<T*>(out), batch, tlen, flen,
      channels, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null.
extern "C" int stats_pool(int dtype, const void* x, const float* mask,
                          void* out, int batch, int tlen, int flen,
                          int channels, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, out, batch, tlen, flen, channels, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mask, out, batch, tlen, flen, channels, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
