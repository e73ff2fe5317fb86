// K4b: backward of the masked statistics pooling (K4).
//
// Replaces: the JAX autodiff of voxsrc2020_speaker_verification_tpu/ops/
// nn.py:stats_pool (lines 487-497, with _masked_moments 440-454), which XLA
// compiled on the TPU.
//
// With D = max(sum(mask), 1), mean and var the fp32 two-pass moments of K4 and
// std = sqrt(var + eps):
//
//   dx[t] = mask[t] * (dmean / D + dstd * (x[t] - mean) / (D * std))
//
// The moments are recomputed here in fp32 from x (not taken from the
// dtype-rounded pooled output). Input and gradient are channels-last
// (B, T, F, C); dout is (B, F, 2C), the channels-last memory of the pooled
// (B, 2C, 1, F) tensor's gradient; dx has x's dtype.
//
// Bound on the card: bytes (read x once, write dx once). One thread owns one
// (b, f, c) and walks T three times (sum, squared deviations, gradient);
// neighbouring threads own neighbouring channels, so each step of a walk is
// one coalesced row, and the re-reads come mostly from L2.
#include "common.cuh"

namespace {

template <typename T>
__global__ void stats_pool_bwd_kernel(const T* __restrict__ x,
                                      const float* __restrict__ mask,
                                      const T* __restrict__ dout,
                                      T* __restrict__ dx, int batch, int tlen,
                                      int flen, int channels, float eps) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(batch) * flen * channels;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % channels);
  const long long bf = idx / channels;  // b * F + f
  const int f = static_cast<int>(bf % flen);
  const long long b = bf / flen;
  const long long off = (b * tlen * flen + f) * channels + c;
  const long long step = static_cast<long long>(flen) * channels;
  const float* mp = mask != nullptr ? mask + b * tlen : nullptr;

  float msum = 0.f, sum = 0.f;
  for (int t = 0; t < tlen; ++t) {
    const float m = mp != nullptr ? mp[t] : 1.f;
    msum += m;
    sum += vsv::to_f(x[off + t * step]) * m;
  }
  const float denom = fmaxf(msum, 1.f);
  const float mean = sum / denom;
  float sq = 0.f;
  for (int t = 0; t < tlen; ++t) {
    const float m = mp != nullptr ? mp[t] : 1.f;
    const float d = vsv::to_f(x[off + t * step]) - mean;
    sq += d * d * m;
  }
  const float stdev = sqrtf(sq / denom + eps);
  const T* g = dout + bf * 2 * channels;
  const float gm = vsv::to_f(g[c]) / denom;
  const float gs = vsv::to_f(g[channels + c]) / (denom * stdev);
  for (int t = 0; t < tlen; ++t) {
    const float m = mp != nullptr ? mp[t] : 1.f;
    const float v = m * (gm + gs * (vsv::to_f(x[off + t * step]) - mean));
    dx[off + t * step] = vsv::from_f<T>(v);
  }
}

template <typename T>
int launch(const void* x, const float* mask, const void* dout, void* dx,
           int batch, int tlen, int flen, int channels, float eps,
           cudaStream_t stream) {
  constexpr int threads = 256;
  const long long n = static_cast<long long>(batch) * flen * channels;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  stats_pool_bwd_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), mask, static_cast<const T*>(dout),
      static_cast<T*>(dx), batch, tlen, flen, channels, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null.
extern "C" int stats_pool_bwd(int dtype, const void* x, const float* mask,
                              const void* dout, void* dx, int batch, int tlen,
                              int flen, int channels, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, mask, dout, dx, batch, tlen, flen, channels, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mask, dout, dx, batch, tlen, flen, channels,
                                 eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
