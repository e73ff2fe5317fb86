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
// dtype-rounded pooled output), by the device function K4 uses
// (stats_pool.cuh: moments), so they are K4's bit for bit. Input and gradient
// are channels-last (B, T, F, C); dout is (B, F, 2C), the channels-last memory
// of the pooled (B, 2C, 1, F) tensor's gradient; dx has x's dtype.
//
// Bound on the card: bytes (x read once, dx written once, dout's 2C values a
// (b, f) read once). Each (b, f, channel tile) has its T rows staged into
// shared memory by 16-byte cp.async; the two passes of the moments and the
// gradient pass all read the slab, and dx leaves in 16-byte stores, so x and
// dx each cross HBM once where T <= kRingRows. Persistent CTAs keep two
// tiles' copies in flight while they work on a third (stats_pool.cuh).
#include "stats_pool.cuh"

namespace {

using vsv::pool::Lane;

template <typename T>
__global__ void __launch_bounds__(vsv::pool::kThreads)
    stats_pool_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                          const T* __restrict__ dout, T* __restrict__ dx, float eps, int batch,
                          int tlen, int flen, int channels) {
  constexpr int V = Lane<T>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  vsv::pool::for_each_tile(
      x, mask, batch, tlen, flen, channels, smem,
      [&](const vsv::pool::Column& c, const vsv::pool::Smem& s) {
        float gm[V], gs[V];  // issued first: they land while the moments run
        const T* g = dout + c.bf * 2 * channels + c.c0;
        const bool vec_g = c.full && vsv::pool::aligned16(dout);
        vsv::pool::load_lane(g, gm, c.valid, vec_g);
        vsv::pool::load_lane(g + channels, gs, c.valid, vec_g);
        float mean[V], var[V], denom;
        vsv::pool::moments(x, c, tlen, s, mean, var, denom);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          gm[j] = gm[j] / denom;
          gs[j] = gs[j] / (denom * sqrtf(var[j] + eps));
        }
        // the gradient pass, from the slab on the ring
        T* d = dx + c.offset;
        const bool vec_d = c.full && vsv::pool::aligned16(dx);
        vsv::pool::sweep(x, c, tlen, s, [&](int t, float m, const float* v) {
          float o[V];
#pragma unroll
          for (int j = 0; j < V; ++j) o[j] = m * (gm[j] + gs[j] * (v[j] - mean[j]));
          vsv::pool::store_lane(d + t * c.step, o, c.valid, vec_d);
        });
      });
}

template <typename T>
int launch(const void* x, const float* mask, const void* dout, void* dx,
           int batch, int tlen, int flen, int channels, float eps,
           cudaStream_t stream) {
  return vsv::pool::launch_persistent<T>(stats_pool_bwd_kernel<T>, batch, tlen, flen, channels,
                                         stream, static_cast<const T*>(x), mask,
                                         static_cast<const T*>(dout), static_cast<T*>(dx), eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null. One launch.
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
