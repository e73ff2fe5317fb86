// K4: masked statistics pooling over time, mean || sqrt(var + eps).
//
// Replaces: voxsrc2020_speaker_verification_tpu/ops/nn.py:stats_pool
// (lines 487-497) with _masked_moments (440-454), which XLA reduced on the TPU.
//
// Input channels-last (B, T, F, C); mask (B, T) of 0/1 (or weights) or null.
// Output (B, F, 2C) (the pooled (B, 2C, 1, F) tensor in channels-last memory,
// i.e. the JAX package's NHWC (B, 1, W, 2C)), cast to the input dtype.
// Moments are fp32 and two-pass, as _masked_moments computes them, with the
// denominator max(sum(mask), 1).
//
// Bound on the card: bytes (x read once, the pooled rows written once; three
// flops per element). Each (b, f, 256-bf16 / 128-fp32 channel tile) has its
// T rows staged into shared memory by 16-byte cp.async, and both passes of
// the moments read the slab, so x leaves HBM once where T <= kRingRows
// (stats_pool.cuh). Persistent CTAs keep two tiles' copies in flight while
// they reduce a third. Tile, ring, slab budget and the chunked path for
// longer columns are decided in stats_pool.cuh alone.
#include "stats_pool.cuh"

namespace {

using vsv::pool::Lane;

template <typename T>
__global__ void __launch_bounds__(vsv::pool::kThreads)
    stats_pool_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                      T* __restrict__ out, float eps, int batch, int tlen, int flen,
                      int channels) {
  constexpr int V = Lane<T>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  vsv::pool::for_each_tile(
      x, mask, batch, tlen, flen, channels, smem,
      [&](const vsv::pool::Column& c, const vsv::pool::Smem& s) {
        float mean[V], var[V], denom;
        vsv::pool::moments(x, c, tlen, s, mean, var, denom);
        if (threadIdx.x >= 32 || c.valid == 0) return;  // warp 0 writes the tile
        float sd[V];
#pragma unroll
        for (int j = 0; j < V; ++j) sd[j] = sqrtf(var[j] + eps);
        T* o = out + c.bf * 2 * channels + c.c0;
        const bool vec = c.full && vsv::pool::aligned16(out);
        vsv::pool::store_lane(o, mean, c.valid, vec);
        vsv::pool::store_lane(o + channels, sd, c.valid, vec);
      });
}

template <typename T>
int launch(const void* x, const float* mask, void* out, int batch, int tlen,
           int flen, int channels, float eps, cudaStream_t stream) {
  return vsv::pool::launch_persistent<T>(stats_pool_kernel<T>, batch, tlen, flen, channels,
                                         stream, static_cast<const T*>(x), mask,
                                         static_cast<T*>(out), eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null. One launch.
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
