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
// shared memory once; the two passes of the moments and the gradient pass
// all read the slab, and dx leaves in 16-byte stores, so x and dx each
// cross HBM once wherever the column fits on chip (the ring and column
// designs of stats_pool.cuh: every W = 1 head, T up to ~3,100). Persistent
// CTAs keep the next tile's copies in flight while they work on this one.
// The plan is K4's (ops/nn.py:stats_pool_plan).
#include "stats_pool.cuh"

namespace {

using vsv::pool::Plan;
using vsv::pool::Tile;

template <typename T, int RB, bool Stream>
__global__ void __launch_bounds__(vsv::pool::kThreads)
    stats_pool_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                          const T* __restrict__ dout, T* __restrict__ dx, float eps, int tma,
                          const __grid_constant__ CUtensorMap map, int slab_rows,
                          int batch, int tlen, int flen, int channels) {
  constexpr int V = Tile<T, RB>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  vsv::pool::for_each_tile<T, RB, Stream>(
      x, mask, batch, tlen, flen, channels, tma != 0, &map, slab_rows, smem,
      [&](const vsv::pool::Column& c, const vsv::pool::Smem& s) {
        float gm[V], gs[V];  // issued first: they land while the moments run
        const T* g = dout + c.bf * 2 * channels + c.c0;
        const bool vec_g = c.full && vsv::pool::aligned16(dout);
        vsv::pool::load_lane(g, gm, c.valid, vec_g);
        vsv::pool::load_lane(g + channels, gs, c.valid, vec_g);
        float mean[V], var[V], denom;
        vsv::pool::moments<T, RB, Stream>(x, c, tlen, s, smem, mean, var, denom);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          gm[j] = gm[j] / denom;
          gs[j] = gs[j] / (denom * sqrtf(var[j] + eps));
        }
        // the gradient pass, from the slab where the column is on chip
        T* d = dx + c.offset;
        const bool vec_d = c.full && vsv::pool::aligned16(dx);
        vsv::pool::sweep<T, RB, Stream>(x, c, tlen, s, smem, [&](int t, float m, const float* v) {
          float o[V];
#pragma unroll
          for (int j = 0; j < V; ++j) o[j] = m * (gm[j] + gs[j] * (v[j] - mean[j]));
          vsv::pool::store_lane(d + t * c.step, o, c.valid, vec_d);
        });
      });
}

template <typename T, int RB, bool Stream>
int run(const Plan& plan, const void* x, const float* mask, const void* dout, void* dx,
        int batch, int tlen, int flen, int channels, float eps, cudaStream_t stream) {
  CUtensorMap map{};
  const int tma = plan.design == vsv::pool::kColumn &&
                  vsv::pool::tensor_map<T>(&map, x, batch, tlen, flen, channels, Tile<T, RB>::C,
                                           vsv::pool::box_rows(tlen));
  return vsv::pool::launch_persistent<T, RB>(
      stats_pool_bwd_kernel<T, RB, Stream>, plan, batch, tlen, flen, channels, stream,
      static_cast<const T*>(x), mask, static_cast<const T*>(dout), static_cast<T*>(dx), eps, tma,
      map, plan.rows);
}

template <typename T>
int launch(const Plan& plan, const void* x, const float* mask, const void* dout, void* dx,
           int batch, int tlen, int flen, int channels, float eps, cudaStream_t stream) {
  if (!vsv::pool::plan_ok<T>(plan, tlen)) return vsv::kPlanMismatch;
  switch (vsv::pool::variant(plan)) {
    case 0:
      return run<T, 512, false>(plan, x, mask, dout, dx, batch, tlen, flen, channels, eps, stream);
    case 1:
      return run<T, 128, false>(plan, x, mask, dout, dx, batch, tlen, flen, channels, eps, stream);
    case 2:
      return run<T, 64, false>(plan, x, mask, dout, dx, batch, tlen, flen, channels, eps, stream);
    case 3:
      return run<T, 32, false>(plan, x, mask, dout, dx, batch, tlen, flen, channels, eps, stream);
    default:
      return run<T, 128, true>(plan, x, mask, dout, dx, batch, tlen, flen, channels, eps, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null. plan: K4's five ints
// (ops/nn.py:stats_pool_plan). One launch.
extern "C" int stats_pool_bwd(int dtype, const void* x, const float* mask,
                              const void* dout, void* dx, int batch, int tlen,
                              int flen, int channels, float eps, const int* plan,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4]};
  if (dtype == 0)
    return launch<float>(p, x, mask, dout, dx, batch, tlen, flen, channels, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, x, mask, dout, dx, batch, tlen, flen, channels, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
