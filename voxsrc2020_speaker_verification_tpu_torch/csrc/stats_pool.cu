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
// flops per element). Each (b, f, channel tile) has its T rows staged into
// shared memory once, and both passes of the moments read the slab, so x
// leaves HBM once wherever the column fits on chip: T <= 128 at 512-byte
// tile rows by cp.async (the ring design), longer columns at 128-, 64- or
// 32-byte rows by tensor copies (the column design: every W = 1 head, T up
// to ~3,100). Persistent CTAs keep the next tile's copies in flight while
// they reduce this one. The plan (design, tile rows, slab rows, stages,
// shared memory) is ops/nn.py:stats_pool_plan; the walk is
// stats_pool.cuh.
#include "stats_pool.cuh"

namespace {

using vsv::pool::Plan;
using vsv::pool::Tile;

template <typename T, int RB, bool Stream>
__global__ void __launch_bounds__(vsv::pool::kThreads)
    stats_pool_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                      T* __restrict__ out, float eps, int tma,
                      const __grid_constant__ CUtensorMap map, int slab_rows,
                      int batch, int tlen, int flen, int channels) {
  constexpr int V = Tile<T, RB>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  vsv::pool::for_each_tile<T, RB, Stream>(
      x, mask, batch, tlen, flen, channels, tma != 0, &map, slab_rows, smem,
      [&](const vsv::pool::Column& c, const vsv::pool::Smem& s) {
        float mean[V], var[V], denom;
        vsv::pool::moments<T, RB, Stream>(x, c, tlen, s, smem, mean, var, denom);
        // row lane 0 (the first L threads) writes the tile
        if (threadIdx.x >= Tile<T, RB>::L || c.valid == 0) return;
        float sd[V];
#pragma unroll
        for (int j = 0; j < V; ++j) sd[j] = sqrtf(var[j] + eps);
        T* o = out + c.bf * 2 * channels + c.c0;
        const bool vec = c.full && vsv::pool::aligned16(out);
        vsv::pool::store_lane(o, mean, c.valid, vec);
        vsv::pool::store_lane(o + channels, sd, c.valid, vec);
      });
}

template <typename T, int RB, bool Stream>
int run(const Plan& plan, const void* x, const float* mask, void* out, int batch, int tlen,
        int flen, int channels, float eps, cudaStream_t stream) {
  CUtensorMap map{};
  const int tma = plan.design == vsv::pool::kColumn &&
                  vsv::pool::tensor_map<T>(&map, x, batch, tlen, flen, channels, Tile<T, RB>::C,
                                           vsv::pool::box_rows(tlen));
  return vsv::pool::launch_persistent<T, RB>(stats_pool_kernel<T, RB, Stream>, plan, batch,
                                             tlen, flen, channels, stream,
                                             static_cast<const T*>(x), mask,
                                             static_cast<T*>(out), eps, tma, map, plan.rows);
}

template <typename T>
int launch(const Plan& plan, const void* x, const float* mask, void* out, int batch, int tlen,
           int flen, int channels, float eps, cudaStream_t stream) {
  if (!vsv::pool::plan_ok<T>(plan, tlen)) return vsv::kPlanMismatch;
  switch (vsv::pool::variant(plan)) {
    case 0: return run<T, 512, false>(plan, x, mask, out, batch, tlen, flen, channels, eps, stream);
    case 1: return run<T, 128, false>(plan, x, mask, out, batch, tlen, flen, channels, eps, stream);
    case 2: return run<T, 64, false>(plan, x, mask, out, batch, tlen, flen, channels, eps, stream);
    case 3: return run<T, 32, false>(plan, x, mask, out, batch, tlen, flen, channels, eps, stream);
    default: return run<T, 128, true>(plan, x, mask, out, batch, tlen, flen, channels, eps, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask may be null. plan: the five ints of
// ops/nn.py:stats_pool_plan (kPlanMismatch where they are not this layout's).
// One launch.
extern "C" int stats_pool(int dtype, const void* x, const float* mask,
                          void* out, int batch, int tlen, int flen,
                          int channels, float eps, const int* plan, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4]};
  if (dtype == 0)
    return launch<float>(p, x, mask, out, batch, tlen, flen, channels, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, x, mask, out, batch, tlen, flen, channels, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
