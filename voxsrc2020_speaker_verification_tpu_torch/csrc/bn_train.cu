// K5: grouped training batch norm (per-replica statistics), forward and
// backward, with K3's relu / shortcut epilogue.
//
// Replaces: voxsrc2020_speaker_verification_tpu/ops/nn.py:_GroupedBN
// (lines 117-174) with the relu after it (models/res2net.py:64, 139, 209) and
// the residual add of bn3 (models/res2net.py:151), which XLA compiled on the
// TPU, and their JAX autodiff.
//
// Layout: the input is G batch groups of n rows of C channels, contiguous:
// a channels-last (B, T, F, C) activation (n = B/G * T * F) or a (B, C) head
// input (n = B/G). Statistics are per (group, channel), in fp32:
//
//   mean = sum(x) / n,  var = sum(x^2) / n - mean^2,  rstd = rsqrt(var + eps)
//   running_mean = mom * running_mean + upd_mean * mean_over_groups(mean)
//   running_var  = mom * running_var  + upd_var  * mean_over_groups(var)
//   y = relu?(round((x - mean) * rstd) [+ round((s - mean_s) * rstd_s) | + s])
//
// (upd_var carries the Bessel factor n/(n-1) on 4-D inputs only; the caller
// folds it in.) Backward, with d = dy * (y > 0) under relu:
//
//   dx = rstd * (d - sum(d)/n - xhat * sum(d * xhat)/n)
//   ds = rstd_s * (d - sum(d)/n - shat * sum(d * shat)/n)   (normalized shortcut)
//   ds = d                                                  (raw shortcut)
//
// Reductions are deterministic: a first pass writes per-block partial sums
// for each (group, channel) in a fixed partition of the rows, and a second
// kernel (one block per channel, a warp per group) adds them in a fixed
// order. No float atomics, so reruns match bit for bit.
//
// Bound on the card: bytes. A few flops per element against 2-4 B moved per
// element and operand. The forward reads x twice (statistics, normalize) and
// writes y once; the backward reads x, y and dy twice and writes dx once.
// Each thread owns four consecutive channels and moves them with one vector
// access; a block's threads cover whole rows, so every pass streams
// contiguous memory. The (group, channel) statistics are tiny and come from
// L1/L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Reduction geometry: a block covers `cpb` channel vectors (4 channels each)
// of `rpb` rows at a time; `tiles` blocks side by side cover the channels;
// `chunks` blocks one after the other cover a group's rows.
struct Geo {
  int cv, cpb, rpb, tiles, chunks;
};

Geo make_geo(int channels, int chunks) {
  Geo g;
  g.cv = channels / 4;
  g.cpb = g.cv < kThreads ? g.cv : kThreads;
  g.rpb = kThreads / g.cpb;
  g.tiles = (g.cv + g.cpb - 1) / g.cpb;
  g.chunks = chunks;
  return g;
}

__device__ __forceinline__ void load_stats(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// Sums of NS quantities per (group, channel) over one chunk of rows,
// reduced across the block's row lanes and written to
// part[((g * chunks + chunk) * NS + k) * C + c].
template <int NS>
__device__ __forceinline__ void write_partials(float (*acc)[4], const Geo& geo,
                                               int channels, float* part) {
  __shared__ float sh[NS][kThreads * 4];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) sh[k][threadIdx.x * 4 + j] = acc[k][j];
  __syncthreads();
  const int lane_c = threadIdx.x % geo.cpb;
  const int lane_r = threadIdx.x / geo.cpb;
  const int cv = blockIdx.y * geo.cpb + lane_c;
  if (lane_r != 0 || cv >= geo.cv) return;
  const long long base = (static_cast<long long>(blockIdx.z) * geo.chunks + blockIdx.x) * NS;
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.f;
      for (int r = 0; r < geo.rpb; ++r) s += sh[k][(r * geo.cpb + lane_c) * 4 + j];
      part[(base + k) * channels + cv * 4 + j] = s;
    }
}

// Forward statistics pass: sum(x), sum(x^2). Grid (chunks, tiles, G).
template <typename T>
__global__ void stats_kernel(const T* __restrict__ x, long long n, int channels,
                             Geo geo, float* __restrict__ part) {
  const int lane_c = threadIdx.x % geo.cpb;
  const int lane_r = threadIdx.x / geo.cpb;
  const int cv = blockIdx.y * geo.cpb + lane_c;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  if (lane_r < geo.rpb && cv < geo.cv) {
    const long long r0 = n * blockIdx.x / geo.chunks;
    const long long r1 = n * (blockIdx.x + 1) / geo.chunks;
    const T* base = x + static_cast<long long>(blockIdx.z) * n * channels + cv * 4;
    for (long long r = r0 + lane_r; r < r1; r += geo.rpb) {
      float v[4];
      vsv::load4(base + r * channels, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[0][j] += v[j];
        acc[1][j] += v[j] * v[j];
      }
    }
  }
  write_partials<2>(acc, geo, channels, part);
}

// Sum of part[(g * chunks + p) * stride + off] over the chunks p by one
// warp: lanes take chunks lane, lane + 32, ... in order, then a fixed
// shuffle tree; every lane returns the same total.
__device__ __forceinline__ float warp_chunk_sum(const float* __restrict__ part,
                                                long long base, int chunks,
                                                long long stride) {
  float s = 0.f;
  for (int p = threadIdx.x % 32; p < chunks; p += 32) s += part[base + p * stride];
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Forward finalize: one block per channel, one warp per group (in turn),
// writes mean and rstd per (group, channel); then one thread updates the
// running statistics in place with the mean over groups, in group order.
__global__ void finalize_fwd_kernel(const float* __restrict__ part, int groups,
                                    int chunks, int channels, float inv_n,
                                    float eps, float* __restrict__ mean,
                                    float* __restrict__ rstd,
                                    float* __restrict__ run_mean,
                                    float* __restrict__ run_var, float mom,
                                    float upd_mean, float upd_var) {
  extern __shared__ float moments[];  // (groups, 2)
  const int c = blockIdx.x;
  const long long stride = 2LL * channels;
  for (int g = threadIdx.x / 32; g < groups; g += blockDim.x / 32) {
    const long long base = static_cast<long long>(g) * chunks * stride + c;
    const float s = warp_chunk_sum(part, base, chunks, stride);
    const float q = warp_chunk_sum(part, base + channels, chunks, stride);
    if (threadIdx.x % 32 == 0) {
      const float mu = s * inv_n;
      const float var = q * inv_n - mu * mu;
      mean[g * channels + c] = mu;
      rstd[g * channels + c] = rsqrtf(var + eps);
      moments[2 * g] = mu;
      moments[2 * g + 1] = var;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float msum = 0.f, vsum = 0.f;
  for (int g = 0; g < groups; ++g) {
    msum += moments[2 * g];
    vsum += moments[2 * g + 1];
  }
  const float inv_g = 1.f / static_cast<float>(groups);
  run_mean[c] = mom * run_mean[c] + upd_mean * (msum * inv_g);
  run_var[c] = mom * run_var[c] + upd_var * (vsum * inv_g);
}

// Forward normalize pass with the epilogue, K3's rounding order.
template <typename T>
__global__ void normalize_kernel(const T* __restrict__ x,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ rstd,
                                 const T* __restrict__ sc,
                                 const float* __restrict__ sc_mean,
                                 const float* __restrict__ sc_rstd,
                                 T* __restrict__ out, long long nvec,
                                 int channels, long long group_elems, int relu,
                                 int sc_mode) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    const long long e = v * 4;
    const long long s = (e / group_elems) * channels + e % channels;
    float xv[4], mu[4], rs[4], sv[4], smu[4], srs[4], o[4];
    vsv::load4(x + e, xv);
    load_stats(mean + s, mu);
    load_stats(rstd + s, rs);
    if (sc_mode != 0) vsv::load4(sc + e, sv);
    if (sc_mode == 2) {
      load_stats(sc_mean + s, smu);
      load_stats(sc_rstd + s, srs);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float y = vsv::round_to<T>((xv[j] - mu[j]) * rs[j]);
      if (sc_mode == 2)
        y = vsv::round_to<T>(y + vsv::round_to<T>((sv[j] - smu[j]) * srs[j]));
      else if (sc_mode == 1)
        y = vsv::round_to<T>(y + sv[j]);
      if (relu) y = fmaxf(y, 0.f);
      o[j] = y;
    }
    vsv::store4(out + e, o);
  }
}

// Backward reduce pass: sum(d), sum(d * xhat) [, sum(d * shat)].
template <typename T, int NS>
__global__ void reduce_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                  const T* __restrict__ dy,
                                  const T* __restrict__ sc,
                                  const float* __restrict__ mean,
                                  const float* __restrict__ rstd,
                                  const float* __restrict__ sc_mean,
                                  const float* __restrict__ sc_rstd,
                                  long long n, int channels, Geo geo,
                                  float* __restrict__ part) {
  const int lane_c = threadIdx.x % geo.cpb;
  const int lane_r = threadIdx.x / geo.cpb;
  const int cv = blockIdx.y * geo.cpb + lane_c;
  float acc[NS][4];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
  if (lane_r < geo.rpb && cv < geo.cv) {
    const int g = blockIdx.z;
    float mu[4], rs[4], smu[4], srs[4];
    load_stats(mean + g * channels + cv * 4, mu);
    load_stats(rstd + g * channels + cv * 4, rs);
    if (NS == 3) {
      load_stats(sc_mean + g * channels + cv * 4, smu);
      load_stats(sc_rstd + g * channels + cv * 4, srs);
    }
    const long long r0 = n * blockIdx.x / geo.chunks;
    const long long r1 = n * (blockIdx.x + 1) / geo.chunks;
    const long long off = static_cast<long long>(g) * n * channels + cv * 4;
    for (long long r = r0 + lane_r; r < r1; r += geo.rpb) {
      const long long e = off + r * channels;
      float xv[4], dv[4], yv[4], sv[4];
      vsv::load4(x + e, xv);
      vsv::load4(dy + e, dv);
      if (y != nullptr) vsv::load4(y + e, yv);
      if (NS == 3) vsv::load4(sc + e, sv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = (y != nullptr && !(yv[j] > 0.f)) ? 0.f : dv[j];
        acc[0][j] += d;
        acc[1][j] += d * ((xv[j] - mu[j]) * rs[j]);
        if (NS == 3) acc[NS - 1][j] += d * ((sv[j] - smu[j]) * srs[j]);
      }
    }
  }
  write_partials<NS>(acc, geo, channels, part);
}

// Backward finalize: one block per channel, one warp per (group, sum);
// coef[(k * G + g) * C + c] = sum_k / n, k = 0: sum(d), 1: sum(d * xhat),
// 2: sum(d * shat).
__global__ void finalize_bwd_kernel(const float* __restrict__ part, int ns,
                                    int groups, int chunks, int channels,
                                    float inv_n, float* __restrict__ coef) {
  const int c = blockIdx.x;
  const long long stride = static_cast<long long>(ns) * channels;
  for (int gk = threadIdx.x / 32; gk < groups * ns; gk += blockDim.x / 32) {
    const int g = gk / ns, k = gk % ns;
    const float s = warp_chunk_sum(
        part, static_cast<long long>(g) * chunks * stride + k * channels + c, chunks, stride);
    if (threadIdx.x % 32 == 0)
      coef[(static_cast<long long>(k) * groups + g) * channels + c] = s * inv_n;
  }
}

// Backward elementwise pass: dx and the shortcut's gradient.
template <typename T>
__global__ void grad_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            const T* __restrict__ dy, const T* __restrict__ sc,
                            const float* __restrict__ mean,
                            const float* __restrict__ rstd,
                            const float* __restrict__ sc_mean,
                            const float* __restrict__ sc_rstd,
                            const float* __restrict__ coef, T* __restrict__ dx,
                            T* __restrict__ dsc, long long nvec, int channels,
                            int groups, long long group_elems, int sc_mode) {
  const long long gc = static_cast<long long>(groups) * channels;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    const long long e = v * 4;
    const long long s = (e / group_elems) * channels + e % channels;
    float xv[4], dv[4], yv[4], mu[4], rs[4], a[4], b[4], o[4];
    vsv::load4(x + e, xv);
    vsv::load4(dy + e, dv);
    if (y != nullptr) vsv::load4(y + e, yv);
    load_stats(mean + s, mu);
    load_stats(rstd + s, rs);
    load_stats(coef + s, a);
    load_stats(coef + gc + s, b);
    float d[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d[j] = (y != nullptr && !(yv[j] > 0.f)) ? 0.f : dv[j];
      o[j] = rs[j] * (d[j] - a[j] - ((xv[j] - mu[j]) * rs[j]) * b[j]);
    }
    vsv::store4(dx + e, o);
    if (sc_mode == 1) {
      vsv::store4(dsc + e, d);
    } else if (sc_mode == 2) {
      float sv[4], smu[4], srs[4], bs[4];
      vsv::load4(sc + e, sv);
      load_stats(sc_mean + s, smu);
      load_stats(sc_rstd + s, srs);
      load_stats(coef + 2 * gc + s, bs);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = srs[j] * (d[j] - a[j] - ((sv[j] - smu[j]) * srs[j]) * bs[j]);
      vsv::store4(dsc + e, o);
    }
  }
}

unsigned elementwise_blocks(long long nvec, int num_sms) {
  long long blocks = (nvec + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(num_sms) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

template <typename T>
int forward(const void* x, const void* sc, int sc_mode, int relu, long long n,
            int groups, int channels, int chunks, float* mean, float* rstd,
            float* run_mean, float* run_var, float* sc_mean, float* sc_rstd,
            float* sc_run_mean, float* sc_run_var, float mom, float upd_mean,
            float upd_var, float eps, float* part, void* out, int num_sms,
            cudaStream_t stream) {
  const Geo geo = make_geo(channels, chunks);
  const dim3 grid(chunks, geo.tiles, groups);
  const size_t fin_smem = 2 * sizeof(float) * groups;
  const float inv_n = 1.f / static_cast<float>(n);
  stats_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), n,
                                                  channels, geo, part);
  finalize_fwd_kernel<<<channels, kThreads, fin_smem, stream>>>(
      part, groups, chunks, channels, inv_n, eps, mean, rstd, run_mean, run_var,
      mom, upd_mean, upd_var);
  if (sc_mode == 2) {
    stats_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(sc), n,
                                                    channels, geo, part);
    finalize_fwd_kernel<<<channels, kThreads, fin_smem, stream>>>(
        part, groups, chunks, channels, inv_n, eps, sc_mean, sc_rstd,
        sc_run_mean, sc_run_var, mom, upd_mean, upd_var);
  }
  const long long nvec = n * groups * channels / 4;
  normalize_kernel<T><<<elementwise_blocks(nvec, num_sms), kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, static_cast<const T*>(sc), sc_mean,
      sc_rstd, static_cast<T*>(out), nvec, channels, n * channels, relu, sc_mode);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* x, const void* y, const void* dy, const void* sc,
             int sc_mode, long long n, int groups, int channels, int chunks,
             const float* mean, const float* rstd, const float* sc_mean,
             const float* sc_rstd, float* part, float* coef, void* dx, void* dsc,
             int num_sms, cudaStream_t stream) {
  const Geo geo = make_geo(channels, chunks);
  const dim3 grid(chunks, geo.tiles, groups);
  const float inv_n = 1.f / static_cast<float>(n);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  const T* st = static_cast<const T*>(sc);
  int ns = 2;
  if (sc_mode == 2) {
    ns = 3;
    reduce_bwd_kernel<T, 3><<<grid, kThreads, 0, stream>>>(
        xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, n, channels, geo, part);
  } else {
    reduce_bwd_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
        xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, n, channels, geo, part);
  }
  finalize_bwd_kernel<<<channels, kThreads, 0, stream>>>(
      part, ns, groups, chunks, channels, inv_n, coef);
  const long long nvec = n * groups * channels / 4;
  grad_kernel<T><<<elementwise_blocks(nvec, num_sms), kThreads, 0, stream>>>(
      xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, coef, static_cast<T*>(dx),
      static_cast<T*>(dsc), nvec, channels, groups, n * channels, sc_mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. sc_mode: 0 none, 1 raw shortcut, 2
// shortcut normalized with its own batch statistics (sc_mean/sc_rstd written,
// sc_run_mean/sc_run_var updated). n: rows per group; channels % 4 == 0.
// mean/rstd (and sc_*): (groups, channels) fp32 outputs. part: scratch of
// 2 * groups * chunks * channels floats.
extern "C" int bn_train_fwd(int dtype, const void* x, const void* sc,
                            int sc_mode, int relu, long long n, int groups,
                            int channels, int chunks, float* mean, float* rstd,
                            float* run_mean, float* run_var, float* sc_mean,
                            float* sc_rstd, float* sc_run_mean,
                            float* sc_run_var, float mom, float upd_mean,
                            float upd_var, float eps, float* part, void* out,
                            int num_sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(x, sc, sc_mode, relu, n, groups, channels, chunks,
                          mean, rstd, run_mean, run_var, sc_mean, sc_rstd,
                          sc_run_mean, sc_run_var, mom, upd_mean, upd_var, eps,
                          part, out, num_sms, s);
  if (dtype == 1)
    return forward<__nv_bfloat16>(x, sc, sc_mode, relu, n, groups, channels,
                                  chunks, mean, rstd, run_mean, run_var, sc_mean,
                                  sc_rstd, sc_run_mean, sc_run_var, mom,
                                  upd_mean, upd_var, eps, part, out, num_sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y: the forward output (null unless relu). part: scratch of
// 3 * groups * chunks * channels floats; coef: 3 * groups * channels floats.
// dsc: the shortcut's gradient (sc_mode 1 or 2), else null.
extern "C" int bn_train_bwd(int dtype, const void* x, const void* y,
                            const void* dy, const void* sc, int sc_mode,
                            long long n, int groups, int channels, int chunks,
                            const float* mean, const float* rstd,
                            const float* sc_mean, const float* sc_rstd,
                            float* part, float* coef, void* dx, void* dsc,
                            int num_sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(x, y, dy, sc, sc_mode, n, groups, channels, chunks,
                           mean, rstd, sc_mean, sc_rstd, part, coef, dx, dsc,
                           num_sms, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, y, dy, sc, sc_mode, n, groups, channels,
                                   chunks, mean, rstd, sc_mean, sc_rstd, part,
                                   coef, dx, dsc, num_sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
