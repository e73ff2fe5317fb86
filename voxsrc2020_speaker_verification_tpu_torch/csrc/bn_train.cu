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
// folds it in. Null running-statistic pointers skip the update: a
// rematerialized block's recomputed forward must not apply it twice.)
// Backward, with d = dy * (y > 0) under relu:
//
//   dx = rstd * (d - sum(d)/n - xhat * sum(d * xhat)/n)
//   ds = rstd_s * (d - sum(d)/n - shat * sum(d * shat)/n)   (normalized shortcut)
//   ds = d                                                  (raw shortcut)
//
// Bound on the card: bytes. A few flops per element against 2-4 B moved per
// element and operand; at least x read and y written in the forward, x, dy
// read and dx written in the backward.
//
// What bounded the first design (kept below as the "multi-kernel" design,
// which 4-D calls whose rows cannot be folded take (below); at channel
// counts that are not multiples of 4 it moves single channels instead of
// 4-channel vectors, with the same arithmetic an element; the 2-D head
// calls have the head design, after the cluster design):
// three launches per direction -- per-block partial sums, a per-channel
// finalize, an elementwise pass -- with the partials making a round trip
// through HBM, x read twice in the forward, x, y and dy read twice in the
// backward (7 units of one activation against the bound's 4), and 8-byte
// bf16 accesses.
//
// The cluster design (4-D inputs; the wrapper chooses it by shape): one
// launch per direction, filling the card in one wave. Thread-block clusters
// of 2 CTAs (kClusterSize), k of them per BN group, k the most the card
// holds at once (cudaOccupancyMaxActiveClusters; one CTA per SM at this
// shared-memory footprint): on the H100, 8 groups x 8 clusters of 2 = 128
// CTAs on the 132 SMs, launched cooperatively so that all of them are
// resident together (larger clusters fit fewer CTAs on the card, as a
// cluster's CTAs share one GPC). Each CTA owns a contiguous slab of its
// group's rows, at full channel width, and streams it through a ring of
// chunks (about four, at most 16) in shared memory filled by bulk copies
// (the Tensor Memory Accelerator's 1-D form) on mbarriers, so ~200 KB are
// in flight per SM; it sums its rows with a fixed tree over its threads,
// the cluster adds its CTAs' sums through distributed shared memory in
// rank order, and the group's clusters add theirs in order through global
// memory behind a generation barrier of the group (integer atomics only; a
// wait that lasts 30 s traps instead of hanging). After it the same launch
// normalizes (forward) or writes dx (backward), from the slab still in
// shared memory where it fits in the ring, else streamed again (from L2
// for tensors that fit there). The backward takes no y: the relu decision
// is recomputed from x (and the shortcut) with the forward's exact
// arithmetic (bn_out below), except for a raw shortcut, whose forward
// output y the caller saves instead of the shortcut. The running
// statistics need the mean over groups: each group publishes its (mean,
// var), and the last group to arrive (an integer ticket with fences)
// applies the update in group order and resets the ticket. No float
// atomics anywhere: reruns match bit for bit.
//
// Folded rows: where C channels do not fill 16-byte vectors (dpn68's
// 10-channel stem: 20 bytes a bf16 row), k = vec / gcd(C, vec) consecutive
// rows do (4 rows of 10 bf16 channels are 80 bytes, 5 vectors), and in the
// channels-last layout they are contiguous. The same kernels then walk
// super-rows of `fold` rows, fold a multiple of k that divides the group's
// n rows: a lane's vector holds super-channels s, channel s % C, and the
// CTA adds each channel's fold super-channel sums in order before the
// cluster and group reductions, so everything after them (statistics,
// inv_n, the Bessel factor, the running update) is that of the n rows and
// C channels. The plan takes the fold that gives the CTA the most threads:
// at 5 vectors a super-row a CTA holds 320 (10 warps), too few to hide the
// element arithmetic's latency in bf16; at fold 100 (125 vectors x 4 row
// lanes) it holds 500. The first design moved 2-byte elements there, with
// 64-bit index divisions an element, in three launches a direction.
//
// What bounds it now: HBM bytes -- x read twice and y written in the
// forward, x and dy read twice and dx written in the backward (3 and 5
// units of one activation against the bound's 2 and 3) where a slab does
// not fit on chip; the second pass walks the slab from its end, so its
// first chunks come from L2 -- then the element arithmetic in bf16, which
// is why the relu decision and the forward's rounding without a shortcut
// take no conversions (relu_edge, below), and the 4 SMs a grid of 8 groups
// leaves idle.
//
// The head design (bn_head_*: the 2-D calls) has its own section below
// the cluster design: one launch a direction, a CTA a channel tile across
// all rows. The spanning mode (bn_span_*: groups that span the data ranks,
// with an all-reduce between its launches) follows it: one launch a phase
// on the cluster design's ring.
#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Reduction geometry: a block covers `cpb` channel vectors (V channels
// each: 4, or 1 where C % 4 != 0) of `rpb` rows at a time; `tiles` blocks
// side by side cover the channels; `chunks` blocks one after the other
// cover a group's rows.
struct Geo {
  int cv, cpb, rpb, tiles, chunks;
};

template <int V>
Geo make_geo(int channels, int chunks) {
  Geo g;
  g.cv = channels / V;
  g.cpb = g.cv < kThreads ? g.cv : kThreads;
  g.rpb = kThreads / g.cpb;
  g.tiles = (g.cv + g.cpb - 1) / g.cpb;
  g.chunks = chunks;
  return g;
}

template <int V = 4>
__device__ __forceinline__ void load_stats(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Sums of NS quantities per (group, channel) over one chunk of rows,
// reduced across the block's row lanes and written to
// part[((g * chunks + chunk) * NS + k) * C + c].
template <int NS, int V>
__device__ __forceinline__ void write_partials(float (*acc)[V], const Geo& geo,
                                               int channels, float* part) {
  __shared__ float sh[NS][kThreads * V];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) sh[k][threadIdx.x * V + j] = acc[k][j];
  __syncthreads();
  const int lane_c = threadIdx.x % geo.cpb;
  const int lane_r = threadIdx.x / geo.cpb;
  const int cv = blockIdx.y * geo.cpb + lane_c;
  if (lane_r != 0 || cv >= geo.cv) return;
  const long long base = (static_cast<long long>(blockIdx.z) * geo.chunks + blockIdx.x) * NS;
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float s = 0.f;
      for (int r = 0; r < geo.rpb; ++r) s += sh[k][(r * geo.cpb + lane_c) * V + j];
      part[(base + k) * channels + cv * V + j] = s;
    }
}

// Forward statistics pass: sum(x), sum(x^2). Grid (chunks, tiles, groups);
// a group is n rows.
template <typename T, int V>
__global__ void stats_kernel(const T* __restrict__ x, long long n, int channels,
                             Geo geo, float* __restrict__ part) {
  const int lane_c = threadIdx.x % geo.cpb;
  const int lane_r = threadIdx.x / geo.cpb;
  const int cv = blockIdx.y * geo.cpb + lane_c;
  float acc[2][V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[0][j] = acc[1][j] = 0.f;
  if (lane_r < geo.rpb && cv < geo.cv) {
    const long long lo = blockIdx.z * n;
    const long long r0 = n * blockIdx.x / geo.chunks;
    const long long r1 = n * (blockIdx.x + 1) / geo.chunks;
    const T* base = x + lo * channels + cv * V;
    for (long long r = r0 + lane_r; r < r1; r += geo.rpb) {
      float v[V];
      vsv::load_v<V>(base + r * channels, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[0][j] += v[j];
        acc[1][j] += v[j] * v[j];
      }
    }
  }
  write_partials<2, V>(acc, geo, channels, part);
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
  if (threadIdx.x != 0 || run_mean == nullptr) return;  // null: no running update
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
template <typename T, int V>
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
    const long long e = v * V;
    const long long s = (e / group_elems) * channels + e % channels;
    float xv[V], mu[V], rs[V], sv[V], smu[V], srs[V], o[V];
    vsv::load_v<V>(x + e, xv);
    load_stats<V>(mean + s, mu);
    load_stats<V>(rstd + s, rs);
    if (sc_mode != 0) vsv::load_v<V>(sc + e, sv);
    if (sc_mode == 2) {
      load_stats<V>(sc_mean + s, smu);
      load_stats<V>(sc_rstd + s, srs);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y = vsv::round_to<T>((xv[j] - mu[j]) * rs[j]);
      if (sc_mode == 2)
        y = vsv::round_to<T>(y + vsv::round_to<T>((sv[j] - smu[j]) * srs[j]));
      else if (sc_mode == 1)
        y = vsv::round_to<T>(y + sv[j]);
      if (relu) y = fmaxf(y, 0.f);
      o[j] = y;
    }
    vsv::store_v<V>(out + e, o);
  }
}

// Backward reduce pass: sum(d), sum(d * xhat) [, sum(d * shat)].
template <typename T, int NS, int V>
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
  float acc[NS][V];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  if (lane_r < geo.rpb && cv < geo.cv) {
    const int g = blockIdx.z;
    float mu[V], rs[V], smu[V], srs[V];
    load_stats<V>(mean + g * channels + cv * V, mu);
    load_stats<V>(rstd + g * channels + cv * V, rs);
    if (NS == 3) {
      load_stats<V>(sc_mean + g * channels + cv * V, smu);
      load_stats<V>(sc_rstd + g * channels + cv * V, srs);
    }
    const long long lo = g * n;
    const long long r0 = n * blockIdx.x / geo.chunks;
    const long long r1 = n * (blockIdx.x + 1) / geo.chunks;
    const long long off = lo * channels + cv * V;
    for (long long r = r0 + lane_r; r < r1; r += geo.rpb) {
      const long long e = off + r * channels;
      float xv[V], dv[V], yv[V], sv[V];
      vsv::load_v<V>(x + e, xv);
      vsv::load_v<V>(dy + e, dv);
      if (y != nullptr) vsv::load_v<V>(y + e, yv);
      if (NS == 3) vsv::load_v<V>(sc + e, sv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = (y != nullptr && !(yv[j] > 0.f)) ? 0.f : dv[j];
        acc[0][j] += d;
        acc[1][j] += d * ((xv[j] - mu[j]) * rs[j]);
        if (NS == 3) acc[NS - 1][j] += d * ((sv[j] - smu[j]) * srs[j]);
      }
    }
  }
  write_partials<NS, V>(acc, geo, channels, part);
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
template <typename T, int V>
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
    const long long e = v * V;
    const long long s = (e / group_elems) * channels + e % channels;
    float xv[V], dv[V], yv[V], mu[V], rs[V], a[V], b[V], o[V];
    vsv::load_v<V>(x + e, xv);
    vsv::load_v<V>(dy + e, dv);
    if (y != nullptr) vsv::load_v<V>(y + e, yv);
    load_stats<V>(mean + s, mu);
    load_stats<V>(rstd + s, rs);
    load_stats<V>(coef + s, a);
    load_stats<V>(coef + gc + s, b);
    float d[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      d[j] = (y != nullptr && !(yv[j] > 0.f)) ? 0.f : dv[j];
      o[j] = rs[j] * (d[j] - a[j] - ((xv[j] - mu[j]) * rs[j]) * b[j]);
    }
    vsv::store_v<V>(dx + e, o);
    if (sc_mode == 1) {
      vsv::store_v<V>(dsc + e, d);
    } else if (sc_mode == 2) {
      float sv[V], smu[V], srs[V], bs[V];
      vsv::load_v<V>(sc + e, sv);
      load_stats<V>(sc_mean + s, smu);
      load_stats<V>(sc_rstd + s, srs);
      load_stats<V>(coef + 2 * gc + s, bs);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = srs[j] * (d[j] - a[j] - ((sv[j] - smu[j]) * srs[j]) * bs[j]);
      vsv::store_v<V>(dsc + e, o);
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

template <typename T, int V>
int forward(const void* x, const void* sc, int sc_mode, int relu, long long n,
            int groups, int channels, int chunks, float* mean, float* rstd,
            float* run_mean, float* run_var, float* sc_mean, float* sc_rstd,
            float* sc_run_mean, float* sc_run_var, float mom, float upd_mean,
            float upd_var, float eps, float* part, void* out, int num_sms,
            cudaStream_t stream) {
  const Geo geo = make_geo<V>(channels, chunks);
  const dim3 grid(chunks, geo.tiles, groups);
  const size_t fin_smem = 2 * sizeof(float) * groups;
  const float inv_n = 1.f / static_cast<float>(n);
  stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), n,
                                                     channels, geo, part);
  finalize_fwd_kernel<<<channels, kThreads, fin_smem, stream>>>(
      part, groups, chunks, channels, inv_n, eps, mean, rstd, run_mean, run_var,
      mom, upd_mean, upd_var);
  if (sc_mode == 2) {
    stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(sc), n,
                                                       channels, geo, part);
    finalize_fwd_kernel<<<channels, kThreads, fin_smem, stream>>>(
        part, groups, chunks, channels, inv_n, eps, sc_mean, sc_rstd,
        sc_run_mean, sc_run_var, mom, upd_mean, upd_var);
  }
  const long long nvec = n * groups * channels / V;
  normalize_kernel<T, V><<<elementwise_blocks(nvec, num_sms), kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, static_cast<const T*>(sc), sc_mean,
      sc_rstd, static_cast<T*>(out), nvec, channels, n * channels, relu, sc_mode);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int backward(const void* x, const void* y, const void* dy, const void* sc,
             int sc_mode, long long n, int groups, int channels, int chunks,
             const float* mean, const float* rstd, const float* sc_mean,
             const float* sc_rstd, float* part, float* coef, void* dx, void* dsc,
             int num_sms, cudaStream_t stream) {
  const Geo geo = make_geo<V>(channels, chunks);
  const dim3 grid(chunks, geo.tiles, groups);
  const float inv_n = 1.f / static_cast<float>(n);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  const T* st = static_cast<const T*>(sc);
  int ns = 2;
  if (sc_mode == 2) {
    ns = 3;
    reduce_bwd_kernel<T, 3, V><<<grid, kThreads, 0, stream>>>(
        xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, n, channels, geo, part);
  } else {
    reduce_bwd_kernel<T, 2, V><<<grid, kThreads, 0, stream>>>(
        xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, n, channels, geo, part);
  }
  finalize_bwd_kernel<<<channels, kThreads, 0, stream>>>(
      part, ns, groups, chunks, channels, inv_n, coef);
  const long long nvec = n * groups * channels / V;
  grad_kernel<T, V><<<elementwise_blocks(nvec, num_sms), kThreads, 0, stream>>>(
      xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, coef, static_cast<T*>(dx),
      static_cast<T*>(dsc), nvec, channels, groups, n * channels, sc_mode);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// cluster design: one launch per direction
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kClusterSize = 2;      // CTAs per cluster
constexpr int kClusterThreads = 512;
constexpr int kSmemMax = 232448;  // 227 KB, the most a block can take
constexpr int kMaxStages = 16;    // depth of the bulk-copy ring
// The launch is cooperative, so CUDA starts the grid only with every CTA
// resident; a wait on the other clusters of a group that lasts this
// long means that promise broke: trap (a launch error) rather than hang
constexpr unsigned long long kBarrierTimeoutNs = 30000000000ull;

template <typename T> struct Vec;  // elements per 16-byte vector
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

using vsv::store16;
using vsv::unpack16;

// The forward's output before the relu, K3's rounding order. The backward
// recomputes it to take the relu decision, so both use this one function,
// with explicitly rounded operations (no contraction into an FMA that one
// kernel might form and the other not).
template <typename T>
__device__ __forceinline__ float bn_out(float x, float mu, float rs, float s,
                                        float smu, float srs, int sc_mode) {
  float y = vsv::round_to<T>(__fmul_rn(__fsub_rn(x, mu), rs));
  if (sc_mode == 2)
    y = vsv::round_to<T>(__fadd_rn(y, vsv::round_to<T>(__fmul_rn(__fsub_rn(s, smu), srs))));
  else if (sc_mode == 1)
    y = vsv::round_to<T>(__fadd_rn(y, s));
  return y;
}

// The largest value that the forward's output rounds to zero: float32 0;
// bf16 2^-134, half its least subnormal (round to nearest even sends it to
// zero). Without a shortcut, relu(round(xhat)) > 0 exactly where xhat is
// above it: the backward takes the decision without a conversion.
template <typename T> __device__ __forceinline__ float relu_edge();
template <> __device__ __forceinline__ float relu_edge<float>() { return 0.f; }
template <> __device__ __forceinline__ float relu_edge<__nv_bfloat16>() {
  return __uint_as_float(0x00008000u);
}

struct ClusterArgs {
  const void* x;
  const void* sc;    // shortcut (modes 1, 2); null otherwise
  const void* y;     // backward, mode 1 with relu: the forward output
  const void* dy;    // backward
  void* out;         // forward: y; backward: dx
  void* dsc;         // backward: the shortcut's gradient (modes 1, 2)
  float* mean;       // (G, C); forward writes, backward reads
  float* rstd;
  float* sc_mean;
  float* sc_rstd;
  float* var;        // forward: (2, G, C) scratch, the groups' variances
  float* gpart;      // (G, k, NS, C) scratch: each cluster's sums
  float* run_mean;
  float* run_var;
  float* sc_run_mean;
  float* sc_run_var;
  int* sync;         // 2G + 1 ints: arrivals and generation per group, the running update's ticket
  long long n;       // rows per group: super-rows of `fold` rows where fold > 1
  int groups, channels, ct_v, rpb;
  int fold;          // rows a (super-)row holds; 1 where a row fills 16-byte vectors
  int width;         // elements a (super-)row: channels * fold
  int k;             // clusters per group (set by the launcher)
  int ring_rows, ring_bytes;
  int sc_mode, relu;
  float mom, upd_mean, upd_var, eps, inv_n;
};

// This CTA's place: group g, cluster kq of the group's k, rank in the
// cluster, and its rows [r0, r1) of the group (P = k * cs CTAs a group).
struct Slab {
  int g, kq, rank, cs, p;
  long long r0, r1;
};

__device__ __forceinline__ Slab slab_of(const ClusterArgs& a, cg::cluster_group& cluster) {
  Slab s;
  s.cs = static_cast<int>(cluster.num_blocks());
  s.rank = static_cast<int>(cluster.block_rank());
  const int P = a.k * s.cs;
  s.g = blockIdx.x / P;
  s.p = blockIdx.x % P;
  s.kq = s.p / s.cs;
  s.r0 = a.n * s.p / P;
  s.r1 = a.n * (s.p + 1) / P;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A barrier of the k clusters of one group (thread 0 of each CTA; the
// clusters' rank-0 CTAs arrive, every CTA waits). Sense by generation: the
// last to arrive resets the count and advances gen; a waiter read gen
// before any arrival could complete the barrier (at kernel start). No
// float atomics: the sums it guards are added in a fixed order afterwards.
__device__ __forceinline__ void group_barrier(int* count, int* gen, int k, bool arrive,
                                              int old_gen) {
  if (arrive) {
    __threadfence();
    if (atomicAdd(count, 1) == k - 1) {
      atomicExch(count, 0);
      __threadfence();
      atomicAdd(gen, 1);
    }
  }
  const unsigned long long t0 = global_ns();
  while (load_acquire(gen) == old_gen) {
    __nanosleep(64);
    if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
  }
  __threadfence();
}

// Reduce acc[k][.] over the block's row lanes (a fixed pairwise tree, rpb a
// power of two) into part[k * C + c]; red holds blockDim * V floats. With
// fold > 1 a lane's element is super-channel s of a folded row, channel s %
// C: the fold's super-channels of each channel are added in order, here,
// before the cluster and group reductions (which then move C sums, not C *
// fold).
template <int NS, int V>
__device__ __forceinline__ void block_sums(float (*acc)[V], float* red, float* part,
                                           int ct_v, int rpb, int channels, int fold) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane_c = tid % ct_v, lane_r = tid / ct_v;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[j * nt + tid] = acc[k][j];
    __syncthreads();
    for (int s = rpb / 2; s > 0; s /= 2) {
      if (lane_r < s)
#pragma unroll
        for (int j = 0; j < V; ++j) red[j * nt + tid] += red[j * nt + tid + s * ct_v];
      __syncthreads();
    }
    if (fold == 1) {
      if (lane_r == 0)
#pragma unroll
        for (int j = 0; j < V; ++j) part[(k * ct_v + lane_c) * V + j] = red[j * nt + tid];
    } else {
      // row lane 0's totals: super-channel e at red[(e % V) * nt + e / V]
      for (int c = tid; c < channels; c += nt) {
        float v = 0.f;
        for (int i = 0; i < fold; ++i) {
          const int e = i * channels + c;
          v += red[(e % V) * nt + e / V];
        }
        part[k * channels + c] = v;
      }
    }
    __syncthreads();
  }
}

// The group's sums of NS quantities per channel into tot[k * C + c], the
// same in every CTA of the group: this CTA's row lanes in a fixed tree, the
// cluster's CTAs in rank order through distributed shared memory, then
// (k > 1) the group's clusters in order through global memory, after the
// group barrier.
template <int NS, int V>
__device__ __forceinline__ void group_sums(float (*acc)[V], float* red, float* part, float* tot,
                                           const ClusterArgs& a, const Slab& s,
                                           cg::cluster_group& cluster, int old_gen) {
  const int C = a.channels, tid = threadIdx.x;
  block_sums<NS, V>(acc, red, part, a.ct_v, a.rpb, C, a.fold);
  cluster.sync();
  for (int e = tid; e < NS * C; e += blockDim.x) {
    float v = 0.f;
    for (int q = 0; q < s.cs; ++q) v += cluster.map_shared_rank(part, q)[e];
    tot[e] = v;
  }
  cluster.sync();  // no CTA leaves while another reads its partials
  if (a.k == 1) return;
  float* gp = a.gpart + static_cast<long long>(s.g) * a.k * NS * C;
  if (s.rank == 0)
    for (int e = tid; e < NS * C; e += blockDim.x) gp[s.kq * NS * C + e] = tot[e];
  __threadfence();  // written before the arrival
  __syncthreads();
  if (tid == 0)
    group_barrier(a.sync + s.g, a.sync + a.groups + s.g, a.k, s.rank == 0, old_gen);
  __syncthreads();
  for (int e = tid; e < NS * C; e += blockDim.x) {
    float v = 0.f;
    for (int j = 0; j < a.k; ++j) v += __ldcg(gp + j * NS * C + e);
    tot[e] = v;
  }
  __syncthreads();
}

// Stages of the ring for ni tensors: as many chunks of R rows as fit.
__device__ __forceinline__ int ring_stages(const ClusterArgs& a, int ni, int row_bytes) {
  const int s = a.ring_bytes / (ni * a.ring_rows * row_bytes);
  return s < kMaxStages ? s : kMaxStages;
}

// Initialize kMaxStages mbarriers of one arrival each (thread 0), before
// any use.
__device__ __forceinline__ void ring_init(uint64_t* full) {
  if (threadIdx.x == 0)
    for (int i = 0; i < kMaxStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[i]))
                   : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
}

// Stream rows [0, rows) of `ni` tensors (rows of ct_v 16-byte vectors,
// contiguous from src[i]) through a ring of S chunks of R rows in shared
// memory: thread 0 keeps S chunks in flight with bulk copies (the Tensor
// Memory Accelerator's 1-D form) completing on the chunk's mbarrier, and
// every thread calls f(row, &vector of tensor 0, stride to the next
// tensor) for rows lane_r, lane_r + rpb, ... of each chunk in order. `seq`
// counts the chunks streamed so far through this ring (the mbarriers'
// phases). With rows <= S * R the chunks stay in place afterwards:
// visit_resident reads them again. REVERSE takes the chunks from the last:
// a second pass over a slab that did not stay in the ring starts with what
// the first pass read last, the part of it still in L2 (50 MB). The second
// passes are elementwise, so the order changes no output.
template <bool REVERSE = false, typename F>
__device__ __forceinline__ void stream_ring(const char* const* src, int ni, long long rows,
                                          int ct_v, int rpb, int R, int S, uint4* ring,
                                          uint64_t* full, int& seq, F f) {
  const int lane_c = threadIdx.x % ct_v, lane_r = threadIdx.x / ct_v;
  const long long row_bytes = 16LL * ct_v;
  const long long nchunks = (rows + R - 1) / R;
  const long long ts = static_cast<long long>(R) * ct_v;
  // the q-th chunk streamed is chunk(q) of the slab
  auto chunk = [&](long long q) { return REVERSE ? nchunks - 1 - q : q; };
  auto issue = [&](long long q) {
    const int st = static_cast<int>((seq + q) % S);
    const long long k = chunk(q);
    const long long nr = min(static_cast<long long>(R), rows - k * R);
    const uint32_t bytes = static_cast<uint32_t>(nr * row_bytes);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(&full[st])),
                 "r"(bytes * ni)
                 : "memory");
    for (int i = 0; i < ni; ++i)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_u32(ring + (st * ni + i) * ts)),
          "l"(src[i] + k * R * row_bytes), "r"(bytes), "r"(smem_u32(&full[st]))
          : "memory");
  };
  if (threadIdx.x == 0)
    for (long long q = 0; q < S && q < nchunks; ++q) issue(q);
  for (long long q = 0; q < nchunks; ++q) {
    const long long j = seq + q;
    const int st = static_cast<int>(j % S);
    mbar_wait(&full[st], static_cast<int>((j / S) & 1));
    const long long k = chunk(q);
    const long long nr = min(static_cast<long long>(R), rows - k * R);
    const uint4* stage = ring + st * ni * ts;
    for (long long u = lane_r; u < nr; u += rpb) f(k * R + u, stage + u * ct_v + lane_c, ts);
    __syncthreads();
    if (threadIdx.x == 0 && q + S < nchunks) issue(q + S);
  }
  seq += static_cast<int>(nchunks);
}

// The rows a first stream_ring left in place (rows <= S * R, seq was 0).
template <typename F>
__device__ __forceinline__ void visit_resident(int ni, long long rows, int ct_v, int rpb, int R,
                                              const uint4* ring, F f) {
  const int lane_c = threadIdx.x % ct_v, lane_r = threadIdx.x / ct_v;
  const long long ts = static_cast<long long>(R) * ct_v;
  for (long long u = lane_r; u < rows; u += rpb) {
    const long long k = u / R;
    f(u, ring + k * ni * ts + (u - k * R) * ct_v + lane_c, ts);
  }
}

// Shared memory: red (blockDim * V) | part, tot (NS * Cp each) | coef (4 *
// Cp) floats | the ring (ring_bytes), Cp the channels rounded up to a
// multiple of 4 (the ring starts 16-byte aligned; Cp = C where a row fills
// 16-byte vectors). Every array holds true channels: folded rows are
// reduced to them in block_sums.
__host__ __device__ __forceinline__ int padded_channels(int channels) {
  return (channels + 3) / 4 * 4;
}

template <typename T>
__host__ __device__ __forceinline__ size_t cluster_smem(int threads, int ns, int channels,
                                                        int ring_bytes) {
  return sizeof(float) * (static_cast<size_t>(threads) * Vec<T>::n +
                          static_cast<size_t>(2 * ns + 4) * padded_channels(channels)) +
         static_cast<size_t>(ring_bytes);
}

// Forward: G * k clusters of cs CTAs, k clusters per group, each CTA a
// contiguous slab of its group's (super-)rows. NS = 2 (x) or 4 (x and the
// normalized shortcut).
template <typename T, int NS>
__global__ void __launch_bounds__(kClusterThreads, 1) cluster_fwd_kernel(ClusterArgs a) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const Slab s = slab_of(a, cluster);
  const int tid = threadIdx.x, C = a.channels, W = a.width, ct_v = a.ct_v;
  const int lane_c = tid % ct_v, Cp = padded_channels(C);
  const int old_gen = (a.k > 1 && tid == 0) ? load_acquire(a.sync + a.groups + s.g) : 0;
  float* red = smem;
  float* part = red + blockDim.x * V;
  float* tot = part + NS * Cp;
  float* coef = tot + NS * Cp;
  uint4* ring = reinterpret_cast<uint4*>(coef + 4 * Cp);
  const T* x = static_cast<const T*>(a.x);
  const T* sc = static_cast<const T*>(a.sc);
  const long long row0 = (static_cast<long long>(s.g) * a.n + s.r0) * W;
  const long long rows = s.r1 - s.r0;
  const char* src[2] = {reinterpret_cast<const char*>(x + row0),
                        a.sc_mode ? reinterpret_cast<const char*>(sc + row0) : nullptr};
  const int row_bytes = W * static_cast<int>(sizeof(T));
  // one stage count for both passes (the mbarriers' phases run on), sized
  // for pass 2, which streams as many tensors as pass 1 or more
  const int ni1 = NS / 2, ni2 = a.sc_mode ? 2 : 1;
  const int S = ring_stages(a, ni2, row_bytes);
  ring_init(full);
  int seq = 0;

  // pass 1: sums of x (and s) over this CTA's rows
  float acc[NS][V];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  stream_ring(src, ni1, rows, ct_v, a.rpb, a.ring_rows, S, ring, full, seq,
              [&](long long, const uint4* p, long long ts) {
#pragma unroll
                for (int i = 0; i < NS / 2; ++i) {
                  float v[V];
                  unpack16(p[i * ts], v, x);
#pragma unroll
                  for (int j = 0; j < V; ++j) {
                    acc[2 * i][j] += v[j];
                    acc[2 * i + 1][j] += v[j] * v[j];
                  }
                }
              });
  group_sums<NS, V>(acc, red, part, tot, a, s, cluster, old_gen);

  // the group's statistics; its first CTA publishes them
  for (int e = tid; e < C; e += blockDim.x) {
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      const float mu = tot[(2 * i) * C + e] * a.inv_n;
      const float var = tot[(2 * i + 1) * C + e] * a.inv_n - mu * mu;
      const float rs = rsqrtf(var + a.eps);
      coef[(2 * i) * C + e] = mu;
      coef[(2 * i + 1) * C + e] = rs;
      if (s.p == 0) {
        const long long gc = static_cast<long long>(s.g) * C + e;
        (i == 0 ? a.mean : a.sc_mean)[gc] = mu;
        (i == 0 ? a.rstd : a.sc_rstd)[gc] = rs;
        a.var[static_cast<long long>(i) * a.groups * C + gc] = var;
      }
    }
  }
  __threadfence();  // published before the ticket below
  __syncthreads();

  // the running update, by the last group to publish (an integer ticket);
  // none with null running statistics (a recomputed forward)
  if (s.p == 0 && a.run_mean != nullptr) {
    int* ticket = a.sync + 2 * a.groups;
    if (tid == 0) {
      __threadfence();
      last = atomicAdd(ticket, 1) == a.groups - 1;
    }
    __syncthreads();
    if (last) {
      __threadfence();
      for (int c = tid; c < C; c += blockDim.x) {
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) {
          float msum = 0.f, vsum = 0.f;
          for (int gg = 0; gg < a.groups; ++gg) {
            msum += __ldcg((i == 0 ? a.mean : a.sc_mean) + static_cast<long long>(gg) * C + c);
            vsum += __ldcg(a.var + (static_cast<long long>(i) * a.groups + gg) * C + c);
          }
          const float inv_g = 1.f / static_cast<float>(a.groups);
          float* rm = i == 0 ? a.run_mean : a.sc_run_mean;
          float* rv = i == 0 ? a.run_var : a.sc_run_var;
          rm[c] = a.mom * rm[c] + a.upd_mean * (msum * inv_g);
          rv[c] = a.mom * rv[c] + a.upd_var * (vsum * inv_g);
        }
      }
      if (tid == 0) atomicExch(ticket, 0);
    }
  }

  // pass 2: normalize with the epilogue, from the rows still in shared
  // memory or streamed again; element j of the lane's vector is channel
  // (lane_c * V + j) % C
  float mu[V], rs[V], smu[V], srs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = (lane_c * V + j) % C;
    mu[j] = coef[c];
    rs[j] = coef[C + c];
    smu[j] = NS == 4 ? coef[2 * C + c] : 0.f;
    srs[j] = NS == 4 ? coef[3 * C + c] : 0.f;
  }
  T* out = static_cast<T*>(a.out) + row0 + lane_c * V;
  auto normalize = [&](long long row, const uint4* p, long long ts) {
    float xv[V], sv[V], o[V];
    unpack16(p[0], xv, x);
    if (a.sc_mode != 0) unpack16(p[ts], sv, x);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (a.sc_mode == 0) {
        // without a shortcut the store rounds once: bn_out's rounding
        // before it changes no output and costs two conversions an element
        const float y = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
        o[j] = a.relu ? (y > relu_edge<T>() ? y : 0.f) : y;
      } else {
        const float y = bn_out<T>(xv[j], mu[j], rs[j], sv[j], smu[j], srs[j], a.sc_mode);
        o[j] = a.relu ? fmaxf(y, 0.f) : y;
      }
    }
    store16(out + row * W, o);
  };
  if (ni1 == ni2 && rows <= static_cast<long long>(S) * a.ring_rows)
    visit_resident(ni1, rows, ct_v, a.rpb, a.ring_rows, ring, normalize);
  else
    stream_ring<true>(src, ni2, rows, ct_v, a.rpb, a.ring_rows, S, ring, full, seq, normalize);
}

// Backward: the same geometry. NS = 2 (sum d, sum d*xhat) or 3 (and sum
// d*shat, normalized shortcut). Operands: x, dy, then (THIRD) s in mode 2
// or, for a raw shortcut under relu, the forward output.
template <typename T, int NS, bool THIRD>
__global__ void __launch_bounds__(kClusterThreads, 1) cluster_bwd_kernel(ClusterArgs a) {
  constexpr int V = Vec<T>::n;
  constexpr int NO = THIRD ? 3 : 2;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  cg::cluster_group cluster = cg::this_cluster();
  const Slab s = slab_of(a, cluster);
  const int tid = threadIdx.x, C = a.channels, W = a.width, ct_v = a.ct_v;
  const int lane_c = tid % ct_v, Cp = padded_channels(C);
  const int old_gen = (a.k > 1 && tid == 0) ? load_acquire(a.sync + a.groups + s.g) : 0;
  float* red = smem;
  float* part = red + blockDim.x * V;
  float* tot = part + NS * Cp;
  float* coef = tot + NS * Cp;
  uint4* ring = reinterpret_cast<uint4*>(coef + 4 * Cp);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* z = static_cast<const T*>(a.sc_mode == 2 ? a.sc : a.y);
  const long long row0 = (static_cast<long long>(s.g) * a.n + s.r0) * W;
  const long long rows = s.r1 - s.r0;
  const char* src[3] = {reinterpret_cast<const char*>(x + row0),
                        reinterpret_cast<const char*>(dy + row0),
                        THIRD ? reinterpret_cast<const char*>(z + row0) : nullptr};
  const int S = ring_stages(a, NO, W * static_cast<int>(sizeof(T)));
  ring_init(full);
  int seq = 0;

  // element j of the lane's vector is channel ch[j] = (lane_c * V + j) % C
  int ch[V];
  float mu[V], rs[V], smu[V], srs[V];
  const long long gc = static_cast<long long>(s.g) * C;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ch[j] = (lane_c * V + j) % C;
    mu[j] = a.mean[gc + ch[j]];
    rs[j] = a.rstd[gc + ch[j]];
    smu[j] = NS == 3 ? a.sc_mean[gc + ch[j]] : 0.f;
    srs[j] = NS == 3 ? a.sc_rstd[gc + ch[j]] : 0.f;
  }
  // d = dy where the forward's relu passed it
  auto grad_in = [&](const float* xv, const float* dv, const float* zv, float* d) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      bool pass = true;
      if (a.relu) {
        if (a.sc_mode == 1)
          pass = zv[j] > 0.f;
        else if (a.sc_mode == 0)  // bn_out's decision, without its conversions
          pass = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]) > relu_edge<T>();
        else
          pass = bn_out<T>(xv[j], mu[j], rs[j], zv[j], smu[j], srs[j], a.sc_mode) > 0.f;
      }
      d[j] = pass ? dv[j] : 0.f;
    }
  };

  float acc[NS][V];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  stream_ring(src, NO, rows, ct_v, a.rpb, a.ring_rows, S, ring, full, seq,
              [&](long long, const uint4* p, long long ts) {
                float xv[V], dv[V], zv[V] = {}, d[V];
                unpack16(p[0], xv, x);
                unpack16(p[ts], dv, x);
                if (THIRD) unpack16(p[(NO - 1) * ts], zv, x);
                grad_in(xv, dv, zv, d);
#pragma unroll
                for (int j = 0; j < V; ++j) {
                  acc[0][j] += d[j];
                  acc[1][j] += d[j] * ((xv[j] - mu[j]) * rs[j]);
                  if (NS == 3) acc[NS - 1][j] += d[j] * ((zv[j] - smu[j]) * srs[j]);
                }
              });
  group_sums<NS, V>(acc, red, part, tot, a, s, cluster, old_gen);
  for (int e = tid; e < NS * C; e += blockDim.x) coef[e] = tot[e] * a.inv_n;
  __syncthreads();

  float ca[V], cb[V], cbs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ca[j] = coef[ch[j]];
    cb[j] = coef[C + ch[j]];
    cbs[j] = NS == 3 ? coef[2 * C + ch[j]] : 0.f;
  }
  T* dx = static_cast<T*>(a.out) + row0 + lane_c * V;
  T* dsc = a.sc_mode ? static_cast<T*>(a.dsc) + row0 + lane_c * V : nullptr;
  auto grad_row = [&](long long row, const uint4* p, long long ts) {
    float xv[V], dv[V], zv[V] = {}, d[V], o[V];
    unpack16(p[0], xv, x);
    unpack16(p[ts], dv, x);
    if (THIRD) unpack16(p[(NO - 1) * ts], zv, x);
    grad_in(xv, dv, zv, d);
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = rs[j] * (d[j] - ca[j] - ((xv[j] - mu[j]) * rs[j]) * cb[j]);
    store16(dx + row * W, o);
    if (a.sc_mode == 1) {
      store16(dsc + row * W, d);
    } else if (NS == 3) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = srs[j] * (d[j] - ca[j] - ((zv[j] - smu[j]) * srs[j]) * cbs[j]);
      store16(dsc + row * W, o);
    }
  };
  if (rows <= static_cast<long long>(S) * a.ring_rows)
    visit_resident(NO, rows, ct_v, a.rpb, a.ring_rows, ring, grad_row);
  else
    stream_ring<true>(src, NO, rows, ct_v, a.rpb, a.ring_rows, S, ring, full, seq, grad_row);
}

// Clusters of `cs` CTAs of one kernel that fit on the current card at once,
// cached per (device, kernel, threads, shared memory, cs).
template <typename K>
cudaError_t cluster_capacity(K kernel, int threads, size_t smem, int* clusters) {
  struct Entry {
    int device, threads, clusters;
    const void* kernel;
    size_t smem;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.device == device && e.kernel == reinterpret_cast<const void*>(kernel) &&
        e.threads == threads && e.smem == smem) {
      *clusters = e.clusters;
      return cudaSuccess;
    }
  }
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const int dynamic_max = kSmemMax - static_cast<int>(fa.sharedSizeBytes);
  if (smem > static_cast<size_t>(dynamic_max)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_max);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterSize);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterSize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (used < 64)
    cache[used++] = {device, threads, *clusters, reinterpret_cast<const void*>(kernel), smem};
  return cudaSuccess;
}

// Launch G * k clusters of kClusterSize CTAs, all resident at once: k is
// the most clusters per group the card holds together (the group barrier
// waits on all of them), and no more than the group's rows give every
// CTA's row lanes one row. The launch is cooperative: CUDA refuses a
// grid that cannot be resident at once, and starts it only when it can (a
// kernel on another stream holding SMs delays it instead of leaving
// clusters unscheduled behind a barrier). ni: the most tensors one pass
// streams.
template <typename T, typename K>
int launch_cluster(K kernel, ClusterArgs a, int ns, int ni, long long gpart_floats,
                   cudaStream_t stream) {
  constexpr int cs = kClusterSize;
  const int threads = a.ct_v * a.rpb;
  const size_t smem = cluster_smem<T>(threads, ns, a.channels, a.ring_bytes);
  const long long chunk = static_cast<long long>(ni) * a.ring_rows * a.width * sizeof(T);
  if (threads > kClusterThreads || a.width != a.channels * a.fold ||
      a.ct_v * Vec<T>::n != a.width || (a.rpb & (a.rpb - 1)) ||
      a.ring_rows < 1 || a.ring_bytes < 2 * chunk || smem > static_cast<size_t>(kSmemMax) ||
      a.groups < 1 || a.n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int clusters = 0;
  cudaError_t err = cluster_capacity(kernel, threads, smem, &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long k = clusters / a.groups;
  const long long lanes = static_cast<long long>(cs) * a.rpb;
  k = std::min(k, (a.n + lanes - 1) / lanes);
  if (k < 1) return static_cast<int>(cudaErrorInvalidConfiguration);  // more groups than clusters fit
  if (k > 1 && static_cast<long long>(a.groups) * k * ns * a.channels > gpart_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  a.k = static_cast<int>(k);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.groups * k * cs));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cluster_forward(const ClusterArgs& a, long long gpart_floats, cudaStream_t stream) {
  const int ni = a.sc_mode ? 2 : 1;
  if (a.sc_mode == 2)
    return launch_cluster<T>(cluster_fwd_kernel<T, 4>, a, 4, ni, gpart_floats, stream);
  return launch_cluster<T>(cluster_fwd_kernel<T, 2>, a, 2, ni, gpart_floats, stream);
}

template <typename T>
int cluster_backward(const ClusterArgs& a, long long gpart_floats, cudaStream_t stream) {
  if (a.sc_mode == 2)
    return launch_cluster<T>(cluster_bwd_kernel<T, 3, true>, a, 3, 3, gpart_floats, stream);
  if (a.sc_mode == 1 && a.relu)
    return launch_cluster<T>(cluster_bwd_kernel<T, 2, true>, a, 2, 3, gpart_floats, stream);
  return launch_cluster<T>(cluster_bwd_kernel<T, 2, false>, a, 2, 2, gpart_floats, stream);
}

// ---------------------------------------------------------------------------
// head design: the 2-D calls, one launch per direction
// ---------------------------------------------------------------------------
//
// The (B, C) head inputs (EmbeddingHead's pre_bn and post_bn, ECAPA's) are
// short and wide: the bench step's pre_bn is (256, 10240), 5 MB a tensor in
// bf16, in 8 groups of 32 rows. The grid runs over channel tiles. A CTA
// owns `cl` lanes of V channels (a 16-byte vector; or one channel, where C
// does not fill enough 16-byte vectors or a tensor is off a 16-byte
// boundary: ops/nn.py:bn_head_plan) across all B rows, so across all G
// groups, and needs nothing from any
// other CTA: no scratch, no ticket, no barrier, no atomics. Its `rl` row
// lanes each own a slab of `slab` consecutive rows inside one group (slab
// divides n), so a group is rl / G consecutive row lanes. A thread issues
// its slab's loads before their first use and keeps them in registers, in
// rounds of kHeadRows rows (a slab of more rows, for a B past what a CTA
// holds, is read a second time, from L2); it sums its rows in order, the
// group's lanes add their sums in a fixed pairwise tree (warp shuffles
// within a warp, shared memory across warps), and every lane of the group
// then holds the group's statistics. The forward writes mean / rstd,
// normalizes from the registers and then applies the running update of
// the tile's channels in group order; the backward
// reads x and dy (and the normalized shortcut, or the forward output for a
// raw shortcut under relu), recomputes the relu decision from x as the
// cluster design does, sums, and writes dx (and the shortcut's gradient)
// from the registers. The statistics are the multi-kernel design's (mean =
// sum / n, var = sum(x^2) / n - mean^2, no Bessel factor at 2-D), the
// output and the relu decision the cluster design's (bn_out, relu_edge);
// reruns match bit for bit.
//
// What bounds it: latency more than bytes. It moves the bound's own count
// (x read and y written; x and dy read and dx written), but a call is a
// few MB: the launch, one DRAM round trip before the first sum and the
// tree cost as much as the transfer (42-55% of the bytes bound at the
// bench's pre_bn, PERF.md); at the small head calls ((256, 192): 98 KB a
// tensor) the launch and a thread's serial work alone. Hence a tile's
// geometry by measurement (bn_head_plan), two register budgets (below),
// and shuffles in the tree.

constexpr int kHeadThreads = 256;  // at most, per CTA
constexpr int kHeadRows = 8;       // rows a thread keeps in registers at once

struct HeadArgs {
  const void* x;
  const void* sc;    // shortcut (modes 1, 2); null otherwise
  const void* y;     // backward, mode 1 with relu: the forward output
  const void* dy;    // backward
  void* out;         // forward: y; backward: dx
  void* dsc;         // backward: the shortcut's gradient (modes 1, 2)
  float* mean;       // (G, C); forward writes, backward reads
  float* rstd;
  float* sc_mean;
  float* sc_rstd;
  float* run_mean;   // null: no running update
  float* run_var;
  float* sc_run_mean;
  float* sc_run_var;
  long long rows;    // B
  int groups, channels;
  int cl;            // channel lanes a CTA, V channels each
  int rl;            // row lanes a CTA, `slab` rows each
  int slab;
  int sc_mode, relu;
  float mom, upd_mean, upd_var, eps, inv_n;
};

// One lane's V channels of one row: a 16-byte vector kept raw (unpacked
// at use), or one element.
template <typename T, int V>
struct HeadLane {
  using Raw = typename std::conditional<V == 1, float, uint4>::type;
  static __device__ __forceinline__ Raw load(const T* p) {
    if constexpr (V == 1)
      return vsv::to_f(*p);
    else
      return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* v) {
    if constexpr (V == 1)
      v[0] = r;
    else
      unpack16(r, v, static_cast<const T*>(nullptr));
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    if constexpr (V == 1)
      *p = vsv::from_f<T>(v[0]);
    else
      store16(p, v);
  }
};

// Each group's sums of acc[k][.] (NS quantities, V channels) over its L
// row lanes (consecutive: row lane lr is in group lr / L), by a fixed
// pairwise tree: lane i of a group adds lane i + s where i % 2s == 0, s =
// 1, 2, 4, ... The totals come back in acc, in every lane of the group.
// Where L is a power of two (and the CTA whole warps), the steps whose
// partner lies in the same warp (s * cl < 32) run as a butterfly of
// shuffles, which forms the same sums in the same order in every lane (a
// + b == b + a), and only the steps across warps go through red (NS * V *
// blockDim floats, free again on return): none where a group's lanes
// share a warp.
template <int NS, int V>
__device__ __forceinline__ void head_group_sums(float (*acc)[V], float* red, int cl, int L) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int i = (tid / cl) % L;
  int s = 1;
  if ((L & (L - 1)) == 0 && nt % 32 == 0) {  // the same in every thread
    for (; s < L && s * cl < 32; s *= 2)
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[k][j] += __shfl_xor_sync(0xffffffffu, acc[k][j], s * cl);
    if (s >= L) return;
  }
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) red[(k * V + j) * nt + tid] = acc[k][j];
  __syncthreads();
  for (; s < L; s *= 2) {
    if (i % (2 * s) == 0 && i + s < L)
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j)
          red[(k * V + j) * nt + tid] += red[(k * V + j) * nt + tid + s * cl];
    __syncthreads();
  }
  const int lead = tid - i * cl;  // the group's first row lane, this channel lane
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = red[(k * V + j) * nt + lead];
  __syncthreads();
}

// Forward. NS = 2 (x) or 4 (x and the normalized shortcut).
template <typename T, int V, int NS, int MINB>
__global__ void __launch_bounds__(kHeadThreads, MINB) head_fwd_kernel(HeadArgs a) {
  using Lane = HeadLane<T, V>;
  constexpr int R = kHeadRows;
  extern __shared__ float red[];
  const int tid = threadIdx.x, nt = blockDim.x, cl = a.cl, C = a.channels, S = a.slab;
  const int lc = tid % cl, lr = tid / cl, L = a.rl / a.groups, g = lr / L;
  const int c0 = (blockIdx.x * cl + lc) * V;  // the lane's first channel
  const bool on = c0 < C;                     // the last tile may be ragged
  const bool lead = lr % L == 0;              // the group's first row lane
  const bool upd = a.run_mean != nullptr;     // the same in every thread
  const long long base = static_cast<long long>(lr) * S * C + c0;
  const T* x = static_cast<const T*>(a.x);
  const T* sc = static_cast<const T*>(a.sc);
  T* out = static_cast<T*>(a.out);
  const int rounds = (S + R - 1) / R;
  const bool keep = rounds == 1;  // the slab stays in registers

  typename Lane::Raw xr[R], sr[R];
  auto load = [&](int q, bool with_sc) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = q * R + k;
      if (on && r < S) {
        xr[k] = Lane::load(x + base + static_cast<long long>(r) * C);
        if (with_sc) sr[k] = Lane::load(sc + base + static_cast<long long>(r) * C);
      }
    }
  };

  // sums of x (and s) over the slab, in row order
  float acc[NS][V];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  for (int q = 0; q < rounds; ++q) {
    load(q, a.sc_mode != 0 && (NS == 4 || keep));
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (on && q * R + k < S) {
        float v[V];
        Lane::unpack(xr[k], v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[0][j] += v[j];
          acc[1][j] += v[j] * v[j];
        }
        if constexpr (NS == 4) {
          Lane::unpack(sr[k], v);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            acc[2][j] += v[j];
            acc[3][j] += v[j] * v[j];
          }
        }
      }
    }
  }
  head_group_sums<NS, V>(acc, red, cl, L);

  // the group's statistics (acc keeps each one's mean and variance for the
  // running update); its first row lane publishes them
  float mu[V], rs[V], smu[V] = {}, srs[V] = {};
#pragma unroll
  for (int i = 0; i < NS / 2; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float m = acc[2 * i][j] * a.inv_n;
      const float var = acc[2 * i + 1][j] * a.inv_n - m * m;
      (i == 0 ? mu : smu)[j] = m;
      (i == 0 ? rs : srs)[j] = rsqrtf(var + a.eps);
      acc[2 * i][j] = m;
      acc[2 * i + 1][j] = var;
    }
  if (on && lead) {
    const long long gc = static_cast<long long>(g) * C + c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a.mean[gc + j] = mu[j];
      a.rstd[gc + j] = rs[j];
      if constexpr (NS == 4) {
        a.sc_mean[gc + j] = smu[j];
        a.sc_rstd[gc + j] = srs[j];
      }
    }
  }

  if (upd && lead)  // the groups' (mean, var), for the running update below
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) red[(k * V + j) * nt + tid] = acc[k][j];

  // normalize with the epilogue, from the registers (or the slab read again)
  for (int q = 0; q < rounds; ++q) {
    if (!keep) load(q, a.sc_mode != 0);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = q * R + k;
      if (on && r < S) {
        float xv[V], sv[V] = {}, o[V];
        Lane::unpack(xr[k], xv);
        if (a.sc_mode != 0) Lane::unpack(sr[k], sv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (a.sc_mode == 0) {
            // the store rounds once, as in the cluster design
            const float y = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
            o[j] = a.relu ? (y > relu_edge<T>() ? y : 0.f) : y;
          } else {
            const float y = bn_out<T>(xv[j], mu[j], rs[j], sv[j], smu[j], srs[j], a.sc_mode);
            o[j] = a.relu ? fmaxf(y, 0.f) : y;
          }
        }
        Lane::store(out + base + static_cast<long long>(r) * C, o);
      }
    }
  }

  // the running update of the tile's channels, once the stores are on
  // their way: cl * V * NS / 2 tasks, task u (input u / (cl * V), channel
  // lane l, element j) adding the groups' (mean, var) in group order
  if (upd) {
    __syncthreads();
    const float inv_g = 1.f / static_cast<float>(a.groups);
    for (int u = tid; u < cl * V * (NS / 2); u += nt) {
      const int i = u / (cl * V), l = (u % (cl * V)) / V, j = u % V;
      const int c = (static_cast<int>(blockIdx.x) * cl + l) * V + j;
      if (c >= C) continue;
      float msum = 0.f, vsum = 0.f;
      for (int gg = 0; gg < a.groups; ++gg) {
        const int from = gg * L * cl + l;  // group gg's first row lane
        msum += red[((2 * i) * V + j) * nt + from];
        vsum += red[((2 * i + 1) * V + j) * nt + from];
      }
      float* rm = i == 0 ? a.run_mean : a.sc_run_mean;
      float* rv = i == 0 ? a.run_var : a.sc_run_var;
      rm[c] = a.mom * rm[c] + a.upd_mean * (msum * inv_g);
      rv[c] = a.mom * rv[c] + a.upd_var * (vsum * inv_g);
    }
  }
}

// Backward. NS = 2 (sum d, sum d*xhat) or 3 (and sum d*shat, normalized
// shortcut). Operands: x, dy, then (THIRD) s in mode 2 or, for a raw
// shortcut under relu, the forward output.
template <typename T, int V, int NS, bool THIRD, int MINB>
__global__ void __launch_bounds__(kHeadThreads, MINB) head_bwd_kernel(HeadArgs a) {
  using Lane = HeadLane<T, V>;
  constexpr int R = kHeadRows;
  extern __shared__ float red[];
  const int tid = threadIdx.x, cl = a.cl, C = a.channels, S = a.slab;
  const int lc = tid % cl, lr = tid / cl, L = a.rl / a.groups, g = lr / L;
  const int c0 = (blockIdx.x * cl + lc) * V;
  const bool on = c0 < C;
  const long long base = static_cast<long long>(lr) * S * C + c0;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* z = static_cast<const T*>(a.sc_mode == 2 ? a.sc : a.y);
  const int rounds = (S + R - 1) / R;
  const bool keep = rounds == 1;

  typename Lane::Raw xr[R], dr[R], zr[R];
  auto load = [&](int q) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = q * R + k;
      if (on && r < S) {
        const long long e = base + static_cast<long long>(r) * C;
        xr[k] = Lane::load(x + e);
        dr[k] = Lane::load(dy + e);
        if (THIRD) zr[k] = Lane::load(z + e);
      }
    }
  };
  float mu[V] = {}, rs[V] = {}, smu[V] = {}, srs[V] = {};
  if (on) {
    const long long gc = static_cast<long long>(g) * C + c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mu[j] = a.mean[gc + j];
      rs[j] = a.rstd[gc + j];
      if (NS == 3) {
        smu[j] = a.sc_mean[gc + j];
        srs[j] = a.sc_rstd[gc + j];
      }
    }
  }
  // row k of the registers: x (and z) unpacked, and d = dy where the
  // forward's relu passed it
  auto grad_in = [&](int k, float* xv, float* zv, float* d) {
    float dv[V];
    Lane::unpack(xr[k], xv);
    Lane::unpack(dr[k], dv);
    if (THIRD) Lane::unpack(zr[k], zv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      bool pass = true;
      if (a.relu) {
        if (a.sc_mode == 1)
          pass = zv[j] > 0.f;
        else if (a.sc_mode == 0)  // bn_out's decision, without its conversions
          pass = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]) > relu_edge<T>();
        else
          pass = bn_out<T>(xv[j], mu[j], rs[j], zv[j], smu[j], srs[j], a.sc_mode) > 0.f;
      }
      d[j] = pass ? dv[j] : 0.f;
    }
  };

  float acc[NS][V];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  for (int q = 0; q < rounds; ++q) {
    load(q);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (on && q * R + k < S) {
        float xv[V], zv[V] = {}, d[V];
        grad_in(k, xv, zv, d);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[0][j] += d[j];
          acc[1][j] += d[j] * ((xv[j] - mu[j]) * rs[j]);
          if (NS == 3) acc[NS - 1][j] += d[j] * ((zv[j] - smu[j]) * srs[j]);
        }
      }
    }
  }
  head_group_sums<NS, V>(acc, red, cl, L);
  float ca[V], cb[V], cbs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ca[j] = acc[0][j] * a.inv_n;
    cb[j] = acc[1][j] * a.inv_n;
    cbs[j] = NS == 3 ? acc[NS - 1][j] * a.inv_n : 0.f;
  }

  T* dx = static_cast<T*>(a.out);
  T* dsc = static_cast<T*>(a.dsc);
  for (int q = 0; q < rounds; ++q) {
    if (!keep) load(q);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = q * R + k;
      if (on && r < S) {
        const long long e = base + static_cast<long long>(r) * C;
        float xv[V], zv[V] = {}, d[V], o[V];
        grad_in(k, xv, zv, d);
#pragma unroll
        for (int j = 0; j < V; ++j)
          o[j] = rs[j] * (d[j] - ca[j] - ((xv[j] - mu[j]) * rs[j]) * cb[j]);
        Lane::store(dx + e, o);
        if (a.sc_mode == 1) {
          Lane::store(dsc + e, d);
        } else if (NS == 3) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            o[j] = srs[j] * (d[j] - ca[j] - ((zv[j] - smu[j]) * srs[j]) * cbs[j]);
          Lane::store(dsc + e, o);
        }
      }
    }
  }
}

// One CTA a tile of cl channel lanes, cl * rl threads, ns * V floats of
// shared memory a thread for the tree. Refuses a geometry whose slabs do
// not cover the B rows inside the groups, and tensors off a 16-byte
// boundary for vector lanes.
template <typename T, int V, typename K>
int head_launch(K kernel, const HeadArgs& a, int ns, cudaStream_t stream) {
  const long long threads = static_cast<long long>(a.cl) * a.rl;
  const void* ptrs[6] = {a.x, a.sc, a.y, a.dy, a.out, a.dsc};
  for (const void* p : ptrs)
    if (V > 1 && reinterpret_cast<uintptr_t>(p) % 16) return vsv::kShapeUnsupported;
  if (a.groups < 1 || a.cl < 1 || a.rl < 1 || a.slab < 1 || threads > kHeadThreads ||
      a.rows % a.groups || static_cast<long long>(a.rl) * a.slab != a.rows ||
      (a.rows / a.groups) % a.slab || a.channels < 1 || a.channels % V)
    return vsv::kShapeUnsupported;
  const int lanes = a.channels / V;
  const unsigned grid = static_cast<unsigned>((lanes + a.cl - 1) / a.cl);
  const size_t smem = sizeof(float) * ns * V * threads;  // at most 32 KB
  kernel<<<grid, static_cast<unsigned>(threads), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The heads' own variants (no normalized shortcut, two operands) come
// twice: for CTAs of more than 128 threads, built for two CTAs an SM (128
// registers a thread), and for smaller CTAs, with the registers the
// compiler wants (several CTAs an SM all the same); the variants with a
// third operand once, for one CTA an SM.
template <typename T, int V>
int head_forward(const HeadArgs& a, cudaStream_t s) {
  if (a.sc_mode == 2) return head_launch<T, V>(head_fwd_kernel<T, V, 4, 1>, a, 4, s);
  if (a.cl * a.rl > kHeadThreads / 2)
    return head_launch<T, V>(head_fwd_kernel<T, V, 2, 2>, a, 2, s);
  return head_launch<T, V>(head_fwd_kernel<T, V, 2, 1>, a, 2, s);
}

template <typename T, int V>
int head_backward(const HeadArgs& a, cudaStream_t s) {
  if (a.sc_mode == 2) return head_launch<T, V>(head_bwd_kernel<T, V, 3, true, 1>, a, 3, s);
  if (a.sc_mode == 1 && a.relu)
    return head_launch<T, V>(head_bwd_kernel<T, V, 2, true, 1>, a, 2, s);
  if (a.cl * a.rl > kHeadThreads / 2)
    return head_launch<T, V>(head_bwd_kernel<T, V, 2, false, 2>, a, 2, s);
  return head_launch<T, V>(head_bwd_kernel<T, V, 2, false, 1>, a, 2, s);
}

// ---------------------------------------------------------------------------
// spanning mode: BN groups that span the data ranks of a process group
// ---------------------------------------------------------------------------
//
// Each rank holds nloc consecutive global rows from `offset`; group g is
// global rows [g * ngroup, (g + 1) * ngroup), whatever the alignment of
// groups to ranks, and its statistics are those of its rows on every rank.
// A BN call is four launches, one a phase; the caller all-reduces the
// rank's partial sums over the data ranks (torch.distributed) between the
// first two and between the last two:
//
//   span_stats       the rank's sum(x), sum(x^2) [and the normalized
//                    shortcut's] per (group, channel)
//   span_normalize   mean/rstd from the global sums (each CTA for its own
//                    group; CTA 0 also writes them all and applies the
//                    running update), then y with the epilogue
//   span_bwd_reduce  sum(d), sum(d * xhat) [, sum(d * shat)]
//   span_bwd_grad    dx [and the shortcut's gradient] from the global sums
//
// The first design ran the multi-kernel design's passes over the
// rank's rows: 8 kernels a call, the partials through HBM twice, y saved
// for the backward (x, y, dy read twice: 10 units of one activation a
// call), 8-byte bf16 accesses. This one is written for Hopper as the
// cluster design is (bn_cluster_*), without its group barrier, which the
// all-reduce replaces:
// - Persistent CTAs, one wave (one CTA an SM at ~220 KB of shared memory).
//   The plan (ops/nn.py:bn_span_plan) cuts the rank's rows into one slab a
//   CTA, never across a group boundary, at full channel width, and passes
//   the slabs as a table. A CTA streams its slab through a ring of chunks
//   in shared memory filled by 1-D bulk copies (the Tensor Memory
//   Accelerator) on mbarriers, 16-byte accesses. Each warp releases a
//   stage when it is done with it and the last one refills it: no
//   block-wide barrier a chunk.
// - Reductions: a fixed tree over the CTA's row lanes, the CTAs' partials
//   to global scratch, and the last CTA to arrive (an integer ticket with
//   fences; no float atomics) adds them in CTA order, eight loads in flight
//   a lane, into the (G, ns, C) sums that the all-reduce takes, zero for
//   groups the rank does not touch.
// - No finalize launch: the launch after the all-reduce derives its
//   coefficients from the global sums (G x C floats).
// - The backward takes no y: the relu decision is recomputed from x (and
//   a normalized shortcut) with the forward's exact arithmetic; only a raw
//   shortcut under relu reads the forward output in its place. Without a
//   shortcut the decision is xhat > relu_edge, which needs no conversion
//   to bf16 and back (conversions run at a fraction of the FMA rate: with
//   one an element the backward reduce was compute-bound). The backward
//   moves x and dy twice and dx once: 5 units (7 before), 8 a call with
//   the forward's 3.
// - The launches after an all-reduce walk each slab from its end: the
//   tail, read last by the launch before, is what is still in L2 (50 MB),
//   which at a real spanning shape (tens of MB an activation) is most of
//   it.
// Where the ring does not apply (channels that do not fill 16-byte vectors,
// more than 512 vectors a row, unaligned rows) the same launches load
// directly from global memory in channel tiles (the "direct" design), as
// 16-byte vectors where the row allows, else single channels.
// Sums run in a fixed order: reruns agree bit for bit; the all-reduce's
// order is NCCL's.

constexpr int kSpanThreads = 512;

template <typename T> struct Tag { using type = T; };

// The plan's scalars, as ops/nn.py:bn_span_plan passes them (ints in this
// order): ring design or direct, elements a vector, vectors a tile, row
// lanes, channel tiles, the ring's rows a chunk (for this launch's tensor
// count) and bytes, CTAs, groups touched, dynamic shared memory.
struct SpanPlan {
  int ring, vec, ct, rpb, tiles, ring_rows, ring_bytes, ncta, touched, smem;
};

struct SpanArgs {
  const void* x;
  const void* z;      // forward: the shortcut; backward: the shortcut (mode 2) or y (mode 1, relu)
  const void* dy;
  void* out;          // y or dx
  void* dsc;          // the shortcut's gradient (modes 1, 2)
  const float* sums;  // global sums: forward (G, 2, C) of x; backward (G, NS, C)
  const float* sc_sums;
  float* mean;        // (G, C): written by the normalize launch, read by the backward
  float* rstd;
  float* sc_mean;
  float* sc_rstd;
  float* run_mean;
  float* run_var;
  float* sc_run_mean;
  float* sc_run_var;
  float* gpart;       // (ncta, NS, cw) the CTAs' partials
  float* sums_out;    // the rank's sums: forward (NI, G, 2, C), backward (G, NS, C)
  int* ticket;        // zero before the launch; left zero
  const long long* table;  // ncta x (group, lo, hi, tile), then touched x (group, first CTA, k)
  int groups, channels, ncta, touched, tiles, ct, rpb, cw, ring_rows, ring_bytes;
  int sc_mode, relu;
  float mom, upd_mean, upd_var, eps, inv_n;
};

// This CTA's slab: rows [lo, hi) of the rank, inside group g; channel tile.
struct SpanCta {
  int g, tile;
  long long lo, hi;
};

__device__ __forceinline__ SpanCta span_cta(const SpanArgs& a) {
  const long long* e = a.table + 4LL * blockIdx.x;
  return SpanCta{static_cast<int>(e[0]), static_cast<int>(e[3]), e[1], e[2]};
}

// mean, biased variance and rstd of one (group, channel) from its sums, with
// explicitly rounded operations: the normalize launch's CTAs and the
// statistics it publishes for the backward agree bit for bit.
__device__ __forceinline__ void span_moments(float s, float q, float inv_n, float eps,
                                             float& mu, float& var, float& rs) {
  mu = __fmul_rn(s, inv_n);
  var = __fsub_rn(__fmul_rn(q, inv_n), __fmul_rn(mu, mu));
  rs = rsqrtf(__fadd_rn(var, eps));
}

template <typename T, int V>
__device__ __forceinline__ void span_load(const T* p, float* v) {
  if constexpr (V == 1)
    v[0] = vsv::to_f(p[0]);
  else
    unpack16(__ldg(reinterpret_cast<const uint4*>(p)), v, p);
}

template <typename T, int V>
__device__ __forceinline__ void span_store(T* p, const float* v) {
  if constexpr (V == 1)
    p[0] = vsv::from_f<T>(v[0]);
  else
    store16(p, v);
}

// Rows [0, rows) of NI tensors (from src[i], rows of ct 16-byte vectors)
// through the ring of S chunks of R rows: every thread calls f(row, v) for
// rows lane_r, lane_r + rpb, ... of each chunk (v[i] its unpacked vector of
// tensor i) as soon as the chunk's mbarrier says it landed. No block-wide
// barrier a chunk: each warp counts itself done with a stage (done[], in
// shared memory), and the last warp to finish it refills it with the chunk
// S later by bulk copies (the Tensor Memory Accelerator), so warps run up
// to S - 1 chunks apart. REVERSE takes the chunks, and the rows in each,
// from the last. The caller synchronizes the block before reusing the ring.
template <typename T, int NI, bool REVERSE, typename F>
__device__ __forceinline__ void span_ring(const char* const* src, long long rows, int ct, int rpb,
                                          int R, int S, uint4* ring, uint64_t* full, int* done,
                                          F f) {
  constexpr int V = Vec<T>::n;
  const int lane_c = threadIdx.x % ct, lane_r = threadIdx.x / ct;
  const int warps = (blockDim.x + 31) / 32;
  const long long row_bytes = 16LL * ct;
  const long long nchunks = (rows + R - 1) / R;
  const long long ts = static_cast<long long>(R) * ct;  // vectors of one tensor's chunk
  auto chunk = [&](long long q) { return REVERSE ? nchunks - 1 - q : q; };
  auto issue = [&](long long q) {
    const long long k = chunk(q);
    const int st = static_cast<int>(q % S);
    const long long nr = min(static_cast<long long>(R), rows - k * R);
    const uint32_t bytes = static_cast<uint32_t>(nr * row_bytes);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(&full[st])),
                 "r"(bytes * NI)
                 : "memory");
#pragma unroll
    for (int i = 0; i < NI; ++i)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_u32(ring + (st * NI + i) * ts)),
          "l"(src[i] + k * R * row_bytes), "r"(bytes), "r"(smem_u32(&full[st]))
          : "memory");
  };
  if (threadIdx.x == 0)
    for (long long q = 0; q < S && q < nchunks; ++q) issue(q);
  for (long long q = 0; q < nchunks; ++q) {
    const int st = static_cast<int>(q % S);
    mbar_wait(&full[st], static_cast<int>((q / S) & 1));
    const long long k = chunk(q);
    const long long nr = min(static_cast<long long>(R), rows - k * R);
    const uint4* stage = ring + st * NI * ts;
#pragma unroll 2
    for (long long w = lane_r; w < nr; w += rpb) {
      const long long u = REVERSE ? nr - 1 - w : w;
      float v[NI][V];
#pragma unroll
      for (int i = 0; i < NI; ++i)
        unpack16(stage[i * ts + u * ct + lane_c], v[i], static_cast<const T*>(nullptr));
      f(k * R + u, v);
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      __threadfence_block();  // this warp's reads of the stage, before its refill
      if (atomicAdd(&done[st], 1) == warps - 1) {
        done[st] = 0;
        if (q + S < nchunks) issue(q + S);
      }
    }
  }
}

// The ring's mbarriers (one arrival each) and stage counters, before any use.
__device__ __forceinline__ void span_ring_init(uint64_t* full, int* done) {
  if (threadIdx.x < kMaxStages) done[threadIdx.x] = 0;
  ring_init(full);
}

// The same walk from global memory (the direct design): channels c0 +
// lane_c * V .. + V - 1 of each row, lanes past the tile's ctv vectors idle.
template <typename T, int V, int NI, bool REVERSE, typename F>
__device__ __forceinline__ void span_direct(const T* const* src, long long rows, int channels,
                                            int c0, int ctv, int ct, int rpb, F f) {
  const int lane_c = threadIdx.x % ct, lane_r = threadIdx.x / ct;
  if (lane_c >= ctv) return;
  const long long off = c0 + static_cast<long long>(lane_c) * V;
  for (long long w = lane_r; w < rows; w += rpb) {
    const long long u = REVERSE ? rows - 1 - w : w;
    float v[NI][V];
#pragma unroll
    for (int i = 0; i < NI; ++i) span_load<T, V>(src[i] + u * channels + off, v[i]);
    f(u, v);
  }
}

// This CTA's slab of NI tensors (ops[i], rank rows of C channels) in
// either design; f(row of the slab, v).
template <typename T, int V, bool RING, int NI, bool REVERSE, typename F>
__device__ __forceinline__ void span_walk(const SpanArgs& a, const SpanCta& e,
                                          const void* const* ops, uint4* ring, uint64_t* full,
                                          int* done, F f) {
  const int C = a.channels;
  const long long rows = e.hi - e.lo;
  if constexpr (RING) {
    const char* src[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      src[i] = reinterpret_cast<const char*>(static_cast<const T*>(ops[i]) + e.lo * C);
    const int s = a.ring_bytes / (NI * a.ring_rows * C * static_cast<int>(sizeof(T)));
    span_ring<T, NI, REVERSE>(src, rows, a.ct, a.rpb, a.ring_rows, s < kMaxStages ? s : kMaxStages,
                              ring, full, done, f);
  } else {
    const T* src[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) src[i] = static_cast<const T*>(ops[i]) + e.lo * C;
    const int c0 = e.tile * a.cw;
    const int ctv = min(a.ct, (C - c0) / V);
    span_direct<T, V, NI, REVERSE>(src, rows, C, c0, ctv, a.ct, a.rpb, f);
  }
}

// The lane's channels and whether it has any: c0 = the first.
__device__ __forceinline__ bool span_lane(const SpanArgs& a, const SpanCta& e, int V, int& c0) {
  const int lane_c = threadIdx.x % a.ct;
  c0 = e.tile * a.cw + lane_c * V;
  return c0 < a.channels;
}

// acc[k][.] summed over the CTA's row lanes (a fixed pairwise tree; rpb a
// power of two) into gp[k * cw + lane_c * V + j]; red holds blockDim * V floats.
template <int NS, int V>
__device__ __forceinline__ void span_partials(float (*acc)[V], float* red, float* gp, int ct,
                                              int rpb, int cw) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane_c = tid % ct, lane_r = tid / ct;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[j * nt + tid] = acc[k][j];
    __syncthreads();
    for (int s = rpb / 2; s > 0; s /= 2) {
      if (lane_r < s)
#pragma unroll
        for (int j = 0; j < V; ++j) red[j * nt + tid] += red[j * nt + tid + s * ct];
      __syncthreads();
    }
    if (lane_r == 0)
#pragma unroll
      for (int j = 0; j < V; ++j) gp[k * cw + lane_c * V + j] = red[j * nt + tid];
    __syncthreads();
  }
}

// After every CTA wrote its partials: the last CTA to arrive (an integer
// ticket with fences) adds them per (group, sum, channel) in CTA order into
// the rank's sums, zero for the groups it holds no row of, and resets the
// ticket. Up to 32 lanes (a power of two) share one sum, each taking every
// sub-th CTA in order, joined by a fixed shuffle tree. FWD: sums (NS / 2,
// G, 2, C), x's then the shortcut's; else (G, NS, C).
template <int NS, bool FWD>
__device__ __forceinline__ void span_collapse(const SpanArgs& a) {
  __shared__ int last;
  __threadfence();  // this thread's partials, before the ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1) == a.ncta - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long* segs = a.table + 4LL * a.ncta;
  const int g0 = static_cast<int>(segs[0]);
  const int C = a.channels, nt = blockDim.x, per_group = NS * C;
  auto dst = [&](int g, int k, int c) {
    return FWD ? ((static_cast<long long>(k / 2) * a.groups + g) * 2 + k % 2) * C + c
               : (static_cast<long long>(g) * NS + k) * C + c;
  };
  // zero for the groups this rank holds no row of
  for (int e = threadIdx.x; e < a.groups * per_group; e += nt) {
    const int g = e / per_group;
    if (g < g0 || g >= g0 + a.touched) a.sums_out[dst(g, (e / C) % NS, e % C)] = 0.f;
  }
  const int busy = a.touched * per_group;
  int sub = 1;  // lanes a sum: whole warps only, as the shuffles need them
  while (sub < 32 && nt % 32 == 0 && busy * sub * 2 <= nt) sub *= 2;
  const int q = threadIdx.x % sub, per = nt / sub;
  const long long step = static_cast<long long>(NS) * a.cw;
  for (int base = 0; base < busy; base += per) {
    const int e = base + threadIdx.x / sub;
    const bool in = e < busy;
    const int z = in ? e / per_group : 0, k = (e / C) % NS, c = e % C;
    const long long first = segs[3 * z + 1];
    const int kz = in ? static_cast<int>(segs[3 * z + 2]) : 0;
    const int t = c / a.cw;
    const float* p = a.gpart + k * a.cw + (c - t * a.cw) + (first + t) * step;
    const long long jstep = static_cast<long long>(a.tiles) * step;  // the next slab's CTA
    // eight loads in flight, added in CTA order
    float v = 0.f;
    int j = q;
    for (; j + 7 * sub < kz; j += 8 * sub) {
      float w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = __ldcg(p + (j + u * sub) * jstep);
#pragma unroll
      for (int u = 0; u < 8; ++u) v += w[u];
    }
    for (; j < kz; j += sub) v += __ldcg(p + j * jstep);
    for (int o = sub / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (in && q == 0) a.sums_out[dst(static_cast<int>(segs[3 * z]), k, c)] = v;
  }
  if (threadIdx.x == 0) atomicExch(a.ticket, 0);
}

// Statistics: sum(x), sum(x^2) [, of the shortcut] (NI tensors).
template <typename T, int V, bool RING, int NI>
__global__ void __launch_bounds__(kSpanThreads) span_stats_kernel(SpanArgs a) {
  constexpr int NS = 2 * NI;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int done[kMaxStages];
  const SpanCta e = span_cta(a);
  float* red = smem;
  uint4* ring = reinterpret_cast<uint4*>(smem + blockDim.x * V);
  if constexpr (RING) span_ring_init(full, done);
  float acc[NS][V];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  const void* ops[2] = {a.x, a.z};
  span_walk<T, V, RING, NI, false>(a, e, ops, ring, full, done, [&](long long, auto& v) {
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[2 * i][j] += v[i][j];
        acc[2 * i + 1][j] += v[i][j] * v[i][j];
      }
  });
  span_partials<NS, V>(acc, red, a.gpart + static_cast<long long>(blockIdx.x) * NS * a.cw, a.ct,
                       a.rpb, a.cw);
  span_collapse<NS, true>(a);
}

// CTA 0 of the normalize launch: every group's (mean, rstd) [and the
// shortcut's] for the backward, and the running update (none with null
// running statistics) with the mean over groups, in group order.
__device__ __forceinline__ void span_publish(const SpanArgs& a) {
  const int C = a.channels, G = a.groups;
  const float inv_g = 1.f / static_cast<float>(G);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int i = 0; i < (a.sc_mode == 2 ? 2 : 1); ++i) {
      const float* s = i == 0 ? a.sums : a.sc_sums;
      float* mean = i == 0 ? a.mean : a.sc_mean;
      float* rstd = i == 0 ? a.rstd : a.sc_rstd;
      float msum = 0.f, vsum = 0.f;
      for (int g = 0; g < G; ++g) {
        float mu, var, rs;
        span_moments(s[(2LL * g) * C + c], s[(2LL * g + 1) * C + c], a.inv_n, a.eps, mu, var, rs);
        mean[static_cast<long long>(g) * C + c] = mu;
        rstd[static_cast<long long>(g) * C + c] = rs;
        msum += mu;
        vsum += var;
      }
      float* rm = i == 0 ? a.run_mean : a.sc_run_mean;
      float* rv = i == 0 ? a.run_var : a.sc_run_var;
      if (rm != nullptr) {
        rm[c] = a.mom * rm[c] + a.upd_mean * (msum * inv_g);
        rv[c] = a.mom * rv[c] + a.upd_var * (vsum * inv_g);
      }
    }
  }
}

// Normalize with the epilogue; NI = 2 streams the shortcut too (modes 1, 2).
template <typename T, int V, bool RING, int NI>
__global__ void __launch_bounds__(kSpanThreads) span_normalize_kernel(SpanArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int done[kMaxStages];
  const SpanCta e = span_cta(a);
  uint4* ring = reinterpret_cast<uint4*>(smem + blockDim.x * V);
  if constexpr (RING) span_ring_init(full, done);
  if (blockIdx.x == 0) span_publish(a);
  const int C = a.channels;
  int c0 = 0;
  const bool lane = span_lane(a, e, V, c0);
  float mu[V], rs[V], smu[V], srs[V], var;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = rs[j] = smu[j] = srs[j] = 0.f;
    if (!lane) continue;
    const long long s = 2LL * e.g * C + c0 + j;
    span_moments(a.sums[s], a.sums[s + C], a.inv_n, a.eps, mu[j], var, rs[j]);
    if (a.sc_mode == 2) span_moments(a.sc_sums[s], a.sc_sums[s + C], a.inv_n, a.eps, smu[j], var, srs[j]);
  }
  T* out = static_cast<T*>(a.out) + e.lo * C + c0;
  const void* ops[2] = {a.x, a.z};
  span_walk<T, V, RING, NI, true>(a, e, ops, ring, full, done, [&](long long row, auto& v) {
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      // no shortcut: the store rounds once (bn_out's rounding before it
      // changes nothing and costs a conversion an element)
      const float y = NI == 1 ? __fmul_rn(__fsub_rn(v[0][j], mu[j]), rs[j])
                              : bn_out<T>(v[0][j], mu[j], rs[j], v[NI - 1][j], smu[j], srs[j],
                                          a.sc_mode);
      o[j] = a.relu ? fmaxf(y, 0.f) : y;
    }
    span_store<T, V>(out + row * C, o);
  });
}

// The lane's (mean, rstd) [and the shortcut's] of group g from the
// statistics the normalize launch published.
template <int V>
__device__ __forceinline__ void span_stats_of(const SpanArgs& a, int g, int c0, bool lane,
                                              float* mu, float* rs, float* smu, float* srs) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long s = static_cast<long long>(g) * a.channels + c0 + j;
    mu[j] = lane ? a.mean[s] : 0.f;
    rs[j] = lane ? a.rstd[s] : 0.f;
    smu[j] = lane && a.sc_mode == 2 ? a.sc_mean[s] : 0.f;
    srs[j] = lane && a.sc_mode == 2 ? a.sc_rstd[s] : 0.f;
  }
}

// xhat = (x - mean) * rstd, and d = dy where the forward's relu passed it:
// recomputed from xhat (no shortcut), from x and the normalized shortcut
// with bn_out (sc_mode 2), or read from the forward output zv (a raw
// shortcut).
template <typename T, int V>
__device__ __forceinline__ void span_grad_in(const SpanArgs& a, const float* xv, const float* dv,
                                             const float* zv, const float* mu, const float* rs,
                                             const float* smu, const float* srs, float* xh,
                                             float* d) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    xh[j] = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
    bool pass = true;
    if (a.relu) {
      if (a.sc_mode == 0)
        pass = xh[j] > relu_edge<T>();
      else if (a.sc_mode == 1)
        pass = zv[j] > 0.f;
      else
        pass = bn_out<T>(xv[j], mu[j], rs[j], zv[j], smu[j], srs[j], 2) > 0.f;
    }
    d[j] = pass ? dv[j] : 0.f;
  }
}

// Backward reduce: sum(d), sum(d * xhat) [, sum(d * shat)]. Operands x, dy
// and (THIRD) the shortcut in mode 2 or the forward output for a raw
// shortcut under relu.
template <typename T, int V, bool RING, int NS, bool THIRD>
__global__ void __launch_bounds__(kSpanThreads) span_bwd_reduce_kernel(SpanArgs a) {
  constexpr int NI = THIRD ? 3 : 2;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int done[kMaxStages];
  const SpanCta e = span_cta(a);
  float* red = smem;
  uint4* ring = reinterpret_cast<uint4*>(smem + blockDim.x * V);
  if constexpr (RING) span_ring_init(full, done);
  int c0 = 0;
  const bool lane = span_lane(a, e, V, c0);
  float mu[V], rs[V], smu[V], srs[V];
  span_stats_of<V>(a, e.g, c0, lane, mu, rs, smu, srs);
  float acc[NS][V];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  const void* ops[3] = {a.x, a.dy, a.z};
  span_walk<T, V, RING, NI, false>(a, e, ops, ring, full, done, [&](long long, auto& v) {
    float d[V], xh[V];
    span_grad_in<T, V>(a, v[0], v[1], v[NI - 1], mu, rs, smu, srs, xh, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc[0][j] += d[j];
      acc[1][j] += d[j] * xh[j];
      if constexpr (NS == 3) acc[2][j] += d[j] * ((v[NI - 1][j] - smu[j]) * srs[j]);
    }
  });
  span_partials<NS, V>(acc, red, a.gpart + static_cast<long long>(blockIdx.x) * NS * a.cw, a.ct,
                       a.rpb, a.cw);
  span_collapse<NS, false>(a);
}

// Backward elementwise: dx [and the shortcut's gradient] from the global
// sums (G, NS, C).
template <typename T, int V, bool RING, int NS, bool THIRD>
__global__ void __launch_bounds__(kSpanThreads) span_bwd_grad_kernel(SpanArgs a) {
  constexpr int NI = THIRD ? 3 : 2;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int done[kMaxStages];
  const SpanCta e = span_cta(a);
  uint4* ring = reinterpret_cast<uint4*>(smem + blockDim.x * V);
  if constexpr (RING) span_ring_init(full, done);
  const int C = a.channels;
  int c0 = 0;
  const bool lane = span_lane(a, e, V, c0);
  float mu[V], rs[V], smu[V], srs[V], ca[V], cb[V], cbs[V];
  span_stats_of<V>(a, e.g, c0, lane, mu, rs, smu, srs);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long s = static_cast<long long>(e.g) * NS * C + c0 + j;
    ca[j] = lane ? a.sums[s] * a.inv_n : 0.f;
    cb[j] = lane ? a.sums[s + C] * a.inv_n : 0.f;
    cbs[j] = lane && NS == 3 ? a.sums[s + 2 * C] * a.inv_n : 0.f;
  }
  T* dx = static_cast<T*>(a.out) + e.lo * C + c0;
  T* dsc = a.sc_mode ? static_cast<T*>(a.dsc) + e.lo * C + c0 : nullptr;
  const void* ops[3] = {a.x, a.dy, a.z};
  span_walk<T, V, RING, NI, true>(a, e, ops, ring, full, done, [&](long long row, auto& v) {
    float d[V], xh[V], o[V];
    span_grad_in<T, V>(a, v[0], v[1], v[NI - 1], mu, rs, smu, srs, xh, d);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = rs[j] * (d[j] - ca[j] - xh[j] * cb[j]);
    span_store<T, V>(dx + row * C, o);
    if (a.sc_mode == 1) {
      span_store<T, V>(dsc + row * C, d);
    } else if constexpr (NS == 3) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = srs[j] * (d[j] - ca[j] - ((v[NI - 1][j] - smu[j]) * srs[j]) * cbs[j]);
      span_store<T, V>(dsc + row * C, o);
    }
  });
}

// The plan against this source's layout: kPlanMismatch where the Python
// copy (ops/nn.py:bn_span_plan) drifted. ni: the tensors a launch streams.
template <typename T>
int span_check(const SpanPlan& p, int channels, int ni) {
  constexpr int VN = Vec<T>::n;
  if (p.ct < 1 || p.rpb < 1 || (p.rpb & (p.rpb - 1)) || p.ct * p.rpb > kSpanThreads ||
      p.tiles < 1 || p.ncta < 1 || p.touched < 1 || (p.vec != VN && p.vec != 1) ||
      channels < 1 || channels % p.vec)
    return vsv::kPlanMismatch;
  const int cv = channels / p.vec;
  if (p.tiles * p.ct < cv || (p.tiles - 1) * p.ct >= cv) return vsv::kPlanMismatch;
  const long long smem = 4LL * p.ct * p.rpb * p.vec + (p.ring ? p.ring_bytes : 0);
  if (smem != p.smem || smem > kSmemMax) return vsv::kPlanMismatch;
  if (p.ring && (p.vec != VN || p.tiles != 1 || p.ring_rows < 1 ||
                 p.ring_bytes < 2LL * ni * p.ring_rows * channels * static_cast<long long>(sizeof(T))))
    return vsv::kPlanMismatch;
  return 0;
}

template <typename K>
int span_launch(K kernel, const SpanPlan& p, const SpanArgs& a, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<p.ncta, p.ct * p.rpb, p.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// fn(std::integral_constant<int, V>, std::bool_constant<RING>) for the
// plan's design: the ring on 16-byte vectors, or direct loads of 16-byte
// vectors or single channels.
template <typename T, typename Fn>
int span_design(const SpanPlan& p, Fn fn) {
  constexpr int VN = Vec<T>::n;
  if (p.ring) return fn(std::integral_constant<int, VN>{}, std::true_type{});
  if (p.vec == VN) return fn(std::integral_constant<int, VN>{}, std::false_type{});
  return fn(std::integral_constant<int, 1>{}, std::false_type{});
}

SpanArgs span_args(const SpanPlan& p, const long long* table, long long ngroup, int groups,
                   int channels) {
  SpanArgs a = {};
  a.table = table;
  a.groups = groups;
  a.channels = channels;
  a.ncta = p.ncta;
  a.touched = p.touched;
  a.tiles = p.tiles;
  a.ct = p.ct;
  a.rpb = p.rpb;
  a.cw = p.ct * p.vec;
  a.ring_rows = p.ring_rows;
  a.ring_bytes = p.ring_bytes;
  a.inv_n = 1.f / static_cast<float>(ngroup);
  return a;
}

SpanPlan span_plan(const int* q) {
  return SpanPlan{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9]};
}

template <typename Fn>
int span_dtype(int dtype, Fn fn) {
  if (dtype == 0) return fn(Tag<float>{});
  if (dtype == 1) return fn(Tag<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Cluster design, 4-D inputs whose (super-)rows fill 16-byte vectors: a
// super-row is `fold` consecutive rows of n (n % fold == 0), fold = 1 where
// one row of C channels fills them, and holds channels * fold = ct_v * 16 /
// element size elements. The geometry comes from the caller
// (ops/nn.py:bn_train_plan): CTAs of ct_v * rpb threads (rpb a power of
// two, at most 512 threads), super-rows streamed in chunks of ring_rows
// through ring_bytes of shared memory; the launcher picks the clusters (of
// kClusterSize CTAs) per group from what the card holds at once. gpart
// holds at least (clusters the card holds) * ns * channels floats. mean/rstd
// (and sc_*): (groups, channels) fp32 outputs; var: (2, groups, channels)
// and gpart: gpart_floats fp32 scratch; sync: 2 * groups + 1 ints, zero
// before first use and left ready for the next launch on the same stream.
// Every pointer 16-byte aligned. inv_n, the Bessel factor (in upd_var) and
// the running update are those of the n true rows and C channels.
extern "C" int bn_cluster_fwd(int dtype, const void* x, const void* sc, int sc_mode, int relu,
                              long long n, int groups, int channels, int fold, int ct_v, int rpb,
                              int ring_rows, int ring_bytes, float* mean, float* rstd,
                              float* run_mean, float* run_var, float* sc_mean, float* sc_rstd,
                              float* sc_run_mean, float* sc_run_var, float* var, float* gpart,
                              long long gpart_floats, int* sync, float mom, float upd_mean,
                              float upd_var, float eps, void* out, void* stream) {
  ClusterArgs a = {};
  a.x = x; a.sc = sc; a.out = out;
  a.mean = mean; a.rstd = rstd; a.sc_mean = sc_mean; a.sc_rstd = sc_rstd; a.var = var;
  a.gpart = gpart; a.run_mean = run_mean; a.run_var = run_var;
  a.sc_run_mean = sc_run_mean; a.sc_run_var = sc_run_var; a.sync = sync;
  if (fold < 1 || n % fold) return static_cast<int>(cudaErrorInvalidValue);
  a.n = n / fold; a.groups = groups; a.channels = channels; a.ct_v = ct_v; a.rpb = rpb;
  a.fold = fold; a.width = channels * fold;
  a.ring_rows = ring_rows; a.ring_bytes = ring_bytes; a.sc_mode = sc_mode; a.relu = relu;
  a.mom = mom; a.upd_mean = upd_mean; a.upd_var = upd_var; a.eps = eps;
  a.inv_n = 1.f / static_cast<float>(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return cluster_forward<float>(a, gpart_floats, s);
  if (dtype == 1) return cluster_forward<__nv_bfloat16>(a, gpart_floats, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y: the forward output, read only for a raw shortcut under relu (sc_mode
// 1); otherwise the relu decision is recomputed from x (and sc). dsc: the
// shortcut's gradient (sc_mode 1 or 2), else null. n, fold as
// bn_cluster_fwd.
extern "C" int bn_cluster_bwd(int dtype, const void* x, const void* y, const void* dy,
                              const void* sc, int sc_mode, int relu, long long n, int groups,
                              int channels, int fold, int ct_v, int rpb, int ring_rows,
                              int ring_bytes, const float* mean, const float* rstd,
                              const float* sc_mean, const float* sc_rstd, float* gpart,
                              long long gpart_floats, int* sync, void* dx, void* dsc,
                              void* stream) {
  ClusterArgs a = {};
  a.x = x; a.y = y; a.dy = dy; a.sc = sc; a.out = dx; a.dsc = dsc;
  a.mean = const_cast<float*>(mean); a.rstd = const_cast<float*>(rstd);
  a.sc_mean = const_cast<float*>(sc_mean); a.sc_rstd = const_cast<float*>(sc_rstd);
  a.gpart = gpart; a.sync = sync;
  if (fold < 1 || n % fold) return static_cast<int>(cudaErrorInvalidValue);
  a.n = n / fold; a.groups = groups; a.channels = channels; a.ct_v = ct_v; a.rpb = rpb;
  a.fold = fold; a.width = channels * fold;
  a.ring_rows = ring_rows; a.ring_bytes = ring_bytes; a.sc_mode = sc_mode; a.relu = relu;
  a.inv_n = 1.f / static_cast<float>(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return cluster_backward<float>(a, gpart_floats, s);
  if (dtype == 1) return cluster_backward<__nv_bfloat16>(a, gpart_floats, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16. sc_mode: 0 none, 1 raw shortcut, 2
// shortcut normalized with its own batch statistics (sc_mean/sc_rstd written,
// sc_run_mean/sc_run_var updated). n: rows per group; any channel count
// (4-channel vectors where channels % 4 == 0, single channels otherwise:
// 4-D calls whose rows the cluster design cannot fold). mean/rstd (and
// sc_*): (groups, channels) fp32
// outputs. part: scratch of 2 * groups * chunks * channels floats.
extern "C" int bn_train_fwd(int dtype, const void* x, const void* sc,
                            int sc_mode, int relu, long long n, int groups,
                            int channels, int chunks, float* mean, float* rstd,
                            float* run_mean, float* run_var, float* sc_mean,
                            float* sc_rstd, float* sc_run_mean,
                            float* sc_run_var, float mom, float upd_mean,
                            float upd_var, float eps, float* part, void* out,
                            int num_sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = channels % 4 == 0;
  if (dtype == 0)
    return (vec ? forward<float, 4> : forward<float, 1>)(
        x, sc, sc_mode, relu, n, groups, channels, chunks, mean, rstd, run_mean, run_var,
        sc_mean, sc_rstd, sc_run_mean, sc_run_var, mom, upd_mean, upd_var, eps, part, out,
        num_sms, s);
  if (dtype == 1)
    return (vec ? forward<__nv_bfloat16, 4> : forward<__nv_bfloat16, 1>)(
        x, sc, sc_mode, relu, n, groups, channels, chunks, mean, rstd, run_mean, run_var,
        sc_mean, sc_rstd, sc_run_mean, sc_run_var, mom, upd_mean, upd_var, eps, part, out,
        num_sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y: the forward output (null unless relu). part: scratch of
// 3 * groups * chunks * channels floats; coef: 3 * groups * channels floats.
// dsc: the shortcut's gradient (sc_mode 1 or 2), else null. Any channel
// count, as bn_train_fwd.
extern "C" int bn_train_bwd(int dtype, const void* x, const void* y,
                            const void* dy, const void* sc, int sc_mode,
                            long long n, int groups, int channels, int chunks,
                            const float* mean, const float* rstd,
                            const float* sc_mean, const float* sc_rstd,
                            float* part, float* coef, void* dx, void* dsc,
                            int num_sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = channels % 4 == 0;
  if (dtype == 0)
    return (vec ? backward<float, 4> : backward<float, 1>)(
        x, y, dy, sc, sc_mode, n, groups, channels, chunks, mean, rstd, sc_mean, sc_rstd,
        part, coef, dx, dsc, num_sms, s);
  if (dtype == 1)
    return (vec ? backward<__nv_bfloat16, 4> : backward<__nv_bfloat16, 1>)(
        x, y, dy, sc, sc_mode, n, groups, channels, chunks, mean, rstd, sc_mean, sc_rstd,
        part, coef, dx, dsc, num_sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The head design on the 2-D calls (x: rows x channels, contiguous; a
// group is rows / groups consecutive rows), in the geometry of
// ops/nn.py:bn_head_plan: v channels a lane (the 16 bytes of a vector: 4
// float32, 8 bf16, every tensor 16-byte aligned and channels % v == 0; or
// 1), cl channel lanes and rl row lanes a CTA (cl * rl <= 256 threads),
// slab rows a row lane (rl * slab == rows, slab dividing rows / groups).
// Other geometries are refused (kShapeUnsupported). mean/rstd (and sc_*):
// (groups, channels) fp32, written forward and read backward; null
// running statistics skip the update. y: the forward output, read only for
// a raw shortcut under relu; dsc: the shortcut's gradient (sc_mode 1 or 2),
// else null.
static HeadArgs head_args(int sc_mode, int relu, long long rows, int groups, int channels,
                          int cl, int rl, int slab) {
  HeadArgs a = {};
  a.rows = rows; a.groups = groups; a.channels = channels;
  a.cl = cl; a.rl = rl; a.slab = slab; a.sc_mode = sc_mode; a.relu = relu;
  a.inv_n = groups > 0 ? 1.f / static_cast<float>(rows / groups) : 0.f;
  return a;
}

template <typename F>
static int head_dtype(int dtype, int v, F fn) {
  if (dtype == 0 && v == 4) return fn(static_cast<float*>(nullptr), std::integral_constant<int, 4>());
  if (dtype == 0 && v == 1) return fn(static_cast<float*>(nullptr), std::integral_constant<int, 1>());
  if (dtype == 1 && v == 8)
    return fn(static_cast<__nv_bfloat16*>(nullptr), std::integral_constant<int, 8>());
  if (dtype == 1 && v == 1)
    return fn(static_cast<__nv_bfloat16*>(nullptr), std::integral_constant<int, 1>());
  return vsv::kShapeUnsupported;
}

extern "C" int bn_head_fwd(int dtype, const void* x, const void* sc, int sc_mode, int relu,
                           long long rows, int groups, int channels, int v, int cl, int rl,
                           int slab, float* mean, float* rstd, float* run_mean,
                           float* run_var,
                           float* sc_mean, float* sc_rstd, float* sc_run_mean, float* sc_run_var,
                           float mom, float upd_mean, float upd_var, float eps, void* out,
                           void* stream) {
  HeadArgs a = head_args(sc_mode, relu, rows, groups, channels, cl, rl, slab);
  a.x = x; a.sc = sc; a.out = out;
  a.mean = mean; a.rstd = rstd; a.sc_mean = sc_mean; a.sc_rstd = sc_rstd;
  a.run_mean = run_mean; a.run_var = run_var; a.sc_run_mean = sc_run_mean;
  a.sc_run_var = sc_run_var;
  a.mom = mom; a.upd_mean = upd_mean; a.upd_var = upd_var; a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dtype(dtype, v, [&](auto t, auto vc) {
    return head_forward<std::remove_pointer_t<decltype(t)>, decltype(vc)::value>(a, s);
  });
}

extern "C" int bn_head_bwd(int dtype, const void* x, const void* y, const void* dy,
                           const void* sc, int sc_mode, int relu, long long rows, int groups,
                           int channels, int v, int cl, int rl, int slab,
                           const float* mean,
                           const float* rstd, const float* sc_mean, const float* sc_rstd,
                           void* dx, void* dsc, void* stream) {
  HeadArgs a = head_args(sc_mode, relu, rows, groups, channels, cl, rl, slab);
  a.x = x; a.y = y; a.dy = dy; a.sc = sc; a.out = dx; a.dsc = dsc;
  a.mean = const_cast<float*>(mean); a.rstd = const_cast<float*>(rstd);
  a.sc_mean = const_cast<float*>(sc_mean); a.sc_rstd = const_cast<float*>(sc_rstd);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dtype(dtype, v, [&](auto t, auto vc) {
    return head_backward<std::remove_pointer_t<decltype(t)>, decltype(vc)::value>(a, s);
  });
}

// Spanning mode, one launch a phase (see span_stats_kernel above). Every
// entry takes: x, this rank's rows (of C channels, channels-last; a group
// is ngroup global rows, G = groups in all) and the plan of
// ops/nn.py:bn_span_plan: its ten scalars (`plan`, host memory, the ring's
// rows for the tensors this launch streams) and its table (`table`, device
// memory: each CTA's (group, first row, end row, channel tile), then each
// touched group's (group, first CTA, row slabs)). A plan that differs from
// this source's layout is refused (kPlanMismatch). Tensors 16-byte
// aligned; gpart holds ncta * ns * (vectors a tile * vector) floats;
// ticket one int, zero, left zero.
//
// bn_span_stats: sum(x), sum(x^2) [, sum(s), sum(s^2) with a shortcut s to
// normalize] per (group, channel) into sums (1 or 2, G, 2, C), zero for
// the groups the rank holds no row of.
extern "C" int bn_span_stats(int dtype, const void* x, const void* sc, long long ngroup, int groups,
                             int channels, const int* plan, const long long* table, float* gpart,
                             int* ticket, float* sums, void* stream) {
  const SpanPlan p = span_plan(plan);
  SpanArgs a = span_args(p, table, ngroup, groups, channels);
  a.x = x; a.z = sc; a.gpart = gpart; a.ticket = ticket; a.sums_out = sums;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = sc != nullptr ? 2 : 1;
  return span_dtype(dtype, [&](auto tag) -> int {
    using T = typename decltype(tag)::type;
    const int err = span_check<T>(p, channels, ni);
    if (err != 0) return err;
    return span_design<T>(p, [&](auto v, auto ring) -> int {
      constexpr int V = decltype(v)::value;
      constexpr bool R = decltype(ring)::value;
      return ni == 2 ? span_launch(span_stats_kernel<T, V, R, 2>, p, a, s)
                     : span_launch(span_stats_kernel<T, V, R, 1>, p, a, s);
    });
  });
}

// After the all-reduce of bn_span_stats' sums over the data ranks: y with
// the epilogue (sc_mode 0 none, 1 raw shortcut, 2 normalized with sc_sums),
// mean/rstd (and sc_*) of every (group, channel), and the running update
// (identical on every rank; null running statistics skip it).
extern "C" int bn_span_normalize(int dtype, const void* x, const void* sc, int sc_mode, int relu,
                                 long long ngroup, int groups, int channels, const int* plan,
                                 const long long* table, const float* sums, const float* sc_sums,
                                 float* mean, float* rstd, float* run_mean, float* run_var,
                                 float* sc_mean, float* sc_rstd, float* sc_run_mean,
                                 float* sc_run_var, float mom, float upd_mean, float upd_var,
                                 float eps, void* out, void* stream) {
  const SpanPlan p = span_plan(plan);
  SpanArgs a = span_args(p, table, ngroup, groups, channels);
  a.x = x; a.z = sc; a.out = out; a.sums = sums; a.sc_sums = sc_sums;
  a.mean = mean; a.rstd = rstd; a.sc_mean = sc_mean; a.sc_rstd = sc_rstd;
  a.run_mean = run_mean; a.run_var = run_var; a.sc_run_mean = sc_run_mean;
  a.sc_run_var = sc_run_var; a.sc_mode = sc_mode; a.relu = relu;
  a.mom = mom; a.upd_mean = upd_mean; a.upd_var = upd_var; a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = sc_mode != 0 ? 2 : 1;
  if ((sc_mode != 0) != (sc != nullptr) || (sc_mode == 2) != (sc_sums != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return span_dtype(dtype, [&](auto tag) -> int {
    using T = typename decltype(tag)::type;
    const int err = span_check<T>(p, channels, ni);
    if (err != 0) return err;
    return span_design<T>(p, [&](auto v, auto ring) -> int {
      constexpr int V = decltype(v)::value;
      constexpr bool R = decltype(ring)::value;
      return ni == 2 ? span_launch(span_normalize_kernel<T, V, R, 2>, p, a, s)
                     : span_launch(span_normalize_kernel<T, V, R, 1>, p, a, s);
    });
  });
}

// The backward's variants: (sums, third operand) by shortcut mode and relu.
template <typename T, int V, bool R, bool REDUCE>
int span_bwd_launch(const SpanPlan& p, const SpanArgs& a, cudaStream_t s) {
  if (a.sc_mode == 2)
    return REDUCE ? span_launch(span_bwd_reduce_kernel<T, V, R, 3, true>, p, a, s)
                  : span_launch(span_bwd_grad_kernel<T, V, R, 3, true>, p, a, s);
  if (a.sc_mode == 1 && a.relu)
    return REDUCE ? span_launch(span_bwd_reduce_kernel<T, V, R, 2, true>, p, a, s)
                  : span_launch(span_bwd_grad_kernel<T, V, R, 2, true>, p, a, s);
  return REDUCE ? span_launch(span_bwd_reduce_kernel<T, V, R, 2, false>, p, a, s)
                : span_launch(span_bwd_grad_kernel<T, V, R, 2, false>, p, a, s);
}

template <bool REDUCE>
int span_backward(int dtype, const SpanPlan& p, const SpanArgs& a, cudaStream_t s) {
  const bool third = a.sc_mode == 2 || (a.sc_mode == 1 && a.relu);
  if (third != (a.z != nullptr) || (a.sc_mode == 2) != (a.sc_mean != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return span_dtype(dtype, [&](auto tag) -> int {
    using T = typename decltype(tag)::type;
    const int err = span_check<T>(p, a.channels, third ? 3 : 2);
    if (err != 0) return err;
    return span_design<T>(p, [&](auto v, auto ring) -> int {
      return span_bwd_launch<T, decltype(v)::value, decltype(ring)::value, REDUCE>(p, a, s);
    });
  });
}

// The backward's partial sums, sum(d), sum(d * xhat) [, sum(d * shat) in
// sc_mode 2] per (group, channel) into sums (G, ns, C), with the forward's
// statistics (mean, rstd, sc_*: (G, C)). z: the shortcut's input (sc_mode
// 2), the forward output (sc_mode 1 under relu; the relu decision of the
// other modes is recomputed from x), else null.
extern "C" int bn_span_bwd_reduce(int dtype, const void* x, const void* z, const void* dy,
                                  int sc_mode, int relu, long long ngroup, int groups,
                                  int channels, const int* plan, const long long* table,
                                  const float* mean, const float* rstd, const float* sc_mean,
                                  const float* sc_rstd, float* gpart, int* ticket, float* sums,
                                  void* stream) {
  const SpanPlan p = span_plan(plan);
  SpanArgs a = span_args(p, table, ngroup, groups, channels);
  a.x = x; a.z = z; a.dy = dy; a.sc_mode = sc_mode; a.relu = relu;
  a.mean = const_cast<float*>(mean); a.rstd = const_cast<float*>(rstd);
  a.sc_mean = const_cast<float*>(sc_mean); a.sc_rstd = const_cast<float*>(sc_rstd);
  a.gpart = gpart; a.ticket = ticket; a.sums_out = sums;
  return span_backward<true>(dtype, p, a, static_cast<cudaStream_t>(stream));
}

// After the all-reduce of bn_span_bwd_reduce's sums: dx (and the
// shortcut's gradient dsc in sc_mode 1, 2) of the rank's rows.
extern "C" int bn_span_bwd_grad(int dtype, const void* x, const void* z, const void* dy,
                                int sc_mode, int relu, long long ngroup, int groups, int channels,
                                const int* plan, const long long* table, const float* mean,
                                const float* rstd, const float* sc_mean, const float* sc_rstd,
                                const float* sums, void* dx, void* dsc, void* stream) {
  const SpanPlan p = span_plan(plan);
  SpanArgs a = span_args(p, table, ngroup, groups, channels);
  a.x = x; a.z = z; a.dy = dy; a.sc_mode = sc_mode; a.relu = relu; a.sums = sums;
  a.mean = const_cast<float*>(mean); a.rstd = const_cast<float*>(rstd);
  a.sc_mean = const_cast<float*>(sc_mean); a.sc_rstd = const_cast<float*>(sc_rstd);
  a.out = dx; a.dsc = dsc;
  if ((sc_mode != 0) != (dsc != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  return span_backward<false>(dtype, p, a, static_cast<cudaStream_t>(stream));
}
