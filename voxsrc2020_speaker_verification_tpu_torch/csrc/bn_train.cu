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
// which the 2-D head calls and channel counts that are not multiples of 4
// take; the latter move single channels instead of 4-channel vectors, with
// the same arithmetic an element):
// three launches per direction -- per-block partial sums, a per-channel
// finalize, an elementwise pass -- with the partials making a round trip
// through HBM, x read twice in the forward, x, y and dy read twice in the
// backward (7 units of one activation against the bound's 4), and 8-byte
// bf16 accesses.
//
// The cluster design (4-D inputs whose channel count fills 16-byte vectors;
// the wrapper chooses it by shape): one launch per direction, filling the
// card in one wave. Thread-block clusters of 2 CTAs (kClusterSize), k of
// them per BN group, k the most the card holds at once
// (cudaOccupancyMaxActiveClusters; one CTA per SM at this shared-memory
// footprint): on the H100, 8 groups x 8 clusters of 2 = 128 CTAs on the 132
// SMs, launched cooperatively so that all of them are resident together
// (larger clusters fit fewer CTAs on the card, as a cluster's CTAs share
// one GPC). Each CTA owns a contiguous slab of its group's rows, at full
// channel width, and streams it through a ring of chunks (about four, at
// most 16) in shared memory filled by bulk copies (the Tensor Memory
// Accelerator's 1-D form) on mbarriers, so ~200 KB are in flight per SM;
// it sums its rows with a fixed tree over its threads, the cluster adds
// its CTAs' sums through distributed shared memory in rank order, and the
// group's clusters add theirs in order through global memory behind a
// generation barrier of the group (integer atomics only; a wait that lasts
// 30 s traps instead of hanging). After it the same launch normalizes
// (forward) or writes dx (backward), from the slab still in shared memory
// where it fits in the ring, else streamed again (from L2 for tensors that
// fit there). The backward takes no y: the relu decision is recomputed
// from x (and the shortcut) with the forward's exact arithmetic (bn_out
// below), except for a raw shortcut, whose forward output y the caller
// saves instead of the shortcut. The running statistics need the mean over
// groups: each group publishes its (mean, var), and the last group to
// arrive (an integer ticket with fences) applies the update in group order
// and resets the ticket. No float atomics anywhere: reruns match bit for
// bit.
//
// What bounds it now: HBM bytes -- x read twice and y written in the
// forward, x and dy read twice and dx written in the backward (3 and 5
// units of one activation against the bound's 2 and 3) where a slab does
// not fit on chip -- and the 4 SMs a grid of 8 groups leaves idle.
#include <algorithm>
#include <cooperative_groups.h>
#include <mutex>

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

// The rows a reduction launch covers: the caller holds `nloc` rows that
// start at global row `offset`, a BN group is `ngroup` consecutive global
// rows, and grid z walks the groups from g0. The multi-kernel design holds
// whole groups (offset 0, nloc = G * ngroup, g0 = 0); the spanning mode
// (bn_span_*) a rank's rows of groups that other ranks share.
struct Span {
  long long nloc, offset, ngroup;
  int g0;
  // local rows [lo, hi) of grid z's group
  __device__ __forceinline__ void range(int z, long long& lo, long long& hi) const {
    const long long g = g0 + z, first = g * ngroup, last = first + ngroup;
    lo = (first > offset ? first : offset) - offset;
    hi = (last < offset + nloc ? last : offset + nloc) - offset;
  }
};

// Forward statistics pass: sum(x), sum(x^2). Grid (chunks, tiles, groups of the span).
template <typename T, int V>
__global__ void stats_kernel(const T* __restrict__ x, Span span, int channels,
                             Geo geo, float* __restrict__ part) {
  const int lane_c = threadIdx.x % geo.cpb;
  const int lane_r = threadIdx.x / geo.cpb;
  const int cv = blockIdx.y * geo.cpb + lane_c;
  float acc[2][V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[0][j] = acc[1][j] = 0.f;
  if (lane_r < geo.rpb && cv < geo.cv) {
    long long lo, hi;
    span.range(blockIdx.z, lo, hi);
    const long long n = hi - lo;
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
                                 int channels, long long group_elems,
                                 long long elem_offset, int relu, int sc_mode) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    const long long e = v * V;
    const long long s = ((e + elem_offset) / group_elems) * channels + e % channels;
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
                                  Span span, int channels, Geo geo,
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
    const int g = span.g0 + blockIdx.z;
    float mu[V], rs[V], smu[V], srs[V];
    load_stats<V>(mean + g * channels + cv * V, mu);
    load_stats<V>(rstd + g * channels + cv * V, rs);
    if (NS == 3) {
      load_stats<V>(sc_mean + g * channels + cv * V, smu);
      load_stats<V>(sc_rstd + g * channels + cv * V, srs);
    }
    long long lo, hi;
    span.range(blockIdx.z, lo, hi);
    const long long n = hi - lo;
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
                            int groups, long long group_elems, long long elem_offset,
                            int sc_mode) {
  const long long gc = static_cast<long long>(groups) * channels;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    const long long e = v * V;
    const long long s = ((e + elem_offset) / group_elems) * channels + e % channels;
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
  const Span span{n * groups, 0, n, 0};
  const size_t fin_smem = 2 * sizeof(float) * groups;
  const float inv_n = 1.f / static_cast<float>(n);
  stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), span,
                                                     channels, geo, part);
  finalize_fwd_kernel<<<channels, kThreads, fin_smem, stream>>>(
      part, groups, chunks, channels, inv_n, eps, mean, rstd, run_mean, run_var,
      mom, upd_mean, upd_var);
  if (sc_mode == 2) {
    stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(sc), span,
                                                       channels, geo, part);
    finalize_fwd_kernel<<<channels, kThreads, fin_smem, stream>>>(
        part, groups, chunks, channels, inv_n, eps, sc_mean, sc_rstd,
        sc_run_mean, sc_run_var, mom, upd_mean, upd_var);
  }
  const long long nvec = n * groups * channels / V;
  normalize_kernel<T, V><<<elementwise_blocks(nvec, num_sms), kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, static_cast<const T*>(sc), sc_mean,
      sc_rstd, static_cast<T*>(out), nvec, channels, n * channels, 0, relu, sc_mode);
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
  const Span span{n * groups, 0, n, 0};
  const float inv_n = 1.f / static_cast<float>(n);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  const T* st = static_cast<const T*>(sc);
  int ns = 2;
  if (sc_mode == 2) {
    ns = 3;
    reduce_bwd_kernel<T, 3, V><<<grid, kThreads, 0, stream>>>(
        xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, span, channels, geo, part);
  } else {
    reduce_bwd_kernel<T, 2, V><<<grid, kThreads, 0, stream>>>(
        xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, span, channels, geo, part);
  }
  finalize_bwd_kernel<<<channels, kThreads, 0, stream>>>(
      part, ns, groups, chunks, channels, inv_n, coef);
  const long long nvec = n * groups * channels / V;
  grad_kernel<T, V><<<elementwise_blocks(nvec, num_sms), kThreads, 0, stream>>>(
      xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, coef, static_cast<T*>(dx),
      static_cast<T*>(dsc), nvec, channels, groups, n * channels, 0, sc_mode);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// spanning mode: BN groups that span the data ranks of a process group
// ---------------------------------------------------------------------------
//
// Each rank holds nloc consecutive global rows from `offset`; group g is
// global rows [g * ngroup, (g + 1) * ngroup), whatever the alignment of
// groups to ranks. The statistics pass of the multi-kernel design runs
// over the groups the rank touches (Span), a collapse writes the rank's
// partial sums per (group, sum, channel) for all G groups (zero where it
// holds none of a group's rows), the caller all-reduces them over the data
// ranks (torch.distributed), and the finalize and elementwise passes of
// the multi-kernel design follow on the global sums: the statistics of
// group g are those of its global rows on every rank. The backward does
// the same for sum(d), sum(d * xhat) [, sum(d * shat)]. Sums over a rank's
// chunks are in fixed order; the all-reduce's order is NCCL's.

Span span_of(long long nloc, long long offset, long long ngroup, int* touched) {
  const long long g0 = offset / ngroup, g1 = (offset + nloc - 1) / ngroup;
  *touched = static_cast<int>(g1 - g0 + 1);
  return Span{nloc, offset, ngroup, static_cast<int>(g0)};
}

// sums[(g * ns + k) * C + c] = the sum over the chunks of part for the
// span's groups, 0 for the others. One block a channel, a warp a (g, k).
__global__ void span_collapse_kernel(const float* __restrict__ part, int ns, int g0,
                                     int touched, int groups, int chunks, int channels,
                                     float* __restrict__ sums) {
  const int c = blockIdx.x;
  const long long stride = static_cast<long long>(ns) * channels;
  for (int gk = threadIdx.x / 32; gk < groups * ns; gk += blockDim.x / 32) {
    const int g = gk / ns, k = gk % ns, z = g - g0;
    float s = 0.f;
    if (z >= 0 && z < touched)
      s = warp_chunk_sum(part, static_cast<long long>(z) * chunks * stride + k * channels + c,
                         chunks, stride);
    if (threadIdx.x % 32 == 0) sums[(static_cast<long long>(g) * ns + k) * channels + c] = s;
  }
}

template <typename T, int V>
int span_stats(const void* x, Span span, int touched, int groups, int channels, int chunks,
               float* part, float* sums, cudaStream_t stream) {
  const Geo geo = make_geo<V>(channels, chunks);
  stats_kernel<T, V><<<dim3(chunks, geo.tiles, touched), kThreads, 0, stream>>>(
      static_cast<const T*>(x), span, channels, geo, part);
  span_collapse_kernel<<<channels, kThreads, 0, stream>>>(part, 2, span.g0, touched, groups,
                                                          chunks, channels, sums);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int span_normalize(const void* x, const void* sc, int sc_mode, int relu, Span span, int groups,
                   int channels, const float* sums, const float* sc_sums, float* mean,
                   float* rstd, float* run_mean, float* run_var, float* sc_mean, float* sc_rstd,
                   float* sc_run_mean, float* sc_run_var, float mom, float upd_mean,
                   float upd_var, float eps, void* out, int num_sms, cudaStream_t stream) {
  const size_t fin_smem = 2 * sizeof(float) * groups;
  const float inv_n = 1.f / static_cast<float>(span.ngroup);
  finalize_fwd_kernel<<<channels, kThreads, fin_smem, stream>>>(
      sums, groups, 1, channels, inv_n, eps, mean, rstd, run_mean, run_var, mom, upd_mean,
      upd_var);
  if (sc_mode == 2)
    finalize_fwd_kernel<<<channels, kThreads, fin_smem, stream>>>(
        sc_sums, groups, 1, channels, inv_n, eps, sc_mean, sc_rstd, sc_run_mean, sc_run_var,
        mom, upd_mean, upd_var);
  const long long nvec = span.nloc * channels / V;
  normalize_kernel<T, V><<<elementwise_blocks(nvec, num_sms), kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, static_cast<const T*>(sc), sc_mean, sc_rstd,
      static_cast<T*>(out), nvec, channels, span.ngroup * channels, span.offset * channels,
      relu, sc_mode);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int span_bwd_reduce(const void* x, const void* y, const void* dy, const void* sc, int sc_mode,
                    Span span, int touched, int groups, int channels, int chunks,
                    const float* mean, const float* rstd, const float* sc_mean,
                    const float* sc_rstd, float* part, float* sums, cudaStream_t stream) {
  const Geo geo = make_geo<V>(channels, chunks);
  const dim3 grid(chunks, geo.tiles, touched);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  const T* st = static_cast<const T*>(sc);
  const int ns = sc_mode == 2 ? 3 : 2;
  if (ns == 3)
    reduce_bwd_kernel<T, 3, V><<<grid, kThreads, 0, stream>>>(
        xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, span, channels, geo, part);
  else
    reduce_bwd_kernel<T, 2, V><<<grid, kThreads, 0, stream>>>(
        xt, yt, dyt, st, mean, rstd, sc_mean, sc_rstd, span, channels, geo, part);
  span_collapse_kernel<<<channels, kThreads, 0, stream>>>(part, ns, span.g0, touched, groups,
                                                          chunks, channels, sums);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int span_bwd_grad(const void* x, const void* y, const void* dy, const void* sc, int sc_mode,
                  Span span, int groups, int channels, const float* mean, const float* rstd,
                  const float* sc_mean, const float* sc_rstd, const float* sums, float* coef,
                  void* dx, void* dsc, int num_sms, cudaStream_t stream) {
  const int ns = sc_mode == 2 ? 3 : 2;
  finalize_bwd_kernel<<<channels, kThreads, 0, stream>>>(
      sums, ns, groups, 1, channels, 1.f / static_cast<float>(span.ngroup), coef);
  const long long nvec = span.nloc * channels / V;
  grad_kernel<T, V><<<elementwise_blocks(nvec, num_sms), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(dy),
      static_cast<const T*>(sc), mean, rstd, sc_mean, sc_rstd, coef, static_cast<T*>(dx),
      static_cast<T*>(dsc), nvec, channels, groups, span.ngroup * channels,
      span.offset * channels, sc_mode);
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

__device__ __forceinline__ void unpack16(uint4 q, float* v, const float*) {
  v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack16(uint4 q, float* v, const __nv_bfloat16*) {
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  unsigned int w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<unsigned int*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

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
  long long n;       // rows per group
  int groups, channels, ct_v, rpb;
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
// power of two) into part[k * C + c]; red holds blockDim * V floats.
template <int NS, int V>
__device__ __forceinline__ void block_sums(float (*acc)[V], float* red, float* part,
                                           int ct_v, int rpb) {
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
    if (lane_r == 0)
#pragma unroll
      for (int j = 0; j < V; ++j) part[(k * ct_v + lane_c) * V + j] = red[j * nt + tid];
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
  block_sums<NS, V>(acc, red, part, a.ct_v, a.rpb);
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
// visit_resident reads them again.
template <typename F>
__device__ __forceinline__ void stream_ring(const char* const* src, int ni, long long rows,
                                          int ct_v, int rpb, int R, int S, uint4* ring,
                                          uint64_t* full, int& seq, F f) {
  const int lane_c = threadIdx.x % ct_v, lane_r = threadIdx.x / ct_v;
  const long long row_bytes = 16LL * ct_v;
  const long long nchunks = (rows + R - 1) / R;
  const long long ts = static_cast<long long>(R) * ct_v;
  auto issue = [&](long long k) {
    const int st = static_cast<int>((seq + k) % S);
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
    for (long long k = 0; k < S && k < nchunks; ++k) issue(k);
  for (long long k = 0; k < nchunks; ++k) {
    const long long j = seq + k;
    const int st = static_cast<int>(j % S);
    mbar_wait(&full[st], static_cast<int>((j / S) & 1));
    const long long nr = min(static_cast<long long>(R), rows - k * R);
    const uint4* stage = ring + st * ni * ts;
    for (long long u = lane_r; u < nr; u += rpb) f(k * R + u, stage + u * ct_v + lane_c, ts);
    __syncthreads();
    if (threadIdx.x == 0 && k + S < nchunks) issue(k + S);
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

// Shared memory: red (blockDim * V) | part, tot (NS * C each) | coef (4 *
// C) floats | the ring (ring_bytes).
template <typename T>
__host__ __device__ __forceinline__ size_t cluster_smem(int threads, int ns, int channels,
                                                        int ring_bytes) {
  return sizeof(float) * (static_cast<size_t>(threads) * Vec<T>::n +
                          static_cast<size_t>(2 * ns + 4) * channels) +
         static_cast<size_t>(ring_bytes);
}

// Forward: G * k clusters of cs CTAs, k clusters per group, each CTA a
// contiguous slab of its group's rows. NS = 2 (x) or 4 (x and the
// normalized shortcut).
template <typename T, int NS>
__global__ void __launch_bounds__(kClusterThreads, 1) cluster_fwd_kernel(ClusterArgs a) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const Slab s = slab_of(a, cluster);
  const int tid = threadIdx.x, C = a.channels, ct_v = a.ct_v;
  const int lane_c = tid % ct_v;
  const int old_gen = (a.k > 1 && tid == 0) ? load_acquire(a.sync + a.groups + s.g) : 0;
  float* red = smem;
  float* part = red + blockDim.x * V;
  float* tot = part + NS * C;
  float* coef = tot + NS * C;
  uint4* ring = reinterpret_cast<uint4*>(coef + 4 * C);
  const T* x = static_cast<const T*>(a.x);
  const T* sc = static_cast<const T*>(a.sc);
  const long long row0 = (static_cast<long long>(s.g) * a.n + s.r0) * C;
  const long long rows = s.r1 - s.r0;
  const char* src[2] = {reinterpret_cast<const char*>(x + row0),
                        a.sc_mode ? reinterpret_cast<const char*>(sc + row0) : nullptr};
  const int row_bytes = C * static_cast<int>(sizeof(T));
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
  // memory or streamed again
  float mu[V], rs[V], smu[V], srs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = coef[lane_c * V + j];
    rs[j] = coef[C + lane_c * V + j];
    smu[j] = NS == 4 ? coef[2 * C + lane_c * V + j] : 0.f;
    srs[j] = NS == 4 ? coef[3 * C + lane_c * V + j] : 0.f;
  }
  T* out = static_cast<T*>(a.out) + row0 + lane_c * V;
  auto normalize = [&](long long row, const uint4* p, long long ts) {
    float xv[V], sv[V], o[V];
    unpack16(p[0], xv, x);
    if (a.sc_mode != 0) unpack16(p[ts], sv, x);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float y = bn_out<T>(xv[j], mu[j], rs[j], a.sc_mode ? sv[j] : 0.f, smu[j], srs[j],
                                a.sc_mode);
      o[j] = a.relu ? fmaxf(y, 0.f) : y;
    }
    store16(out + row * C, o);
  };
  if (ni1 == ni2 && rows <= static_cast<long long>(S) * a.ring_rows)
    visit_resident(ni1, rows, ct_v, a.rpb, a.ring_rows, ring, normalize);
  else
    stream_ring(src, ni2, rows, ct_v, a.rpb, a.ring_rows, S, ring, full, seq, normalize);
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
  const int tid = threadIdx.x, C = a.channels, ct_v = a.ct_v;
  const int lane_c = tid % ct_v;
  const int old_gen = (a.k > 1 && tid == 0) ? load_acquire(a.sync + a.groups + s.g) : 0;
  float* red = smem;
  float* part = red + blockDim.x * V;
  float* tot = part + NS * C;
  float* coef = tot + NS * C;
  uint4* ring = reinterpret_cast<uint4*>(coef + 4 * C);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* z = static_cast<const T*>(a.sc_mode == 2 ? a.sc : a.y);
  const long long row0 = (static_cast<long long>(s.g) * a.n + s.r0) * C;
  const long long rows = s.r1 - s.r0;
  const char* src[3] = {reinterpret_cast<const char*>(x + row0),
                        reinterpret_cast<const char*>(dy + row0),
                        THIRD ? reinterpret_cast<const char*>(z + row0) : nullptr};
  const int S = ring_stages(a, NO, C * static_cast<int>(sizeof(T)));
  ring_init(full);
  int seq = 0;

  float mu[V], rs[V], smu[V], srs[V];
  const long long gc = static_cast<long long>(s.g) * C + lane_c * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = a.mean[gc + j];
    rs[j] = a.rstd[gc + j];
    smu[j] = NS == 3 ? a.sc_mean[gc + j] : 0.f;
    srs[j] = NS == 3 ? a.sc_rstd[gc + j] : 0.f;
  }
  // d = dy where the forward's relu passed it
  auto grad_in = [&](const float* xv, const float* dv, const float* zv, float* d) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      bool pass = true;
      if (a.relu) {
        if (a.sc_mode == 1)
          pass = zv[j] > 0.f;
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
    ca[j] = coef[lane_c * V + j];
    cb[j] = coef[C + lane_c * V + j];
    cbs[j] = NS == 3 ? coef[2 * C + lane_c * V + j] : 0.f;
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
    store16(dx + row * C, o);
    if (a.sc_mode == 1) {
      store16(dsc + row * C, d);
    } else if (NS == 3) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = srs[j] * (d[j] - ca[j] - ((zv[j] - smu[j]) * srs[j]) * cbs[j]);
      store16(dsc + row * C, o);
    }
  };
  if (rows <= static_cast<long long>(S) * a.ring_rows)
    visit_resident(NO, rows, ct_v, a.rpb, a.ring_rows, ring, grad_row);
  else
    stream_ring(src, NO, rows, ct_v, a.rpb, a.ring_rows, S, ring, full, seq, grad_row);
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
  const long long chunk = static_cast<long long>(ni) * a.ring_rows * a.channels * sizeof(T);
  if (threads > kClusterThreads || a.ct_v * Vec<T>::n != a.channels || (a.rpb & (a.rpb - 1)) ||
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

}  // namespace

// Cluster design, 4-D inputs whose channels fill 16-byte vectors
// (channels = ct_v * 16 / element size). The geometry comes from the
// caller (ops/nn.py:bn_train_plan): CTAs of ct_v * rpb threads (rpb a power
// of two, at most 512 threads), rows streamed in chunks of ring_rows
// through ring_bytes of shared memory; the launcher picks the clusters (of
// kClusterSize CTAs) per group from what the card holds at once. gpart
// holds at least (clusters the card holds) * ns * channels floats. mean/rstd
// (and sc_*): (groups, channels) fp32 outputs; var: (2, groups, channels)
// and gpart: gpart_floats fp32 scratch; sync: 2 * groups + 1 ints, zero
// before first use and left ready for the next launch on the same stream.
// Every pointer 16-byte aligned.
extern "C" int bn_cluster_fwd(int dtype, const void* x, const void* sc, int sc_mode, int relu,
                              long long n, int groups, int channels, int ct_v, int rpb, int ring_rows, int ring_bytes, float* mean, float* rstd,
                              float* run_mean, float* run_var, float* sc_mean, float* sc_rstd,
                              float* sc_run_mean, float* sc_run_var, float* var, float* gpart,
                              long long gpart_floats, int* sync, float mom, float upd_mean,
                              float upd_var, float eps, void* out, void* stream) {
  ClusterArgs a = {};
  a.x = x; a.sc = sc; a.out = out;
  a.mean = mean; a.rstd = rstd; a.sc_mean = sc_mean; a.sc_rstd = sc_rstd; a.var = var;
  a.gpart = gpart; a.run_mean = run_mean; a.run_var = run_var;
  a.sc_run_mean = sc_run_mean; a.sc_run_var = sc_run_var; a.sync = sync;
  a.n = n; a.groups = groups; a.channels = channels; a.ct_v = ct_v; a.rpb = rpb;
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
// shortcut's gradient (sc_mode 1 or 2), else null.
extern "C" int bn_cluster_bwd(int dtype, const void* x, const void* y, const void* dy,
                              const void* sc, int sc_mode, int relu, long long n, int groups,
                              int channels, int ct_v, int rpb, int ring_rows,
                              int ring_bytes, const float* mean, const float* rstd,
                              const float* sc_mean, const float* sc_rstd, float* gpart,
                              long long gpart_floats, int* sync, void* dx, void* dsc,
                              void* stream) {
  ClusterArgs a = {};
  a.x = x; a.y = y; a.dy = dy; a.sc = sc; a.out = dx; a.dsc = dsc;
  a.mean = const_cast<float*>(mean); a.rstd = const_cast<float*>(rstd);
  a.sc_mean = const_cast<float*>(sc_mean); a.sc_rstd = const_cast<float*>(sc_rstd);
  a.gpart = gpart; a.sync = sync;
  a.n = n; a.groups = groups; a.channels = channels; a.ct_v = ct_v; a.rpb = rpb;
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
// dpn68's 10-channel stem). mean/rstd (and sc_*): (groups, channels) fp32
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

// Spanning mode (see span_stats above). x: this rank's nloc rows (of C
// channels, channels-last) from global row `offset`; a group is ngroup
// rows, G groups in all. Writes the rank's partial sum(x), sum(x^2) per
// (group, channel) into sums (G, 2, C); part takes touched * chunks * 2 * C
// floats, touched = the groups the rank's rows meet.
#define VSV_SPAN_DISPATCH(fn, ...)                                                   \
  do {                                                                               \
    const bool vec = channels % 4 == 0;                                              \
    if (dtype == 0) return (vec ? fn<float, 4> : fn<float, 1>)(__VA_ARGS__);         \
    if (dtype == 1)                                                                  \
      return (vec ? fn<__nv_bfloat16, 4> : fn<__nv_bfloat16, 1>)(__VA_ARGS__);       \
    return static_cast<int>(cudaErrorInvalidValue);                                  \
  } while (0)

extern "C" int bn_span_stats(int dtype, const void* x, long long nloc, long long offset,
                             long long ngroup, int groups, int channels, int chunks,
                             float* part, float* sums, void* stream) {
  if (nloc < 1 || ngroup < 1 || offset < 0 || offset + nloc > ngroup * groups)
    return vsv::kShapeUnsupported;
  int touched = 0;
  const Span span = span_of(nloc, offset, ngroup, &touched);
  VSV_SPAN_DISPATCH(span_stats, x, span, touched, groups, channels, chunks, part, sums,
                    static_cast<cudaStream_t>(stream));
}

// After the all-reduce of bn_span_stats' sums over the data ranks: mean and
// rstd per (group, channel), the running update (identical on every rank),
// and the rank's rows normalized with the epilogue.
extern "C" int bn_span_normalize(int dtype, const void* x, const void* sc, int sc_mode,
                                 int relu, long long nloc, long long offset, long long ngroup,
                                 int groups, int channels, const float* sums,
                                 const float* sc_sums, float* mean, float* rstd,
                                 float* run_mean, float* run_var, float* sc_mean,
                                 float* sc_rstd, float* sc_run_mean, float* sc_run_var,
                                 float mom, float upd_mean, float upd_var, float eps,
                                 void* out, int num_sms, void* stream) {
  if (nloc < 1 || ngroup < 1 || offset < 0 || offset + nloc > ngroup * groups)
    return vsv::kShapeUnsupported;
  int touched = 0;
  const Span span = span_of(nloc, offset, ngroup, &touched);
  VSV_SPAN_DISPATCH(span_normalize, x, sc, sc_mode, relu, span, groups, channels, sums,
                    sc_sums, mean, rstd, run_mean, run_var, sc_mean, sc_rstd, sc_run_mean,
                    sc_run_var, mom, upd_mean, upd_var, eps, out, num_sms,
                    static_cast<cudaStream_t>(stream));
}

// The backward's partial sums per (group, sum, channel) into sums (G, ns,
// C), ns = 3 with a normalized shortcut, else 2; y (under relu) as in
// bn_train_bwd.
extern "C" int bn_span_bwd_reduce(int dtype, const void* x, const void* y, const void* dy,
                                  const void* sc, int sc_mode, long long nloc,
                                  long long offset, long long ngroup, int groups,
                                  int channels, int chunks, const float* mean,
                                  const float* rstd, const float* sc_mean,
                                  const float* sc_rstd, float* part, float* sums,
                                  void* stream) {
  if (nloc < 1 || ngroup < 1 || offset < 0 || offset + nloc > ngroup * groups)
    return vsv::kShapeUnsupported;
  int touched = 0;
  const Span span = span_of(nloc, offset, ngroup, &touched);
  VSV_SPAN_DISPATCH(span_bwd_reduce, x, y, dy, sc, sc_mode, span, touched, groups, channels,
                    chunks, mean, rstd, sc_mean, sc_rstd, part, sums,
                    static_cast<cudaStream_t>(stream));
}

// After the all-reduce of bn_span_bwd_reduce's sums: dx (and the shortcut's
// gradient) of the rank's rows; coef takes ns * G * C floats.
extern "C" int bn_span_bwd_grad(int dtype, const void* x, const void* y, const void* dy,
                                const void* sc, int sc_mode, long long nloc, long long offset,
                                long long ngroup, int groups, int channels, const float* mean,
                                const float* rstd, const float* sc_mean, const float* sc_rstd,
                                const float* sums, float* coef, void* dx, void* dsc,
                                int num_sms, void* stream) {
  if (nloc < 1 || ngroup < 1 || offset < 0 || offset + nloc > ngroup * groups)
    return vsv::kShapeUnsupported;
  int touched = 0;
  const Span span = span_of(nloc, offset, ngroup, &touched);
  VSV_SPAN_DISPATCH(span_bwd_grad, x, y, dy, sc, sc_mode, span, groups, channels, mean, rstd,
                    sc_mean, sc_rstd, sums, coef, dx, dsc, num_sms,
                    static_cast<cudaStream_t>(stream));
}
