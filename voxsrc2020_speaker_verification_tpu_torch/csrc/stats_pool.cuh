// The column walk of the masked statistics pool, shared by K4
// (stats_pool.cu) and K4b (stats_pool_bwd.cu): both compute the moments
// through moments() below, so K4b's mean and std are K4's, bit for bit.
//
// Work unit: a (b, f, channel tile). In channels-last memory (B, T, F, C) a
// tile's time row is contiguous and rows lie F*C elements apart. A tile is
// as wide as one warp covers with 16-byte accesses (256 bf16 or 128 fp32
// channels): lane l owns the V = 16 / sizeof(T) channels from l * V. The
// tile's slab (T rows of 512 bytes) is staged into shared memory with
// 16-byte cp.async and every pass reads it there, so x leaves HBM once.
// Each lane reads back only the bytes it copied itself.
//
// Persistent CTAs, as many as the card holds at once, each walk their tiles
// (blockIdx.x, + gridDim.x, ...) through a ring of kStages slabs: the next
// two tiles' copies are in flight while one tile is reduced, so a CTA's
// arithmetic overlaps its loads. A column longer than kRingRows does not
// fit the ring: it streams through one slab in chunks, once per pass (x then
// leaves HBM two or three times: right, slower).
//
// Order: warp w takes rows w, w + kWarps, ...; a lane adds its rows in time
// order, and the warps' partial sums are added in warp order. Reruns agree
// bit for bit, and so do K4 and K4b.
//
// Any input: a lane whose channels pass C, or whose rows are not 16-byte
// aligned, copies element by element (zeros past C) and stores only its
// channels inside C; masked rows are multiplied by their 0/1 (or weight)
// value like every other row, never skipped.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace vsv {
namespace pool {

// Warps a CTA: 8 and 16 were slower at every main shape (each tile pays
// barriers and cross-warp sums once per warp).
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowBytes = 512;  // one tile row: 32 lanes x 16 bytes
constexpr int kStages = 3;      // slabs of the ring
// The longest column that rides the ring: 3 x 128 rows x 512 B = 192 KB of
// slabs (the serving head, T = 125: 194 KB of shared memory in all, one CTA
// an SM; the training head, T = 25: 42 KB, five an SM).
constexpr int kRingRows = 128;

template <typename T> struct Lane { static constexpr int V = 16 / sizeof(T); };

__host__ __device__ __forceinline__ bool on_ring(int tlen) { return tlen <= kRingRows; }
__host__ __device__ __forceinline__ int slab_rows(int tlen) {
  return on_ring(tlen) ? tlen : kRingRows;
}
__host__ __device__ __forceinline__ int num_slabs(int tlen) {
  return on_ring(tlen) ? kStages : 1;
}
__host__ __device__ __forceinline__ int tiles_per_row(int channels, int v) {
  return (channels + 32 * v - 1) / (32 * v);
}

// Dynamic shared memory of one CTA, 16-byte aligned parts: the slabs
// (num_slabs x rows x 512 B), the warps' partial sums (kWarps x (V + 1) x 32
// floats), and each slab's mask rows.
template <typename T>
__host__ __device__ __forceinline__ size_t part_bytes() {
  return static_cast<size_t>(kWarps) * (Lane<T>::V + 1) * 32 * sizeof(float);
}
__host__ __device__ __forceinline__ size_t mask_bytes(int tlen) {
  return static_cast<size_t>((slab_rows(tlen) + 3) / 4) * 16;
}

template <typename T>
inline size_t smem_bytes(int tlen) {
  return static_cast<size_t>(num_slabs(tlen)) *
             (static_cast<size_t>(slab_rows(tlen)) * kRowBytes + mask_bytes(tlen)) +
         part_bytes<T>();
}

// One slab of the ring (its rows and its mask values) and the partial sums.
struct Smem {
  unsigned char* slab;
  float* part;
  float* msk;
};

template <typename T>
__device__ __forceinline__ Smem carve(unsigned char* smem, int tlen, int slab) {
  const size_t slabs = static_cast<size_t>(num_slabs(tlen)) * slab_rows(tlen) * kRowBytes;
  unsigned char* part = smem + slabs;
  unsigned char* msk = part + part_bytes<T>() + slab * mask_bytes(tlen);
  return {smem + static_cast<size_t>(slab) * slab_rows(tlen) * kRowBytes,
          reinterpret_cast<float*>(part), reinterpret_cast<float*>(msk)};
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes: V elements <-> V floats
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

// A lane's V values at p: one 16-byte access where `vec`, else element by
// element, the first `valid` of them (zeros after).
template <typename T>
__device__ __forceinline__ void load_lane(const T* p, float* v, int valid, bool vec) {
  if (vec) {
    load16(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < Lane<T>::V; ++j) v[j] = j < valid ? to_f(p[j]) : 0.f;
}
template <typename T>
__device__ __forceinline__ void store_lane(T* p, const float* v, int valid, bool vec) {
  if (vec) {
    store16(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < Lane<T>::V; ++j)
    if (j < valid) p[j] = from_f<T>(v[j]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's share of a tile.
struct Column {
  long long bf;      // b * F + f: the pooled output row
  long long offset;  // element (b, t = 0, f, c0) of x (and of dx)
  long long step;    // F * C: elements between time rows
  const float* mask; // the batch row's mask (T values), or null
  int c0;
  int valid;         // channels c0 .. c0 + valid - 1 lie inside C (0..V)
  bool full;         // valid == V and C % V == 0: 16 bytes where a base is aligned
  bool vec;          // x's rows by 16-byte cp.async
};

// (32-bit index math: the launcher refuses more than 2^30 tiles)
template <typename T>
__device__ __forceinline__ Column column(const T* x, const float* mask, int tlen, int flen,
                                         int channels, int tile) {
  constexpr int V = Lane<T>::V;
  const int tiles = tiles_per_row(channels, V);
  const int bf = tile / tiles;
  const int b = bf / flen;
  const int f = bf - b * flen;
  Column c;
  c.bf = bf;
  c.c0 = (tile - bf * tiles) * 32 * V + static_cast<int>(threadIdx.x & 31) * V;
  c.valid = channels - c.c0 < 0 ? 0 : (channels - c.c0 > V ? V : channels - c.c0);
  c.full = c.valid == V && channels % V == 0;
  c.vec = c.full && aligned16(x);
  c.step = static_cast<long long>(flen) * channels;
  c.offset = (static_cast<long long>(b) * tlen * flen + f) * channels + c.c0;
  c.mask = mask != nullptr ? mask + static_cast<long long>(b) * tlen : nullptr;
  return c;
}

// Start copying rows t0 .. t0 + n - 1 of the column into the slab (this
// thread's rows; asynchronously where it can) and their mask values into
// msk (1 without a mask). The caller commits and waits.
template <typename T>
__device__ __forceinline__ void issue(const T* __restrict__ x, const Column& c, int t0, int n,
                                      const Smem& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += kWarps) {
    unsigned char* dst = s.slab + r * kRowBytes + lane * 16;
    const T* src = x + c.offset + (t0 + r) * c.step;
    if (c.vec) {
      cp_async16(dst, src);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int j = 0; j < Lane<T>::V; ++j) d[j] = j < c.valid ? src[j] : from_f<T>(0.f);
    }
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (c.mask != nullptr)
      cp_async4(s.msk + i, c.mask + t0 + i);
    else
      s.msk[i] = 1.f;
  }
}

// Walk this thread's rows of the column in time order, calling
// body(t, m, v) with the mask value and the lane's V values in fp32. On the
// ring the slab holds the column already; off it, each chunk is copied in
// first (every pass).
template <typename T, class Body>
__device__ __forceinline__ void sweep(const T* __restrict__ x, const Column& c, int tlen,
                                      const Smem& s, Body body) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = slab_rows(tlen);
  for (int t0 = 0; t0 < tlen; t0 += rows) {
    const int n = min(rows, tlen - t0);
    if (!on_ring(tlen)) {
      __syncthreads();  // every warp is done with the slab's last rows and mask
      issue(x, c, t0, n, s);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll 4
    for (int r = warp; r < n; r += kWarps) {
      float v[Lane<T>::V];
      load16(reinterpret_cast<const T*>(s.slab + r * kRowBytes + lane * 16), v);
      body(t0 + r, s.msk[r], v);
    }
  }
}

// Sum acc over the CTA's warps in warp order; every thread gets the totals
// of its lane's channels. part: kWarps x N x 32 floats.
template <int N>
__device__ __forceinline__ void sum_warps(float (&acc)[N], float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) part[(warp * N + j) * 32 + lane] = acc[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = part[j * 32 + lane];
    for (int w = 1; w < kWarps; ++w) s += part[(w * N + j) * 32 + lane];
    acc[j] = s;
  }
  __syncthreads();  // the next pass writes part again
}

// The fp32 moments of this lane's V channels over the column, as the JAX
// package's _masked_moments computes them: denom = max(sum(m), 1), mean =
// sum(x * m) / denom, var = sum((x - mean)^2 * m) / denom, two passes over
// the slab.
template <typename T>
__device__ __forceinline__ void moments(const T* __restrict__ x, const Column& c, int tlen,
                                        const Smem& s, float (&mean)[Lane<T>::V],
                                        float (&var)[Lane<T>::V], float& denom) {
  constexpr int V = Lane<T>::V;
  float acc[V + 1];  // sum(x * m) per channel, then sum(m)
#pragma unroll
  for (int j = 0; j <= V; ++j) acc[j] = 0.f;
  sweep(x, c, tlen, s, [&](int, float m, const float* v) {
    acc[V] += m;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fmaf_rn(v[j], m, acc[j]);
  });
  sum_warps(acc, s.part);
  denom = fmaxf(acc[V], 1.f);
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = acc[j] / denom;

  float sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sq[j] = 0.f;
  sweep(x, c, tlen, s, [&](int, float m, const float* v) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - mean[j];
      sq[j] = __fmaf_rn(__fmul_rn(d, d), m, sq[j]);
    }
  });
  sum_warps(sq, s.part);
#pragma unroll
  for (int j = 0; j < V; ++j) var[j] = sq[j] / denom;
}

// Run body(c, s) on every tile of this CTA (tiles blockIdx.x, + gridDim.x,
// ...). On the ring, the tile's slab s is staged when body runs and the
// next kStages - 1 tiles' copies are in flight; off it, body's sweeps stream
// the column through the one slab.
template <typename T, class Body>
__device__ __forceinline__ void for_each_tile(const T* __restrict__ x, const float* mask,
                                              int batch, int tlen, int flen, int channels,
                                              unsigned char* smem, Body body) {
  const int ntiles = batch * flen * tiles_per_row(channels, Lane<T>::V);
  const int first = blockIdx.x, step = gridDim.x;
  if (!on_ring(tlen)) {
    const Smem s = carve<T>(smem, tlen, 0);
    for (int tile = first; tile < ntiles; tile += step)
      body(column(x, mask, tlen, flen, channels, tile), s);
    return;
  }
  // the k-th tile of this CTA goes to slab k % kStages; one commit group a
  // tile (empty past the last), so wait_group counts tiles
  auto stage = [&](int k) {
    const int tile = first + k * step;
    if (tile < ntiles)
      issue(x, column(x, mask, tlen, flen, channels, tile), 0, tlen,
            carve<T>(smem, tlen, k % kStages));
    cp_async_commit();
  };
  for (int k = 0; k < kStages - 1; ++k) stage(k);
  for (int k = 0, tile = first; tile < ntiles; ++k, tile += step) {
    stage(k + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile k's copies (every thread's) have landed
    body(column(x, mask, tlen, flen, channels, tile), carve<T>(smem, tlen, k % kStages));
    __syncthreads();  // slab k % kStages is free for the next iteration's copies
  }
}

// Launch `kernel` with one persistent CTA for each CTA the card holds at
// once (at most one a tile), with the shared memory of time length tlen.
template <typename T, class Kernel, class... Args>
__host__ inline int launch_persistent(Kernel kernel, int batch, int tlen, int flen, int channels,
                                      cudaStream_t stream, Args... args) {
  const long long ntiles =
      static_cast<long long>(batch) * flen * tiles_per_row(channels, Lane<T>::V);
  if (ntiles == 0) return 0;
  if (ntiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(tlen);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long grid = static_cast<long long>(sms) * per_sm < ntiles
                             ? static_cast<long long>(sms) * per_sm
                             : ntiles;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(args..., batch, tlen, flen,
                                                                   channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pool
}  // namespace vsv
