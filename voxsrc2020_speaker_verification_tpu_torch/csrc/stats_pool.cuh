// The column walk of the masked statistics pool, shared by K4
// (stats_pool.cu) and K4b (stats_pool_bwd.cu): both compute the moments
// through moments() below, so K4b's mean and std are K4's, bit for bit.
//
// Work unit: a (b, f, channel tile). In channels-last memory (B, T, F, C) a
// tile's time row is contiguous and rows lie F*C elements apart. A tile row
// is RB bytes: RB / 16 lanes each own the V = 16 / sizeof(T) channels of one
// 16-byte access, and a warp covers 32 * 16 / RB rows at once. The tile's
// column (T rows of RB bytes) is staged into shared memory and every pass
// reads it there.
//
// The launch plan is ops/nn.py:stats_pool_plan; the C entries take it as
// five ints (design, RB, slab rows, stages, shared memory) and refuse a
// plan that is not one of the designs below at this T, or whose shared
// memory differs from the layout here. Three designs:
// - ring (T <= kRingRows = 128, the Res2Net heads at W = 10): 512-byte rows
//   (a warp a row), the whole column in one slab, a ring of kStages slabs
//   filled by 16-byte cp.async, each lane reading back only its own bytes.
// - column (longer columns while two slabs fit: T up to ~3,100 rows): the
//   W = 1 heads of TDNN and ECAPA (1536 channels, T = 200-1000). The first
//   design streamed such a column through one 128-row slab once a pass with
//   blocking copies (x left HBM two or three times, no copy overlapped
//   arithmetic: 0.65 ms at TDNN's head against a 0.30 ms bound). Here the
//   whole column stays in a slab, in kColumnStages = 2 slabs (the next
//   tile's copies in flight), at 128-, 64- or 32-byte tile rows: the widest that leaves room
//   for two CTAs an SM (TDNN's and ECAPA's heads at 128 bytes, a 1000-row
//   bucket at 32). What this design had to fix, measured on an H100 (PERF.md):
//   * Copies: the Tensor Memory Accelerator copies a tile as up to four
//     boxes of its 4-D tensor map (C, F, T, B), thread 0 issuing them on
//     the slab's mbarrier. Per-thread cp.async of the same rows ran 1.2x
//     slower (3 slabs, PERF.md), and 1-D bulk copies of one row each (128
//     bytes) slower still (the copy engine's cost a request).
//     Rows whose bytes are no multiple of 16, or an x that is not 16-byte
//     aligned, fall back to cp.async.
//   * Issue: with ~10-20 rows a thread a pass, a tile's fixed work (the
//     cross-lane sums and 2 x V fp32 divisions in every thread) was most of
//     its instructions; quotients() does each channel's warp sums and
//     division once, in one thread, and the others read the quotient.
//   * Occupancy: two slabs and two or more CTAs an SM (the two-slab ring at
//     128-byte rows) beat three slabs at one CTA an SM.
//   A cluster spreading one column's rows over several CTAs was not built:
//   the narrow tiles need no cross-CTA sums.
// - stream (longer columns): 128-byte rows in chunks of kStreamRows through
//   kStreamStages slabs, the next chunk's copies in flight while a pass
//   reduces this one; x leaves HBM once a pass (two in K4, three in K4b).
// In the ring and column designs persistent CTAs, as many as the card holds
// at once, each walk their tiles (blockIdx.x, + gridDim.x, ...) through the
// ring of slabs, and x leaves HBM once.
//
// Order: a thread adds its rows in time order (row lane q of the CTA takes
// rows q, q + R, ..., R = kWarps * 32 * 16 / RB row lanes); the lanes of a
// warp that hold the same channels add by a butterfly (each gets the same
// sum: a + b == b + a), and the warps' sums are added in warp order. Reruns
// agree bit for bit, and so do K4 and K4b. At RB = 512 the butterfly is
// empty: the ring design adds exactly as its first version did.
//
// Any input: a lane whose channels pass C, or whose rows are not 16-byte
// aligned, copies element by element (zeros past C) and stores only its
// channels inside C (a tensor copy fills channels past C with zeros);
// masked rows are multiplied by their 0/1 (or weight) value like every
// other row, never skipped.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "tma.cuh"

namespace vsv {
namespace pool {

// Warps a CTA: 8 and 16 were slower at every main shape (each tile pays
// barriers and cross-warp sums once per warp).
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;        // slabs of the ring design
constexpr int kColumnStages = 2;  // slabs of the column design
constexpr int kRingRows = 128;    // the ring design's longest column
constexpr int kRingRowBytes = 512;
constexpr int kStreamStages = 2;  // chunks of the stream design in flight
constexpr int kStreamRows = 256;  // rows a chunk of the stream design
constexpr int kStreamRowBytes = 128;
constexpr int kBoxMax = 256;      // rows of one tensor copy at most (the TMA's box limit)
constexpr int kAlign = 128;       // the column design's slabs start 128-byte aligned
// a CTA's dynamic shared memory: the H100's 232,448 bytes less 1 KB for the
// static shared memory (the slabs' mbarriers)
constexpr int kSmemMax = 232448 - 1024;

enum Design { kRing = 0, kColumn = 1, kStream = 2 };

// A tile of RB-byte rows of T: V channels a lane, L lanes a row, RPW rows a
// warp, R row lanes a CTA, C channels a tile.
template <typename T, int RB>
struct Tile {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int L = RB / 16;
  static constexpr int RPW = 32 / L;
  static constexpr int R = kWarps * RPW;
  static constexpr int C = RB / sizeof(T);
  static_assert(RB == 32 || RB == 64 || RB == 128 || RB == 512, "tile rows");
  // the column design's quotients fit the partial sums' buffer beside them
  static_assert(RB == 512 || (kWarps + 1) * (V + 1) * L <= kWarps * (V + 1) * 32, "quotients");
};

// The plan as the C entries take it (ops/nn.py:stats_pool_plan).
struct Plan {
  int design, row_bytes, rows, stages, smem;
};

__host__ __device__ __forceinline__ int tiles_per_row(int channels, int tile_channels) {
  return (channels + tile_channels - 1) / tile_channels;
}

// Dynamic shared memory of one CTA, 16-byte aligned parts: the slabs
// (stages x rows x RB), the warps' partial sums (kWarps x (V + 1) x 32
// floats), and each slab's mask rows.
template <typename T>
__host__ __device__ __forceinline__ size_t part_bytes() {
  return static_cast<size_t>(kWarps) * (16 / sizeof(T) + 1) * 32 * sizeof(float);
}
__host__ __device__ __forceinline__ size_t mask_bytes(int rows) {
  return static_cast<size_t>((rows + 3) / 4) * 16;
}
template <typename T>
__host__ __device__ __forceinline__ size_t smem_bytes(int stages, int rows, int row_bytes,
                                                      int pad = 0) {
  return static_cast<size_t>(stages) *
             (static_cast<size_t>(rows) * row_bytes + mask_bytes(rows)) +
         part_bytes<T>() + pad;
}

// The column design's tensor copies: a column of tlen rows arrives as
// box_count boxes of box_rows rows (a multiple of 4, so each box lands
// 128-byte aligned); a slab holds their column_rows rows (>= tlen: the
// rows past T come as zeros and are not read).
__host__ __device__ __forceinline__ int box_count(int tlen) {
  return (tlen + kBoxMax - 1) / kBoxMax;
}
__host__ __device__ __forceinline__ int box_rows(int tlen) {
  const int n = box_count(tlen);
  return ((tlen + n - 1) / n + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int column_rows(int tlen) {
  return box_count(tlen) * box_rows(tlen);
}

// The plan's layout for time length tlen, or false where the plan is not
// one of the three designs at this T (the entries then refuse it).
template <typename T>
inline bool plan_ok(const Plan& p, int tlen) {
  bool ok = false;
  if (p.design == kRing)
    ok = tlen <= kRingRows && p.row_bytes == kRingRowBytes && p.rows == tlen &&
         p.stages == kStages;
  else if (p.design == kColumn)
    ok = tlen > kRingRows && p.rows == column_rows(tlen) && p.stages == kColumnStages &&
         (p.row_bytes == 128 || p.row_bytes == 64 || p.row_bytes == 32);
  else if (p.design == kStream)
    ok = tlen > kRingRows && p.rows == kStreamRows && p.stages == kStreamStages &&
         p.row_bytes == kStreamRowBytes;
  const int pad = p.design == kColumn ? kAlign : 0;
  return ok &&
         smem_bytes<T>(p.stages, p.rows, p.row_bytes, pad) == static_cast<size_t>(p.smem) &&
         p.smem <= kSmemMax;
}

// One slab (its rows and its mask values) and the partial sums.
struct Smem {
  unsigned char* slab;
  float* part;
  float* msk;
};

template <typename T, int RB>
__device__ __forceinline__ Smem carve(unsigned char* smem, int stages, int rows, int slab) {
  const size_t slabs = static_cast<size_t>(stages) * rows * RB;
  unsigned char* part = smem + slabs;
  unsigned char* msk = part + part_bytes<T>() + slab * mask_bytes(rows);
  return {smem + static_cast<size_t>(slab) * rows * RB, reinterpret_cast<float*>(part),
          reinterpret_cast<float*>(msk)};
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
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j) v[j] = j < valid ? to_f(p[j]) : 0.f;
}
template <typename T>
__device__ __forceinline__ void store_lane(T* p, const float* v, int valid, bool vec) {
  if (vec) {
    store16(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
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

// x (B, T, F, C) as the Tensor Memory Accelerator's 4-D map (C, F, T, B),
// boxes of (tile_channels, 1, rows, 1), channels and rows past x's read as
// zeros; false where x's rows do not allow one (x not 16-byte aligned, or
// C * sizeof(T) no multiple of 16) or the CUDA runtime finds no encoder.
template <typename T>
inline bool tensor_map(CUtensorMap* map, const void* x, int batch, int tlen, int flen,
                       int channels, int tile_channels, int rows) {
  const unsigned long long dims[4] = {static_cast<unsigned long long>(channels),
                                      static_cast<unsigned long long>(flen),
                                      static_cast<unsigned long long>(tlen),
                                      static_cast<unsigned long long>(batch)};
  const unsigned long long strides[3] = {dims[0], dims[0] * dims[1], dims[0] * dims[1] * dims[2]};
  const unsigned box[4] = {static_cast<unsigned>(tile_channels), 1, static_cast<unsigned>(rows),
                           1};
  return tma::encode(map,
                     sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     sizeof(T), 4, x, dims, strides, box);
}

// One thread's share of a tile.
struct Column {
  long long bf;      // b * F + f: the pooled output row
  int b, f;
  long long offset;  // element (b, t = 0, f, c0) of x (and of dx)
  long long step;    // F * C: elements between time rows
  const float* mask; // the batch row's mask (T values), or null
  int c0;
  int valid;         // channels c0 .. c0 + valid - 1 lie inside C (0..V)
  int row;           // the thread's row lane: rows row, row + R, ...
  int sub;           // the thread's 16-byte piece of a tile row
  bool full;         // valid == V and C % V == 0: 16 bytes where a base is aligned
  bool vec;          // x's rows by 16-byte cp.async
};

// (32-bit index math: the launcher refuses more than 2^30 tiles)
template <typename T, int RB>
__device__ __forceinline__ Column column(const T* x, const float* mask, int tlen, int flen,
                                         int channels, int tile) {
  using K = Tile<T, RB>;
  const int tiles = tiles_per_row(channels, K::C);
  const int bf = tile / tiles;
  const int b = bf / flen;
  const int f = bf - b * flen;
  const int lane = threadIdx.x & 31;
  Column c;
  c.bf = bf;
  c.b = b;
  c.f = f;
  c.sub = lane % K::L;
  c.row = (threadIdx.x >> 5) * K::RPW + lane / K::L;
  c.c0 = (tile - bf * tiles) * K::C + c.sub * K::V;
  c.valid = channels - c.c0 < 0 ? 0 : (channels - c.c0 > K::V ? K::V : channels - c.c0);
  c.full = c.valid == K::V && channels % K::V == 0;
  c.vec = c.full && aligned16(x);
  c.step = static_cast<long long>(flen) * channels;
  c.offset = (static_cast<long long>(b) * tlen * flen + f) * channels + c.c0;
  c.mask = mask != nullptr ? mask + static_cast<long long>(b) * tlen : nullptr;
  return c;
}

// Start copying rows t0 .. t0 + n - 1 of the column into the slab (this
// thread's rows; asynchronously where it can) and their mask values into
// msk (1 without a mask). The caller commits and waits.
template <typename T, int RB>
__device__ __forceinline__ void issue(const T* __restrict__ x, const Column& c, int t0, int n,
                                      const Smem& s) {
  using K = Tile<T, RB>;
  for (int r = c.row; r < n; r += K::R) {
    unsigned char* dst = s.slab + r * RB + c.sub * 16;
    const T* src = x + c.offset + (t0 + r) * c.step;
    if (c.vec) {
      cp_async16(dst, src);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int j = 0; j < K::V; ++j) d[j] = j < c.valid ? src[j] : from_f<T>(0.f);
    }
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (c.mask != nullptr)
      cp_async4(s.msk + i, c.mask + t0 + i);
    else
      s.msk[i] = 1.f;
  }
}

// The column design's staging: with a tensor map (`tma`), the tile's rows as
// box_count(tlen) tensor copies issued by thread 0, completing on `bar`,
// which it arms with their bytes (whole boxes: the rows past T and the
// channels past C come as zeros); the mask values as issue() copies them.
// Without one the rows go as issue() copies them and thread 0 arrives on
// `bar` with no bytes, so the consumer waits on the same barrier either way.
template <typename T, int RB>
__device__ __forceinline__ void issue_tile(const T* __restrict__ x, const Column& c, int tlen,
                                           bool tma, const CUtensorMap* map, const Smem& s,
                                           uint64_t* bar) {
  using K = Tile<T, RB>;
  if (!tma) {
    issue<T, RB>(x, c, 0, tlen, s);
    if (threadIdx.x == 0) tma::mbar_arrive(bar);
    return;
  }
  if (threadIdx.x == 0) {
    // the slab's last reads (generic proxy, before the caller's barrier)
    // come before these copies' writes (async proxy)
    tma::fence_async();
    const int boxes = box_count(tlen), rows = box_rows(tlen);
    tma::mbar_expect(bar, static_cast<uint32_t>(boxes * rows * RB));
    for (int i = 0; i < boxes; ++i)
      tma::copy_4d(s.slab + i * rows * RB, map, c.c0 - c.sub * K::V, c.f, i * rows, c.b, bar);
  }
  for (int i = threadIdx.x; i < tlen; i += kThreads) {
    if (c.mask != nullptr)
      cp_async4(s.msk + i, c.mask + i);
    else
      s.msk[i] = 1.f;
  }
}

// Call body(t, m, v) for each of this thread's rows t0 .. t0 + n - 1 of the
// slab in time order, with the mask value and the lane's V values in fp32.
template <typename T, int RB, class Body>
__device__ __forceinline__ void read_slab(const Column& c, int t0, int n, const Smem& s,
                                          Body& body) {
  using K = Tile<T, RB>;
#pragma unroll 4
  for (int r = c.row; r < n; r += K::R) {
    float v[K::V];
    load16(reinterpret_cast<const T*>(s.slab + r * RB + c.sub * 16), v);
    body(t0 + r, s.msk[r], v);
  }
}

// Walk this thread's rows of the column in time order (see read_slab). In
// the ring and column designs the slab s holds the column already; in the
// stream design the column passes through the kStreamStages slabs from smem
// in chunks, the next chunk's copies in flight while this one is read.
template <typename T, int RB, bool Stream, class Body>
__device__ __forceinline__ void sweep(const T* __restrict__ x, const Column& c, int tlen,
                                      const Smem& s, unsigned char* smem, Body body) {
  if constexpr (!Stream) {
    read_slab<T, RB>(c, 0, tlen, s, body);
  } else {
    auto slab = [&](int i) { return carve<T, RB>(smem, kStreamStages, kStreamRows, i & 1); };
    const int chunks = (tlen + kStreamRows - 1) / kStreamRows;
    issue<T, RB>(x, c, 0, min(kStreamRows, tlen), slab(0));
    cp_async_commit();
    for (int i = 0; i < chunks; ++i) {
      const int t0 = i * kStreamRows, n = min(kStreamRows, tlen - t0);
      if (i + 1 < chunks)
        issue<T, RB>(x, c, t0 + kStreamRows, min(kStreamRows, tlen - t0 - kStreamRows),
                     slab(i + 1));
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // chunk i's copies (every thread's) have landed
      read_slab<T, RB>(c, t0, n, slab(i), body);
      __syncthreads();  // its slab is free for chunk i + 2
    }
  }
}

// Sum acc over the CTA's row lanes; every thread gets the totals of its
// lane's channels. part: kWarps x N x 32 floats.
template <int N, int L>
__device__ __forceinline__ void sum_rows(float (&acc)[N], float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off >= L; off >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  if (lane < L) {
#pragma unroll
    for (int j = 0; j < N; ++j) part[(warp * N + j) * L + lane] = acc[j];
  }
  __syncthreads();
  const int sub = lane % L;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = part[j * L + sub];
    for (int w = 1; w < kWarps; ++w) s += part[(w * N + j) * L + sub];
    acc[j] = s;
  }
  __syncthreads();  // the next pass writes part again
}

// The column design's form of sum_rows and the division that follows it:
// the lanes of a warp that hold the same channels add by the butterfly, the
// warps' sums go to `part`, and thread i < L * V (channel lane i % L, value
// i / L) adds them in warp order and divides by the denominator, which in
// the first pass (First) is max(its own sum of the mask values, 1); every
// thread then reads its lane's V quotients (and the denominator) from q.
// The sums and quotients are sum_rows's, bit for bit; the divisions and the
// warps' sums run once a channel instead of once a row lane.
template <int V, int L, bool First>
__device__ __forceinline__ void quotients(float (&acc)[V + (First ? 1 : 0)], float* part,
                                          float* q, float (&out)[V], float& denom) {
  constexpr int N = V + (First ? 1 : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off >= L; off >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  if (lane < L) {
#pragma unroll
    for (int j = 0; j < N; ++j) part[(warp * N + j) * L + lane] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < L * V) {
    const int sub = threadIdx.x % L, j = threadIdx.x / L;
    float sum = part[j * L + sub];
    for (int w = 1; w < kWarps; ++w) sum += part[(w * N + j) * L + sub];
    float d = denom;
    if constexpr (First) {
      float m = part[V * L + sub];
      for (int w = 1; w < kWarps; ++w) m += part[(w * N + V) * L + sub];
      d = fmaxf(m, 1.f);
      if (j == 0) q[V * L + sub] = d;
    }
    q[j * L + sub] = sum / d;
  }
  __syncthreads();
  const int sub = lane % L;
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = q[j * L + sub];
  if constexpr (First) denom = q[V * L + sub];
}

// The fp32 moments of this lane's V channels over the column, as the JAX
// package's _masked_moments computes them: denom = max(sum(m), 1), mean =
// sum(x * m) / denom, var = sum((x - mean)^2 * m) / denom, two passes.
template <typename T, int RB, bool Stream>
__device__ __forceinline__ void moments(const T* __restrict__ x, const Column& c, int tlen,
                                        const Smem& s, unsigned char* smem,
                                        float (&mean)[Tile<T, RB>::V],
                                        float (&var)[Tile<T, RB>::V], float& denom) {
  using K = Tile<T, RB>;
  constexpr int V = K::V;
  float acc[V + 1];  // sum(x * m) per channel, then sum(m)
#pragma unroll
  for (int j = 0; j <= V; ++j) acc[j] = 0.f;
  sweep<T, RB, Stream>(x, c, tlen, s, smem, [&](int, float m, const float* v) {
    acc[V] += m;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fmaf_rn(v[j], m, acc[j]);
  });
  // the column design's quotients go to the partial sums' unused tail
  float* q = s.part + kWarps * (V + 1) * K::L;
  if constexpr (RB != kRingRowBytes && !Stream) {
    quotients<V, K::L, true>(acc, s.part, q, mean, denom);
  } else {
    sum_rows<V + 1, K::L>(acc, s.part);
    denom = fmaxf(acc[V], 1.f);
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = acc[j] / denom;
  }

  float sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sq[j] = 0.f;
  sweep<T, RB, Stream>(x, c, tlen, s, smem, [&](int, float m, const float* v) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - mean[j];
      sq[j] = __fmaf_rn(__fmul_rn(d, d), m, sq[j]);
    }
  });
  if constexpr (RB != kRingRowBytes && !Stream) {
    quotients<V, K::L, false>(sq, s.part, q, var, denom);
  } else {
    sum_rows<V, K::L>(sq, s.part);
#pragma unroll
    for (int j = 0; j < V; ++j) var[j] = sq[j] / denom;
  }
}

// Run body(c, s) on every tile of this CTA (tiles blockIdx.x, + gridDim.x,
// ...). In the ring and column designs the tile's slab s is staged when
// body runs and the next kStages - 1 tiles' copies are in flight; in the
// stream design body's sweeps stream the column through the slabs.
template <typename T, int RB, bool Stream, class Body>
__device__ __forceinline__ void for_each_tile(const T* __restrict__ x, const float* mask,
                                              int batch, int tlen, int flen, int channels,
                                              bool tma, const CUtensorMap* map, int slab_rows,
                                              unsigned char* smem, Body body) {
  const int ntiles = batch * flen * tiles_per_row(channels, Tile<T, RB>::C);
  const int first = blockIdx.x, step = gridDim.x;
  if constexpr (Stream) {
    const Smem s = carve<T, RB>(smem, kStreamStages, kStreamRows, 0);
    for (int tile = first; tile < ntiles; tile += step)
      body(column<T, RB>(x, mask, tlen, flen, channels, tile), s);
  } else {
    // the ring design stages by cp.async in kStages slabs; the column
    // design by tensor copies (issue_tile) in kColumnStages, each slab's
    // completion on its mbarrier (phase: the slab's use count & 1), its
    // slabs from a 128-byte boundary
    constexpr bool kCol = RB != kRingRowBytes;
    constexpr int S = kCol ? kColumnStages : kStages;
    __shared__ __align__(8) uint64_t bars[S];
    unsigned char* base = smem;
    if constexpr (kCol) {
      base = reinterpret_cast<unsigned char*>(
          (reinterpret_cast<uintptr_t>(smem) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));
      if (threadIdx.x == 0) {
        for (int i = 0; i < S; ++i) tma::mbar_init(&bars[i]);
        tma::mbar_init_fence();
      }
      __syncthreads();
    }
    // the k-th tile of this CTA goes to slab k % S; one commit group a tile
    // (empty past the last), so wait_group counts tiles
    auto stage = [&](int k) {
      const int tile = first + k * step;
      if (tile < ntiles) {
        const Column c = column<T, RB>(x, mask, tlen, flen, channels, tile);
        const Smem s = carve<T, RB>(base, S, slab_rows, k % S);
        if constexpr (kCol)
          issue_tile<T, RB>(x, c, tlen, tma, map, s, &bars[k % S]);
        else
          issue<T, RB>(x, c, 0, tlen, s);
      }
      cp_async_commit();
    };
    for (int k = 0; k < S - 1; ++k) stage(k);
    for (int k = 0, tile = first; tile < ntiles; ++k, tile += step) {
      stage(k + S - 1);
      cp_async_wait<S - 1>();
      if constexpr (kCol) tma::mbar_wait(&bars[k % S], (k / S) & 1);
      __syncthreads();  // tile k's copies (every thread's) have landed
      body(column<T, RB>(x, mask, tlen, flen, channels, tile),
           carve<T, RB>(base, S, slab_rows, k % S));
      __syncthreads();  // slab k % S is free for the next iteration's copies
    }
  }
}

// Launch `kernel` with one persistent CTA for each CTA the card holds at
// once (at most one a tile), with the plan's shared memory.
template <typename T, int RB, class Kernel, class... Args>
__host__ inline int launch_persistent(Kernel kernel, const Plan& plan, int batch, int tlen,
                                      int flen, int channels, cudaStream_t stream,
                                      Args... args) {
  const long long ntiles =
      static_cast<long long>(batch) * flen * tiles_per_row(channels, Tile<T, RB>::C);
  if (ntiles == 0) return 0;
  if (ntiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(plan.smem);
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

// The template arguments <RB, Stream> of the plan's design: (512, ring),
// (128 | 64 | 32, column), (128, stream) as variant 0-4.
inline int variant(const Plan& plan) {
  if (plan.design == kRing) return 0;
  if (plan.design == kStream) return 4;
  return plan.row_bytes == 128 ? 1 : (plan.row_bytes == 64 ? 2 : 3);
}

}  // namespace pool
}  // namespace vsv
