// K7: sliding-window cepstral mean (and variance) normalization over time.
//
// Replaces: voxsrc2020_speaker_verification_tpu/ops/cmvn.py:sliding_cmvn
// (lines 29-87), which XLA computed on the TPU as one float32 cumulative sum
// over the whole utterance plus two gathers.
//
// Input (B, T, F) float32, contiguous; num_valid (B,) int32 or null (every
// frame valid). For frame t of an utterance with n valid frames the window
// is [start, end):
//
//   centred:  start = clip(t - w/2, 0, max(0, n - w)),  end = min(start + w, n)
//   trailing: end   = min(max(t + 1, min(min_window, n)), n)
//             start = min(max(t - w + 1, 0), max(end - w, 0))
//
//   y[t] = x[t] - mean(x[start:end])
//   y[t] = y[t] * rsqrt(max(var(x[start:end]), 1e-10))      (norm_vars)
//
// with count max(end - start, 1). The window never reaches past n, so padded
// frames (t >= n) add nothing; they are normalized with the last window's
// statistics, as the JAX version does.
//
// Bound on the card: bytes (x read once and y written once, a few float64
// operations a value). The launch plan (tt, fb, seg, staged and the shared
// memory it takes) comes from ops/cmvn.py:sliding_cmvn_plan; this entry
// point recomputes the shared memory from it and refuses a plan that
// differs (vsv::kPlanMismatch). The design:
//
// * One CTA a (utterance, tile of tt frames, group of fb bins), 256
//   threads: 512 x 8 where the batch gives two such CTAs an SM, else
//   256 x 16. Both window edges are monotone in t and move by at most one
//   row a frame, so the windows of the tile's frames [t0, t1) together
//   cover [start(t0), end(t1 - 1)) inside [0, n): at most tt - 1 + reach
//   rows, reach = w for the centred rule and max(w, min(min_window, T)) for
//   the trailing one (extent_rows). The extent depends on n, which lives on
//   the card: each CTA reads n first and computes its own. For a tile past
//   n it is the last window, [n - w, n), which can lie thousands of rows to
//   the left of the tile.
// * The extent's fb columns are staged into shared memory once, by 16-byte
//   cp.async (4-byte where F is not a multiple of 4): an interior tile
//   reads (tt + w) / tt of its share of x. Frames of the tile past n are
//   outside the extent and read their own x once, coalesced, from global
//   memory.
// * Window sums from float64 prefixes, in three steps: a thread sums a
//   segment of seg rows of one bin; one warp a bin scans the segment
//   totals with shuffles (P at each segment's first row); then a thread
//   walks seg output frames of one bin, its two window edges starting from
//   P at the segment base plus the rows before the edge. A walk takes one
//   of three paths, fixed by its first and last frame: one window for
//   every frame (the padding past n), both edges moving one row a frame
//   (the interior: two shared-memory reads and a few float64 operations a
//   frame), or the window rule frame by frame (near the clipped ends). So
//   no thread walks more than seg frames, and each output is (P[end] -
//   P[start]) * (1 / count) of exact float64 sums: its error does not grow
//   with T (a float32 cumulative sum over a 16000-frame utterance drifts to
//   ~1.5e-4 on features of 12 +- 3). No atomics: each output has one order
//   of additions, and reruns are bit-equal.
// * seg is odd, so the rows that a warp's lanes read (16 bins of two
//   segments, or 8 of four) fall on 32 distinct banks.
// * Where the extent does not fit shared memory (windows of thousands of
//   frames), the plan says staged = 0: the same steps read the rows from
//   global memory (L2), and only the segment prefixes live in shared memory.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kSmemMax = 232448;  // the most one block can take on sm_90

__host__ __device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// Rows of the largest extent of a tile of tt frames (see above).
__host__ __device__ __forceinline__ long long extent_rows(int tlen, int tt, int window, int center,
                                                          int min_window) {
  const long long reach = center ? window : lmax(window, lmin(min_window, tlen));
  return lmin(tlen, tt - 1 + reach);
}

// Shared memory: the staged rows (fb floats each) and, for each bin, the
// float64 prefix at each segment's first row and at the extent's end (and
// the same of x^2 with norm_vars).
__host__ __device__ __forceinline__ long long prefix_entries(long long rows, int seg) {
  return (rows + seg - 1) / seg + 1;
}
__host__ __device__ __forceinline__ long long smem_bytes(long long rows, int fb, int seg,
                                                         int staged, int norm_vars) {
  return (staged ? rows * fb * 4 : 0) + prefix_entries(rows, seg) * fb * 8 * (norm_vars ? 2 : 1);
}

__device__ __forceinline__ void window_at(int t, int n, int w, int center, int min_window,
                                          int* start, int* end) {
  if (center) {
    const int s = min(max(t - w / 2, 0), max(0, n - w));
    *start = s;
    *end = min(s + w, n);
  } else {
    const int e = min(max(t + 1, min(min_window, n)), n);
    *start = min(max(t - w + 1, 0), max(e - w, 0));
    *end = e;
  }
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

// Inclusive scan of col[k * stride], k = 1..segs, by one warp in a fixed
// order (col[0] is 0).
__device__ __forceinline__ void scan_column(double* col, int stride, int segs, int lane) {
  double carry = 0.0;
  for (int k0 = 1; k0 <= segs; k0 += 32) {
    const int k = k0 + lane;
    double v = k <= segs ? col[k * stride] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (k <= segs) col[k * stride] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

template <bool kVars, bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
    sliding_cmvn_kernel(const float* __restrict__ x, const int* __restrict__ num_valid,
                        float* __restrict__ out, int tlen, int flen, int tt, int fb, int seg,
                        int tiles, int groups, int rows_max, int window, int center,
                        int min_window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x % groups;
  const int tile = (blockIdx.x / groups) % tiles;
  const int b = blockIdx.x / groups / tiles;
  const int n = num_valid != nullptr ? min(max(num_valid[b], 0), tlen) : tlen;
  const int t0 = tile * tt, t1 = min(t0 + tt, tlen);
  const int f0 = g * fb, nf = min(fb, flen - f0);
  int r0, r1, unused;
  window_at(t0, n, window, center, min_window, &r0, &unused);
  window_at(t1 - 1, n, window, center, min_window, &unused, &r1);
  const int rows = r1 - r0;  // <= rows_max
  const int segs = (rows + seg - 1) / seg;

  const long long base = static_cast<long long>(b) * tlen * flen + f0;  // x[b, 0, f0]
  const float* xg = x + base + static_cast<long long>(r0) * flen;       // x[b, r0, f0]
  float* xs = reinterpret_cast<float*>(smem);
  const size_t staged_bytes = kStaged ? static_cast<size_t>(rows_max) * fb * 4 : 0;
  double* ps = reinterpret_cast<double*>(smem + staged_bytes);
  double* qs = ps + static_cast<size_t>(prefix_entries(rows_max, seg)) * fb;
  // row r of the extent (relative to r0), bin f of the group
  auto at = [&](int r, int f) -> double {
    if constexpr (kStaged) return xs[r * fb + f];
    else return xg[static_cast<long long>(r) * flen + f];
  };

  if constexpr (kStaged) {
    if (flen % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
      const int q = nf / 4;  // fb and f0 are multiples of 4
      for (int i = threadIdx.x; i < rows * q; i += kThreads) {
        const int r = i / q, c = 4 * (i - r * q);
        cp_async16(xs + r * fb + c, xg + static_cast<long long>(r) * flen + c);
      }
    } else {
      for (int i = threadIdx.x; i < rows * nf; i += kThreads) {
        const int r = i / nf, c = i - r * nf;
        cp_async4(xs + r * fb + c, xg + static_cast<long long>(r) * flen + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  if (threadIdx.x < fb) {
    ps[threadIdx.x] = 0.0;
    if constexpr (kVars) qs[threadIdx.x] = 0.0;
  }
  __syncthreads();  // the staged rows

  // 1. segment totals, entry k + 1 of each bin
  for (int i = threadIdx.x; i < segs * fb; i += kThreads) {
    const int f = i % fb, k = i / fb;
    double s = 0.0, q = 0.0;
    if (f < nf) {
      const int end = min(k * seg + seg, rows);
      for (int r = k * seg; r < end; ++r) {
        const double v = at(r, f);
        s += v;
        if constexpr (kVars) q += v * v;
      }
    }
    ps[(k + 1) * fb + f] = s;
    if constexpr (kVars) qs[(k + 1) * fb + f] = q;
  }
  __syncthreads();

  // 2. prefixes at the segment bases: one warp a bin
  const int lane = threadIdx.x & 31;
  for (int f = threadIdx.x >> 5; f < nf; f += kThreads / 32) {
    scan_column(ps + f, fb, segs, lane);
    if constexpr (kVars) scan_column(qs + f, fb, segs, lane);
  }
  __syncthreads();

  // 3. walks of seg output frames of one bin
  const float* xb = x + base;
  float* ob = out + base;
  const int walks = (t1 - t0 + seg - 1) / seg;
  for (int i = threadIdx.x; i < walks * fb; i += kThreads) {
    const int f = i % fb;
    if (f >= nf) continue;
    const int ta = t0 + (i / fb) * seg, tb = min(ta + seg, t1);
    // frame t's output from its window's sums; inv = 1 / count
    auto emit = [&](int t, double sum, double sq, double inv) {
      const double mean = sum * inv;
      const double xt =
          t < n ? at(t - r0, f) : static_cast<double>(xb[static_cast<long long>(t) * flen + f]);
      double y = xt - mean;
      if constexpr (kVars) y *= rsqrt(fmax(sq * inv - mean * mean, 1e-10));
      ob[static_cast<long long>(t) * flen + f] = static_cast<float>(y);
    };
    int s, e, sb, eb;
    window_at(ta, n, window, center, min_window, &s, &e);
    window_at(tb - 1, n, window, center, min_window, &sb, &eb);
    // P and Q at the two edges, relative to r0
    double p_s, q_s = 0.0, p_e, q_e = 0.0;
    {
      const int ks = (s - r0) / seg, ke = (e - r0) / seg;
      p_s = ps[ks * fb + f];
      p_e = ps[ke * fb + f];
      if constexpr (kVars) {
        q_s = qs[ks * fb + f];
        q_e = qs[ke * fb + f];
      }
      for (int r = ks * seg; r < s - r0; ++r) {
        const double v = at(r, f);
        p_s += v;
        if constexpr (kVars) q_s += v * v;
      }
      for (int r = ke * seg; r < e - r0; ++r) {
        const double v = at(r, f);
        p_e += v;
        if constexpr (kVars) q_e += v * v;
      }
    }
    int count = max(e - s, 1);
    double inv = 1.0 / count;
    const int steps = tb - 1 - ta;
    if (sb == s && eb == e) {
      // one window for the whole walk (frames past n, utterances shorter than w)
      for (int t = ta; t < tb; ++t) emit(t, p_e - p_s, q_e - q_s, inv);
    } else if (sb - s == steps && eb - e == steps && eb - sb == e - s) {
      // the interior: both edges move by one row every frame (edges are
      // monotone and move by at most one a frame)
      for (int t = ta;; ++s, ++e) {
        emit(t, p_e - p_s, q_e - q_s, inv);
        if (++t == tb) break;
        const double ve = at(e - r0, f), vs = at(s - r0, f);
        p_e += ve;
        p_s += vs;
        if constexpr (kVars) {
          q_e += ve * ve;
          q_s += vs * vs;
        }
      }
    } else {
      // near the clipped ends: each frame's window by the rule
      for (int t = ta; t < tb; ++t) {
        int s2, e2;
        window_at(t, n, window, center, min_window, &s2, &e2);
        for (; e < e2; ++e) {
          const double v = at(e - r0, f);
          p_e += v;
          if constexpr (kVars) q_e += v * v;
        }
        for (; s < s2; ++s) {
          const double v = at(s - r0, f);
          p_s += v;
          if constexpr (kVars) q_s += v * v;
        }
        if (max(e - s, 1) != count) {
          count = max(e - s, 1);
          inv = 1.0 / count;
        }
        emit(t, p_e - p_s, q_e - q_s, inv);
      }
    }
  }
}

using KernelFn = void (*)(const float*, const int*, float*, int, int, int, int, int, int, int, int,
                          int, int, int);

}  // namespace

// x, out: (batch, tlen, flen) float32; num_valid: (batch,) int32 or null.
// tt, fb, seg, staged and plan_smem are ops/cmvn.py:sliding_cmvn_plan's: a
// plan whose shared memory differs from this layout's is refused
// (vsv::kPlanMismatch). One launch; refuses a window below 1, fb not a
// multiple of 4 in [4, 64], and more shared memory than one block has.
extern "C" int sliding_cmvn(const float* x, const int* num_valid, float* out, int batch,
                            int tlen, int flen, int window, int center, int norm_vars,
                            int min_window, int tt, int fb, int seg, int staged,
                            long long plan_smem, cudaStream_t stream) {
  if (window < 1 || batch < 0 || tlen < 0 || flen < 0) return vsv::kShapeUnsupported;
  if (batch == 0 || tlen == 0 || flen == 0) return 0;
  if (tt < 1 || seg < 1 || fb < 4 || fb > 64 || fb % 4 != 0) return vsv::kShapeUnsupported;
  const long long rows = extent_rows(tlen, tt, window, center, min_window);
  const long long smem = smem_bytes(rows, fb, seg, staged, norm_vars);
  if (smem != plan_smem) return vsv::kPlanMismatch;
  if (smem > kSmemMax) return vsv::kShapeUnsupported;
  const long long tiles = (tlen + tt - 1) / tt, groups = (flen + fb - 1) / fb;
  const long long blocks = static_cast<long long>(batch) * tiles * groups;
  if (blocks > 0x7fffffffLL) return vsv::kShapeUnsupported;
  const KernelFn kernel =
      norm_vars ? (staged ? sliding_cmvn_kernel<true, true> : sliding_cmvn_kernel<true, false>)
                : (staged ? sliding_cmvn_kernel<false, true> : sliding_cmvn_kernel<false, false>);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), stream>>>(
      x, num_valid, out, tlen, flen, tt, fb, seg, static_cast<int>(tiles),
      static_cast<int>(groups), static_cast<int>(rows), window, center, min_window);
  return static_cast<int>(cudaGetLastError());
}
