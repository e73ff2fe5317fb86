// K8 / K8b: attentive statistics pooling after the attention's scores, the
// masked softmax over time with its weighted mean || std, forward and
// backward.
//
// Replaces: voxsrc2020_speaker_verification_tpu/ops/nn.py:AttStatsPool
// (lines 530-539: the float32 scores, -1e30 at masked frames, softmax over
// time, weighted mean and sqrt(max(E_p[x^2] - mean^2, 0) + eps)), which XLA
// compiled on the TPU, and its JAX autodiff.
//
// Input channels-last (B, T, W, C): x and the scores s in one dtype (fp32 or
// bf16); mask (B, T) 0/1 float or null. Per column (b, w, c), in fp32:
//
//   s' = s where mask > 0, else -1e30;  p = softmax over T of s'
//   mean = sum p x,  q = sum p x^2,  std = sqrt(max(q - mean^2, 0) + eps)
//   out (B, W, 2C) = [mean || std] cast to the dtype  (the pooled (B, 2C, 1, W)
//   tensor in channels-last memory, the JAX package's NHWC (B, 1, W, 2C))
//
// One pass over T with an online max: each new maximum rescales the running
// sums. A column masked throughout has every s' = -1e30, so p = 1/T over all
// T frames, as the JAX softmax gives. The forward saves (max, sum of exp,
// mean, q) per column in fp32, planar (4, B, W, C), for the backward:
//
//   v  = q - mean^2,  h = 1 if v > 0, 1/2 if v == 0, else 0   (jnp.maximum's
//   tie),  gv = dstd * h / (2 std)  (the gradient into v)
//   dx = p (dmean + 2 (x - mean) gv)
//   ds = p ((x - mean) dmean + gv ((x - mean)^2 - v)), and 0 at masked frames
//
// (the same as p (gm + 2 x gq) and p (x gm + x^2 gq - mean gm - q gq) with
// gm = dmean - 2 mean gv, gq = gv, written around x - mean: those two
// cancel large terms where std is small against |mean|.)
//
// Bound on the card: bytes. The forward reads x and s once and writes the
// pooled rows; the backward reads x and s and writes dx and ds; a few dozen
// fp32 operations (one exp) an element, far below Hopper's ridge.
//
// Forward design (redesigned for Hopper): what bounded the first forward,
// one thread a 16-byte column vector walking all of T with four rows loaded
// into registers ahead, was too few bytes in flight: four rows a thread,
// held in registers, and at ECAPA's (256, 1536, 200, 1) head only 49,152
// threads; it ran at 1.8x its bound there and 3.1x at the 25-frame
// training head. Now each thread
// stages its rows in shared memory by 16-byte cp.async, kRing rows ahead of
// the one it folds in (K4's cp.async staging, here a ring a thread), so the
// bytes in flight cost no registers and four CTAs share an SM; and T is
// split too: a CTA takes VT consecutive column vectors and NS groups of its
// threads walk interleaved rows of them (NS picked in C so that the launch
// gives the card two waves of resident threads), their sums merged through
// shared memory in a fixed order.
// Backward: one thread a column vector, walking T with four rows loaded
// ahead (it writes dx and ds, twice the forward's traffic, and fills the
// card at every head shape).
// Where C is not a multiple of V, or a pointer is not 16-byte aligned,
// every thread takes one channel (V = 1), chosen by shape here. No atomics,
// a fixed order along T and across the groups: reruns agree bit for bit.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;  // rows loaded before they are used

template <typename T, int V> struct Pack;
template <> struct Pack<float, 4> {
  using U = uint4;
  static __device__ __forceinline__ void load(const float* p, U& u) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const U& u, float* v) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) { vsv::store4(p, v); }
};
template <> struct Pack<__nv_bfloat16, 8> {
  using U = uint4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, U& u) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const U& u, float* v) {
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    vsv::store4(p, v);
    vsv::store4(p + 4, v + 4);
  }
};
template <typename T> struct Pack<T, 1> {
  using U = T;
  static __device__ __forceinline__ void load(const T* p, U& u) { u = *p; }
  static __device__ __forceinline__ void unpack(const U& u, float* v) { v[0] = vsv::to_f(u); }
  static __device__ __forceinline__ void store(T* p, const float* v) { *p = vsv::from_f<T>(v[0]); }
};

constexpr float kMasked = -1e30f;

// q - mean^2 with each operation rounded, never contracted into one fma:
// where every weight sits on one frame (T = 1), q == mean^2 exactly and the
// gradient into the scores is exactly 0, as the JAX package computes it.
__device__ __forceinline__ float variance(float q, float mean) {
  return __fsub_rn(q, __fmul_rn(mean, mean));
}

// The column vector a thread owns: (b, w, c0), and the element offset of its
// row t = 0; rows lie W * C elements apart.
struct Col {
  int b, w, c0;
  long long base, row;
};

template <int V>
__device__ __forceinline__ Col column(long long idx, int tlen, int wlen, int channels) {
  const int nv = channels / V;
  const long long bw = idx / nv;
  Col col;
  col.w = static_cast<int>(bw % wlen);
  col.b = static_cast<int>(bw / wlen);
  col.c0 = static_cast<int>(idx % nv) * V;
  col.row = static_cast<long long>(wlen) * channels;
  col.base = static_cast<long long>(col.b) * tlen * col.row +
             static_cast<long long>(col.w) * channels + col.c0;
  return col;
}

// The forward's running sums of one column: the max of the scores so far,
// and sum exp(s - max), sum exp(s - max) x, sum exp(s - max) x^2.
struct Partial {
  float m, l, a, q;
};

// Folds partial o into p (p's rows first): both rescaled to the larger max.
// p.m is finite wherever o holds rows, since a split's first rows come first.
__device__ __forceinline__ void merge(Partial& p, const Partial& o) {
  const float mn = fmaxf(p.m, o.m);
  const float rp = expf(p.m - mn), ro = expf(o.m - mn);
  p.l = p.l * rp + o.l * ro;
  p.a = p.a * rp + o.a * ro;
  p.q = p.q * rp + o.q * ro;
  p.m = mn;
}

// Folds one row of a column vector into its running sums: an online max,
// a new maximum rescaling the sums (the first forward's arithmetic).
template <int V>
__device__ __forceinline__ void fold_row(Partial (&p)[V], const float* xv, const float* sv,
                                         float mk) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float sc = mk > 0.f ? sv[j] : kMasked;
    if (sc > p[j].m) {
      const float r = expf(p[j].m - sc);
      p[j].l = p[j].l * r + 1.f;
      p[j].a = p[j].a * r + xv[j];
      p[j].q = p[j].q * r + xv[j] * xv[j];
      p[j].m = sc;
    } else {
      const float e = expf(sc - p[j].m);
      p[j].l += e;
      p[j].a += e * xv[j];
      p[j].q += e * (xv[j] * xv[j]);
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int kRing = 5;  // rows a thread has in flight (x, s and the mask value)

// The shared memory of a forward CTA: each thread's ring of kRing rows
// (x and s, 16 bytes each, and the row's mask value), reused after the
// walk for the groups' partial sums.
template <int V, int NS> struct FwdSmem {
  static constexpr int VT = kThreads / NS;
  static constexpr int RING_BYTES = kRing * kThreads * (2 * 16 + 4);
  static constexpr int PART_BYTES = (NS > 1 ? NS - 1 : 1) * VT * V * sizeof(Partial);
  static constexpr int BYTES = RING_BYTES > PART_BYTES ? RING_BYTES : PART_BYTES;
};

// One CTA a tile of VT = kThreads / NS consecutive column vectors (16 bytes
// of x a (b, w), V channels; the tile may run over several (b, w)), its T
// rows split over NS thread groups: group k takes rows k, k + NS, .... Each
// thread stages its own rows into its ring in shared memory by cp.async
// (x and s 16 bytes each, the mask value 4), kRing rows ahead of the one it
// folds in, so many rows are in flight without holding registers; it reads
// only its own slots, so the walk needs no barrier. (The single-channel
// path, V = 1, loads its rows straight into registers, four ahead.) Groups
// k > 0 leave their partial sums in shared memory and group 0's partials
// are folded with them in the order k = 1 .. NS-1: a fixed order, so reruns
// agree bit for bit. Then each column's mean, E_p x^2 and std, and the
// saved stats.
template <typename T, int V, int NS>
__global__ void __launch_bounds__(kThreads)
    att_pool_fwd_kernel(const T* __restrict__ x, const T* __restrict__ s,
                        const float* __restrict__ mask, T* __restrict__ out,
                        float* __restrict__ stats, int batch, int tlen, int wlen,
                        int channels, float eps) {
  using P = Pack<T, V>;
  using M = FwdSmem<V, NS>;
  constexpr int VT = M::VT;
  __shared__ __align__(16) unsigned char smem[M::BYTES];
  const int tid = threadIdx.x, k = tid / VT, v = tid % VT;
  const long long total = static_cast<long long>(batch) * wlen * (channels / V);
  const long long idx = static_cast<long long>(blockIdx.x) * VT + v;
  const bool live = idx < total;
  const Col col = column<V>(live ? idx : 0, tlen, wlen, channels);
  Partial p[V];
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = Partial{-INFINITY, 0.f, 0.f, 0.f};
  const float* mrow = mask != nullptr ? mask + static_cast<long long>(col.b) * tlen : nullptr;
  const int rows = live && k < tlen ? (tlen - k + NS - 1) / NS : 0;
  if constexpr (V > 1) {
    uint4* xr = reinterpret_cast<uint4*>(smem);   // [kRing][kThreads]
    uint4* sr = xr + kRing * kThreads;            // [kRing][kThreads]
    float* mr = reinterpret_cast<float*>(sr + kRing * kThreads);
    auto issue = [&](int j) {  // row k + NS j into slot j % kRing
      if (j < rows) {
        const int t = k + NS * j, slot = (j % kRing) * kThreads + tid;
        const long long e = col.base + static_cast<long long>(t) * col.row;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(xr + slot)),
                     "l"(x + e)
                     : "memory");
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(sr + slot)),
                     "l"(s + e)
                     : "memory");
        if (mrow != nullptr)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(mr + slot)),
                       "l"(mrow + t)
                       : "memory");
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
#pragma unroll
    for (int j = 0; j < kRing; ++j) issue(j);
    for (int j = 0; j < rows; ++j) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
      const int slot = (j % kRing) * kThreads + tid;
      float xv[V], sv[V];
      P::unpack(xr[slot], xv);
      P::unpack(sr[slot], sv);
      const float mk = mrow != nullptr ? mr[slot] : 1.f;
      issue(j + kRing);  // the slot is read: refill it
      fold_row<V>(p, xv, sv, mk);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int j0 = 0; j0 < rows; j0 += kAhead) {
      typename P::U xu[kAhead], su[kAhead];
      float mk[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (j0 + u < rows) {
          const int t = k + NS * (j0 + u);
          const long long e = col.base + static_cast<long long>(t) * col.row;
          P::load(x + e, xu[u]);
          P::load(s + e, su[u]);
          mk[u] = mrow != nullptr ? mrow[t] : 1.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (j0 + u >= rows) break;
        float xv[V], sv[V];
        P::unpack(xu[u], xv);
        P::unpack(su[u], sv);
        fold_row<V>(p, xv, sv, mk[u]);
      }
    }
  }
  if constexpr (NS > 1) {
    Partial* part = reinterpret_cast<Partial*>(smem);  // [NS - 1][VT * V]
    __syncthreads();  // every ring is read out
    if (k > 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) part[(k - 1) * VT * V + v * V + j] = p[j];
    }
    __syncthreads();
    if (k > 0) return;
    for (int kk = 0; kk < NS - 1; ++kk)
#pragma unroll
      for (int j = 0; j < V; ++j) merge(p[j], part[kk * VT * V + v * V + j]);
  }
  if (!live) return;
  float mean[V], sd[V];
  const long long n = static_cast<long long>(batch) * wlen * channels;
  const long long si = (static_cast<long long>(col.b) * wlen + col.w) * channels + col.c0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float inv = 1.f / p[j].l;
    mean[j] = p[j].a * inv;
    const float qq = p[j].q * inv;
    sd[j] = sqrtf(fmaxf(variance(qq, mean[j]), 0.f) + eps);
    stats[si + j] = p[j].m;
    stats[n + si + j] = p[j].l;
    stats[2 * n + si + j] = mean[j];
    stats[3 * n + si + j] = qq;
  }
  T* o = out + (static_cast<long long>(col.b) * wlen + col.w) * 2 * channels + col.c0;
  P::store(o, mean);
  P::store(o + channels, sd);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    att_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ s,
                        const float* __restrict__ mask, const float* __restrict__ stats,
                        const T* __restrict__ dout, T* __restrict__ dx, T* __restrict__ ds,
                        int batch, int tlen, int wlen, int channels, float eps) {
  using P = Pack<T, V>;
  const long long total = static_cast<long long>(batch) * wlen * (channels / V);
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Col col = column<V>(idx, tlen, wlen, channels);
  const long long n = static_cast<long long>(batch) * wlen * channels;
  const long long si = (static_cast<long long>(col.b) * wlen + col.w) * channels + col.c0;
  float dm[V], dsd[V];
  {
    const T* d = dout + (static_cast<long long>(col.b) * wlen + col.w) * 2 * channels + col.c0;
    typename P::U u;
    P::load(d, u);
    P::unpack(u, dm);
    P::load(d + channels, u);
    P::unpack(u, dsd);
  }
  float mx[V], inv_l[V], mean[V], var[V], gv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mx[j] = stats[si + j];
    inv_l[j] = 1.f / stats[n + si + j];
    mean[j] = stats[2 * n + si + j];
    // the forward's arithmetic, so the tie decision is the forward's
    var[j] = variance(stats[3 * n + si + j], mean[j]);
    const float sd = sqrtf(fmaxf(var[j], 0.f) + eps);
    const float h = var[j] > 0.f ? 1.f : (var[j] == 0.f ? 0.5f : 0.f);
    gv[j] = dsd[j] * h / (2.f * sd);
  }
  const float* mrow = mask != nullptr ? mask + static_cast<long long>(col.b) * tlen : nullptr;
  for (int t0 = 0; t0 < tlen; t0 += kAhead) {
    typename P::U xu[kAhead], su[kAhead];
    float mk[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k < tlen) {
        const long long e = col.base + static_cast<long long>(t0 + k) * col.row;
        P::load(x + e, xu[k]);
        P::load(s + e, su[k]);
        mk[k] = mrow != nullptr ? mrow[t0 + k] : 1.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k >= tlen) break;
      float xv[V], sv[V], gx[V], gs[V];
      P::unpack(xu[k], xv);
      P::unpack(su[k], sv);
      const bool valid = mk[k] > 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float p = expf((valid ? sv[j] : kMasked) - mx[j]) * inv_l[j];
        const float d = xv[j] - mean[j];
        gx[j] = p * (dm[j] + 2.f * d * gv[j]);
        gs[j] = valid ? p * (d * dm[j] + gv[j] * (d * d - var[j])) : 0.f;
      }
      const long long e = col.base + static_cast<long long>(t0 + k) * col.row;
      P::store(dx + e, gx);
      P::store(ds + e, gs);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// T-split of the forward: the fewest groups (a power of two up to 16) that
// give the card two waves of resident threads (four CTAs an SM), while each
// group keeps at least two rings of rows.
int fwd_splits(long long vectors, int tlen) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = 2LL * sms * 4 * kThreads;
  int ns = 1;
  while (ns < 16 && vectors * ns < want && tlen >= 2 * kRing * 2 * ns) ns *= 2;
  return ns;
}

template <typename T, int V>
void forward_split(int ns, const T* x, const T* s, const float* mask, T* out, float* stats,
                   int batch, int tlen, int wlen, int channels, float eps, cudaStream_t stream) {
  const long long vectors = static_cast<long long>(batch) * wlen * (channels / V);
#define VSV_FWD_CASE(N)                                                                  \
  case N:                                                                                \
    att_pool_fwd_kernel<T, V, N>                                                         \
        <<<static_cast<unsigned>((vectors + kThreads / N - 1) / (kThreads / N)), kThreads, 0, \
           stream>>>(x, s, mask, out, stats, batch, tlen, wlen, channels, eps);          \
    break;
  switch (ns) {
    VSV_FWD_CASE(1)
    VSV_FWD_CASE(2)
    VSV_FWD_CASE(4)
    VSV_FWD_CASE(8)
    VSV_FWD_CASE(16)
  }
#undef VSV_FWD_CASE
}

template <typename T>
int forward(const void* x, const void* s, const float* mask, void* out, float* stats,
            int batch, int tlen, int wlen, int channels, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long cols = static_cast<long long>(batch) * wlen;
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(s);
  T* ot = static_cast<T*>(out);
  if (channels % V == 0 && aligned16(x) && aligned16(s) && aligned16(out)) {
    const long long vectors = cols * (channels / V);
    forward_split<T, V>(fwd_splits(vectors, tlen), xt, st, mask, ot, stats, batch, tlen, wlen,
                        channels, eps, stream);
  } else {
    const long long vectors = cols * channels;
    forward_split<T, 1>(fwd_splits(vectors, tlen), xt, st, mask, ot, stats, batch, tlen, wlen,
                        channels, eps, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* x, const void* s, const float* mask, const float* stats,
             const void* dout, void* dx, void* ds, int batch, int tlen, int wlen,
             int channels, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long cols = static_cast<long long>(batch) * wlen;
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(s);
  const T* dt = static_cast<const T*>(dout);
  T* dxt = static_cast<T*>(dx);
  T* dst = static_cast<T*>(ds);
  if (channels % V == 0 && aligned16(x) && aligned16(s) && aligned16(dout) && aligned16(dx) &&
      aligned16(ds)) {
    att_pool_bwd_kernel<T, V><<<blocks_for(cols * (channels / V)), kThreads, 0, stream>>>(
        xt, st, mask, stats, dt, dxt, dst, batch, tlen, wlen, channels, eps);
  } else {
    att_pool_bwd_kernel<T, 1><<<blocks_for(cols * channels), kThreads, 0, stream>>>(
        xt, st, mask, stats, dt, dxt, dst, batch, tlen, wlen, channels, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, s: channels-last (B, T, W, C); mask
// (B, T) or null; out (B, W, 2C); stats (4, B, W, C) float32, written. One
// launch.
extern "C" int att_pool_fwd(int dtype, const void* x, const void* s, const float* mask,
                            void* out, float* stats, int batch, int tlen, int wlen,
                            int channels, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(x, s, mask, out, stats, batch, tlen, wlen, channels, eps, st);
  if (dtype == 1)
    return forward<__nv_bfloat16>(x, s, mask, out, stats, batch, tlen, wlen, channels, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward from the forward's stats and the pooled rows' gradient dout
// (B, W, 2C): dx and ds (B, T, W, C), written. One launch.
extern "C" int att_pool_bwd(int dtype, const void* x, const void* s, const float* mask,
                            const float* stats, const void* dout, void* dx, void* ds,
                            int batch, int tlen, int wlen, int channels, float eps,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(x, s, mask, stats, dout, dx, ds, batch, tlen, wlen, channels, eps,
                           st);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, s, mask, stats, dout, dx, ds, batch, tlen, wlen,
                                   channels, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
