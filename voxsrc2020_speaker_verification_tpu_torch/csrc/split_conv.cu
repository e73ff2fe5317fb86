// K2: one group of the stride-1 Res2Net split chain, eval mode.
//
// Replaces: voxsrc2020_speaker_verification_tpu/models/res2net.py
// Res2NetSplitConv, stride-1 branch (lines 82-107), which XLA ran as s-1
// convs each followed by BN and relu.
//
// One launch per group i < s-1 computes, for every position (b, t, f),
//   in_i  = x_i + mask * y_{i-1}          (i > 0; rounded to the dtype)
//   y_i   = relu((conv3x3_same(in_i) - mean_i) * rsqrt(var_i + eps))
// and writes y_i into channel slice i of the stage output, so no concat is
// needed; the launch of group 0 also copies the pass-through last group.
// Padded frames of y_{i-1} are zeroed by the mask before the add, so padding
// garbage never enters the conv's receptive field.
//
// The conv is an implicit GEMM: M = B*T*F positions, N = w output channels,
// K = 9 * w (tap-major, then input channel), with the A tile gathered from
// the shifted input (and the masked add) while it is staged in shared
// memory. Layout: channels-last (B, T, F, C) for input and output.
//
// Bound on the card: at the serving widths (w 24..192) the bf16 chain moves
// x_i, y_{i-1} and y_i (6 B per position-channel) for 18 w flops each:
// below Hopper's ridge (~295 flop/B) at w <= 48, so HBM bounds those
// stages; the tensor cores bound w = 96 and 192. Two variants:
//
// * split_group_mma (bfloat16, w % 8 == 0): mma.sync m16n8k16 bf16 with
//   fp32 accumulation. A block owns a patch of up to 128 (t, f) positions of
//   one utterance and stages it once in shared memory with a one-position
//   halo (coalesced 16-byte loads, the masked add applied while staging);
//   all nine taps then read from shared memory, so each input is read from
//   HBM about (TT+2)(TF+2)/(TT*TF) ~ 1.4 times per group. Four warps each
//   own 32 positions x 8*NT output channels; B fragments come straight from
//   the weights in (w_out, 9 * w) layout (L1-resident). Epilogue: round the
//   conv output to bf16, eval BN, relu, 4-byte pair stores.
// * split_group (float32, or bf16 at other widths): the same GEMM as fp32
//   FMA on CUDA cores, weights in their JAX layout (3, 3, w, w * (s-1)) with
//   row stride ldw = w * (s-1), group i reading columns [woff, woff + w)
//   (models/res2net.py:83). float32 stays off the tensor cores: TF32 would
//   cost 13 mantissa bits the plain version keeps.
//
// Neither variant double-buffers its tiles yet (cp.async / TMA, wgmma come
// later); the chain fuses the add, the BN and the relu so that each
// activation is read and written once per group.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BM = 128;      // positions per block
constexpr int KC = 8;        // input channels per staged chunk
constexpr int THREADS = 256; // 32 rows x 8 columns of threads
constexpr int TM = 4;        // positions per thread
constexpr int APAD = 4;      // keeps the staged A stores conflict-free
constexpr int LOADS = BM * KC / THREADS;

template <typename T, int TN>
__global__ void __launch_bounds__(THREADS) split_group_kernel(
    const T* __restrict__ x, const T* prev, const float* __restrict__ mask,
    const T* __restrict__ w, int ldw, int woff,
    const float* __restrict__ mean, const float* __restrict__ var, T* out,
    int total, int tlen, int flen,
    int cin, int x_off, int cout, int prev_off, int out_off, int width,
    int tail_src, int tail_dst, int tail_width, float eps) {
  constexpr int BN = 8 * TN;
  __shared__ __align__(16) float as[KC][BM + APAD];
  __shared__ __align__(16) float bs[KC][BN];

  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // the positions this thread stages: rows tid / KC + 32 r, channel tid % KC
  const int lk = tid % KC;
  int lb[LOADS], lt[LOADS], lf[LOADS];
#pragma unroll
  for (int r = 0; r < LOADS; ++r) {
    const int m = m0 + tid / KC + (THREADS / KC) * r;
    if (m < total) {
      lf[r] = m % flen;
      const int bt = m / flen;
      lt[r] = bt % tlen;
      lb[r] = bt / tlen;
    } else {
      lb[r] = -1; lt[r] = 0; lf[r] = 0;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dt = tap / 3 - 1, df = tap % 3 - 1;
    for (int c0 = 0; c0 < width; c0 += KC) {
      const int ci = c0 + lk;
#pragma unroll
      for (int r = 0; r < LOADS; ++r) {
        float v = 0.f;
        const int t2 = lt[r] + dt, f2 = lf[r] + df;
        if (lb[r] >= 0 && ci < width && t2 >= 0 && t2 < tlen && f2 >= 0 && f2 < flen) {
          const long long bt = static_cast<long long>(lb[r]) * tlen + t2;
          const long long p = bt * flen + f2;
          v = vsv::to_f(x[p * cin + x_off + ci]);
          if (prev != nullptr) {
            float y = vsv::to_f(prev[p * cout + prev_off + ci]);
            if (mask != nullptr) y *= mask[bt];
            v = vsv::round_to<T>(v + y);
          }
        }
        as[lk][tid / KC + (THREADS / KC) * r] = v;
      }
      for (int i = tid; i < KC * BN; i += THREADS) {
        const int kk = i / BN, nn = i % BN;
        const int c = c0 + kk, co = n0 + nn;
        bs[kk][nn] = (c < width && co < width)
            ? vsv::to_f(w[(static_cast<long long>(tap) * width + c) * ldw + woff + co])
            : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
        const float a[TM] = {av.x, av.y, av.z, av.w};
        float bv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: round the conv output to the dtype, eval BN, relu, store
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int co = n0 + tx * TN + j;
    if (co >= width) continue;
    const float mu = mean[co];
    const float inv = 1.f / sqrtf(var[co] + eps);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= total) continue;
      float v = vsv::round_to<T>(acc[i][j]);
      v = fmaxf((v - mu) * inv, 0.f);
      out[static_cast<long long>(m) * cout + out_off + co] = vsv::from_f<T>(v);
    }
  }

  if (tail_width > 0 && blockIdx.y == 0) {
    for (int i = tid; i < BM * tail_width; i += THREADS) {
      const int m = m0 + i / tail_width, c = i % tail_width;
      if (m < total)
        out[static_cast<long long>(m) * cout + tail_dst + c] =
            x[static_cast<long long>(m) * cin + tail_src + c];
    }
  }
}

template <typename T, int TN>
int launch(const void* x, const void* prev, const float* mask, const void* w,
           int ldw, int woff, const float* mean, const float* var, void* out, int total, int tlen,
           int flen, int cin, int x_off, int cout, int prev_off, int out_off,
           int width, int tail_src, int tail_dst, int tail_width, float eps,
           cudaStream_t stream) {
  constexpr int BN = 8 * TN;
  const dim3 grid((total + BM - 1) / BM, (width + BN - 1) / BN);
  split_group_kernel<T, TN><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(prev), mask,
      static_cast<const T*>(w), ldw, woff, mean, var, static_cast<T*>(out), total, tlen,
      flen, cin, x_off, cout, prev_off, out_off, width, tail_src, tail_dst,
      tail_width, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int tn, const void* x, const void* prev, const float* mask,
             const void* w, int ldw, int woff, const float* mean, const float* var, void* out,
             int total, int tlen, int flen, int cin, int x_off, int cout,
             int prev_off, int out_off, int width, int tail_src, int tail_dst,
             int tail_width, float eps, cudaStream_t stream) {
#define VSV_SPLIT_CASE(N)                                                     \
  case N:                                                                     \
    return launch<T, N>(x, prev, mask, w, ldw, woff, mean, var, out, total, tlen, flen,  \
                        cin, x_off, cout, prev_off, out_off, width, tail_src, \
                        tail_dst, tail_width, eps, stream);
  switch (tn) {
    VSV_SPLIT_CASE(1)
    VSV_SPLIT_CASE(2)
    VSV_SPLIT_CASE(3)
    VSV_SPLIT_CASE(4)
    VSV_SPLIT_CASE(6)
    VSV_SPLIT_CASE(8)
    VSV_SPLIT_CASE(12)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VSV_SPLIT_CASE
}

// ---------------------------------------------------------------------------
// tensor-core variant (bfloat16, width % 8 == 0)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // four warps, 32 tile positions each
constexpr int TILE = 128;         // positions per block: a TT x TF patch of one
                                  // utterance, TT * TF <= TILE

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  unsigned int w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<unsigned int*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Row stride (bf16) of a staged position: w plus a pad that makes the stride
// in 32-bit words an odd multiple of 4, so the 8 rows of an mma fragment
// load fall in 8 distinct 4-bank groups; rows stay 16-byte aligned.
__host__ __device__ __forceinline__ int halo_stride(int width) {
  return width + 2 * ((4 - (width / 2) % 8 + 8) % 8);
}

// Block = one TT x TF patch of (t, f) positions of one utterance. The block
// stages the patch plus a one-position halo, all w channels of group i, with
// the masked add of y_{i-1} applied and rounded to bf16 -- coalesced 16-byte
// loads, each input read once per block. The implicit GEMM then reads all
// nine taps from shared memory: M = the patch, N = 8 * NT output channels,
// K = 9 * w in 16-wide steps made of two 8-channel chunks (each inside one
// tap, as w % 8 == 0), B fragments straight from the (w_out, 9 * w) weights.
template <int NT>
__global__ void __launch_bounds__(MMA_THREADS) split_group_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* prev,
    const float* __restrict__ mask, const __nv_bfloat16* __restrict__ wt,
    int woff, const float* __restrict__ mean, const float* __restrict__ var,
    __nv_bfloat16* out, int batch, int tlen, int flen, int tt_n, int tf_n,
    int cin, int x_off, int cout, int prev_off, int out_off, int width,
    int tail_src, int tail_dst, int tail_width, float eps) {
  constexpr int BN = 8 * NT;
  extern __shared__ __align__(16) __nv_bfloat16 halo[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int n0 = blockIdx.y * BN;
  const int ft = (flen + tf_n - 1) / tf_n, tiles_t = (tlen + tt_n - 1) / tt_n;
  const int b = blockIdx.x / (tiles_t * ft);
  const int t0 = (blockIdx.x / ft) % tiles_t * tt_n;
  const int f0 = blockIdx.x % ft * tf_n;
  const int hw = tf_n + 2, hs = halo_stride(width), c8 = width / 8;
  const int hpos = (tt_n + 2) * hw;

  // stage the halo patch: 16 bytes (8 channels) per thread per step
  for (int i = tid; i < hpos * c8; i += MMA_THREADS) {
    const int q = i / c8, c0 = (i % c8) * 8;
    const int t = t0 - 1 + q / hw, f = f0 - 1 + q % hw;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t >= 0 && t < tlen && f >= 0 && f < flen) {
      const long long bt = static_cast<long long>(b) * tlen + t;
      const long long p = bt * flen + f;
      load8(x + p * cin + x_off + c0, v);
      if (prev != nullptr) {
        float y[8];
        load8(prev + p * cout + prev_off + c0, y);
        const float mk = mask != nullptr ? mask[bt] : 1.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = vsv::round_to<__nv_bfloat16>(v[j] + y[j] * mk);
      }
    }
    *reinterpret_cast<uint4*>(halo + q * hs + c0) = pack8(v);
  }
  __syncthreads();

  // halo position of each fragment row (tap (1, 1)); rows past the patch
  // read a valid position and are never stored
  int qrow[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(warp * 32 + mt * 16 + g + 8 * h, tt_n * tf_n - 1);
      qrow[mt][h] = (r / tf_n + 1) * hw + r % tf_n + 1;
    }

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int kdim = 9 * width, chunks = 9 * c8;
  for (int ks = 0; 2 * ks < chunks; ++ks) {
    // the two 8-channel chunks of this k step: (tap, channel) -> halo offset
    int off[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = 2 * ks + h;
      live[h] = ch < chunks;
      const int tap = ch / c8;
      off[h] = ((tap / 3 - 1) * hw + tap % 3 - 1) * hs + (ch % c8) * 8 + 2 * tg;
    }
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* r0 = halo + qrow[mt][0] * hs;
      const __nv_bfloat16* r1 = halo + qrow[mt][1] * hs;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(r0 + off[0]);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(r1 + off[0]);
      af[mt][2] = live[1] ? *reinterpret_cast<const uint32_t*>(r0 + off[1]) : 0u;
      af[mt][3] = live[1] ? *reinterpret_cast<const uint32_t*>(r1 + off[1]) : 0u;
    }
    const int k = 16 * ks + 2 * tg;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* row =
          wt + static_cast<long long>(woff + n0 + nt * 8 + g) * kdim;
      uint32_t bf[2];
      bf[0] = *reinterpret_cast<const uint32_t*>(row + k);
      bf[1] = live[1] ? *reinterpret_cast<const uint32_t*>(row + k + 8) : 0u;
      mma_bf16_16816(acc[0][nt], af[0], bf);
      mma_bf16_16816(acc[1][nt], af[1], bf);
    }
  }

  // epilogue: round the conv output to bf16, eval BN, relu, store pairs
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 32 + mt * 16 + g + 8 * h;
      const int t = t0 + r / tf_n, f = f0 + r % tf_n;
      if (r >= tt_n * tf_n || t >= tlen || f >= flen) continue;
      __nv_bfloat16* o = out + ((static_cast<long long>(b) * tlen + t) * flen + f) * cout + out_off;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = n0 + nt * 8 + 2 * tg;
        const float v0 = vsv::round_to<__nv_bfloat16>(acc[mt][nt][2 * h]);
        const float v1 = vsv::round_to<__nv_bfloat16>(acc[mt][nt][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(
            fmaxf((v0 - mean[co]) / sqrtf(var[co] + eps), 0.f),
            fmaxf((v1 - mean[co + 1]) / sqrtf(var[co + 1] + eps), 0.f));
      }
    }

  // the pass-through last group, for the patch's positions
  if (tail_width > 0 && blockIdx.y == 0) {
    const int vecs = tail_width / 8;
    for (int i = tid; i < tt_n * tf_n * vecs; i += MMA_THREADS) {
      const int r = i / vecs, c = (i % vecs) * 8;
      const int t = t0 + r / tf_n, f = f0 + r % tf_n;
      if (t < tlen && f < flen) {
        const long long p = (static_cast<long long>(b) * tlen + t) * flen + f;
        *reinterpret_cast<uint4*>(out + p * cout + tail_dst + c) =
            *reinterpret_cast<const uint4*>(x + p * cin + tail_src + c);
      }
    }
  }
}

template <int NT>
int launch_mma(const void* x, const void* prev, const float* mask, const void* wt,
               int woff, const float* mean, const float* var, void* out,
               int batch, int tlen, int flen, int cin, int x_off, int cout,
               int prev_off, int out_off, int width, int tail_src, int tail_dst,
               int tail_width, float eps, cudaStream_t stream) {
  // patch: TF = F split evenly into <= 16-wide tiles, TT = TILE / TF rows
  const int ft = (flen + 15) / 16;
  const int tf_n = (flen + ft - 1) / ft, tt_n = TILE / tf_n;
  const long long tiles = static_cast<long long>(batch) * ((tlen + tt_n - 1) / tt_n) * ft;
  const size_t smem = sizeof(__nv_bfloat16) * (tt_n + 2) * (tf_n + 2) * halo_stride(width);
  if (tiles > 0x7fffffffLL || smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(split_group_mma_kernel<NT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  const dim3 grid(static_cast<unsigned>(tiles), width / (8 * NT));
  split_group_mma_kernel<NT><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(prev),
      mask, static_cast<const __nv_bfloat16*>(wt), woff, mean, var,
      static_cast<__nv_bfloat16*>(out), batch, tlen, flen, tt_n, tf_n, cin,
      x_off, cout, prev_off, out_off, width, tail_src, tail_dst, tail_width, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 only; width, every channel offset and tail_width multiples of 8,
// pointers 16-byte aligned. wt: (w * (s-1), 9 * w) bfloat16, row n holding
// output channel n's taps (tap-major, then input channel); group i passes
// woff = i * w. nt: output channels per warp / 8, one of 1, 2, 3, 4, 6, 8,
// 12, with width % (8 * nt) == 0.
extern "C" int split_group_mma(int nt, const void* x, const void* prev,
                               const float* mask, const void* wt, int woff,
                               const float* mean, const float* var, void* out,
                               int batch, int tlen, int flen, int cin,
                               int x_off, int cout, int prev_off, int out_off,
                               int width, int tail_src, int tail_dst,
                               int tail_width, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width % (8 * nt) != 0 || tail_width % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define VSV_MMA_CASE(N)                                                        \
  case N:                                                                      \
    return launch_mma<N>(x, prev, mask, wt, woff, mean, var, out, batch, tlen, \
                         flen, cin, x_off, cout, prev_off, out_off, width,     \
                         tail_src, tail_dst, tail_width, eps, s);
  switch (nt) {
    VSV_MMA_CASE(1)
    VSV_MMA_CASE(2)
    VSV_MMA_CASE(3)
    VSV_MMA_CASE(4)
    VSV_MMA_CASE(6)
    VSV_MMA_CASE(8)
    VSV_MMA_CASE(12)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VSV_MMA_CASE
}

// dtype: 0 = float32, 1 = bfloat16. tn: output channels per thread, one of
// 1, 2, 3, 4, 6, 8, 12 (a block covers 8 * tn output channels).
extern "C" int split_group(int dtype, int tn, const void* x, const void* prev,
                           const float* mask, const void* w, int ldw, int woff,
                           const float* mean,
                           const float* var, void* out, int total, int tlen,
                           int flen, int cin, int x_off, int cout, int prev_off,
                           int out_off, int width, int tail_src, int tail_dst,
                           int tail_width, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(tn, x, prev, mask, w, ldw, woff, mean, var, out, total, tlen,
                           flen, cin, x_off, cout, prev_off, out_off, width,
                           tail_src, tail_dst, tail_width, eps, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(tn, x, prev, mask, w, ldw, woff, mean, var, out, total,
                                   tlen, flen, cin, x_off, cout, prev_off,
                                   out_off, width, tail_src, tail_dst,
                                   tail_width, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
