// K2: the stride-1 Res2Net split chain, eval mode.
//
// Replaces: voxsrc2020_speaker_verification_tpu/models/res2net.py
// Res2NetSplitConv, stride-1 branch (lines 82-107), which XLA ran as s-1
// convs each followed by BN and relu.
//
// For every position (b, t, f) and group i < s-1:
//   in_i  = x_i + mask * y_{i-1}          (i > 0; rounded to the dtype)
//   y_i   = relu((conv3x3_same(in_i) - mean_i) * rsqrt(var_i + eps))
// with y_i written into channel slice i of the stage output, so no concat is
// needed, and the last group passed through. Padded frames of y_{i-1} are
// zeroed by the mask before the add, so padding garbage never enters the
// conv's receptive field.
//
// The conv is an implicit GEMM: M = B*T*F positions, N = w output channels,
// K = 9 * w (tap-major, then input channel), with the A tile gathered from
// the shifted input staged in shared memory. Layout: channels-last
// (B, T, F, C) for input and output.
//
// Bound on the card: at the serving widths (w 24..192) the bf16 chain needs
// one read of x and one write of the output (4 B per position-channel) for
// 18 w (s-1)/s flops each: below Hopper's ridge (~295 flop/B) at w <= 48,
// so HBM bounds those stages; the tensor cores bound w = 96 and 192. Five
// variants; the wrapper's plan (models/res2net.py:split_plan) picks one:
//
// * split_chain_fused (bfloat16, w = 8, 16, 24, 32 with s = 4 or 6, where
//   the weights and two full-width patch stages fit one block: the serving
//   model's w = 24 stage). What bounded the per-group variants there: s-1
//   launches, each reading x_i and y_{i-1} and writing y_i as 48-byte
//   pieces of 192-byte rows (w = 24), against a bound of one read of x and
//   one write of the output. This variant runs the whole chain in one
//   launch: each patch is staged once at full width with an (s-1)-position
//   halo (cp.async on mbarriers, two stages, the next patch in flight
//   during this one's compute), the groups are computed on shrinking rings
//   in shared memory, and every output row is written by one CTA. What
//   bounds it now: neither HBM (~1.2 ms of traffic a stage call at the
//   serving shape) nor the tensor cores -- the per-position work (the
//   epilogue's round, BN, relu and masked add, the ring's ~1.4x extra rows)
//   on mma.sync with sixteen warps an SM, the one CTA its shared memory
//   allows; wgmma and a lighter epilogue are the next steps.
// * split_group_pipe (bfloat16, w = 8 * nt where the group's weights fit in
//   half an SM's shared memory: the w = 48 stage). What bounded the first
//   tensor-core variant (split_group_mma, below): it staged each halo patch
//   with synchronous loads, then computed, with nothing in flight
//   meanwhile; A fragments were scalar 32-bit shared loads; B fragments
//   came from global memory at every k step in every warp; and a grid.y of
//   w / (8 NT) blocks staged the same patch once per N tile. This variant
//   keeps the group's weights in shared memory (once per CTA), runs
//   persistent CTAs over the patches with a two-stage cp.async ring
//   completing on mbarriers, applies the masked add in shared memory, takes
//   A and B fragments with ldmatrix, and covers all w output channels in
//   one CTA, so each patch is staged once per group. What bounds it now:
//   mma.sync issue rate and the per-group traffic.
// * split_group_wgmma (bfloat16, w % 16 == 0, 64 <= w <= 192: the w = 64,
//   96 and 192 groups, whose weights do not fit beside two patch stages).
//   What bounded split_group_mma (below) there: a grid.y of w / 96 N tiles
//   staged each patch twice at w = 192; every warp fetched its B fragments
//   from L2 at every k step; the patch was staged with synchronous loads,
//   nothing in flight during the compute; mma.sync with four warps, a block
//   ending with its patch. This variant runs persistent CTAs of a producer
//   warpgroup and two consumer warpgroups: the producer streams the
//   group's weights through a ring of bulk copies (the TMA's 1-D form) and
//   the next halo patch by cp.async, both on mbarriers; the consumers run
//   wgmma m64nWk16 (N = w in one CTA, so each patch is staged once per
//   group) with A from registers (ldmatrix: a tap's rows of the patch are
//   no strided block) and B from the ring by descriptor, and write their
//   outputs out of shared memory in 16-byte rows. Group i + 1's input
//   x_{i+1} + mask * y_i is written by group i's epilogue, so a patch is one
//   tensor's copies. What bounds it now: the consumer warpgroups work the
//   same tile in lockstep, so the tensor cores idle while both load
//   fragments, wait on the weight ring or write out (PERF.md §6).
// * split_group_mma (bfloat16, the other widths of 8k): mma.sync m16n8k16
//   with fp32 accumulation over a patch of up to 128 (t, f) positions
//   staged with a one-position halo; B fragments straight from the (w_out,
//   9 * w) weights (L2-resident).
// * split_group (float32, or bf16 at other widths): the same GEMM as fp32
//   FMA on CUDA cores, weights in their JAX layout (3, 3, w, w * (s-1)) with
//   row stride ldw = w * (s-1), group i reading columns [woff, woff + w)
//   (models/res2net.py:83). float32 stays off the tensor cores: TF32 would
//   cost 13 mantissa bits the plain version keeps.
//
// All variants fuse the add, the BN and the relu; the epilogue rounds the
// conv output to the dtype before the BN, as the JAX package does.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

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
__host__ __device__ constexpr int halo_stride(int width) {
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

// ---------------------------------------------------------------------------
// pipelined tensor-core variant (bfloat16, w = 8 * NT, the group's weights
// resident in shared memory)
// ---------------------------------------------------------------------------

constexpr int PIPE_THREADS = 128;  // four warps, 16 * MT patch rows each
constexpr int kSmemMax = 232448;   // 227 KB, the most a block can take

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// conv's "same" padding)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// this thread's arrival on `bar`, triggered when all its cp.async so far land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// Row stride (bf16) of the staged weights: K = 9w rounded up to 16, plus 8,
// so the stride in 16-byte units is odd (conflict-free ldmatrix) and the
// zero pad covers the dead half of the last k step.
__host__ __device__ constexpr int weight_stride(int width) {
  return (9 * width + 15) / 16 * 16 + 8;
}

// Shared memory: the weights (w rows), two halo-patch stages of x_i, one of
// y_{i-1}, two mbarriers, and each halo position's (row, column).
__host__ __device__ constexpr size_t pipe_smem(int width, int tt_n, int tf_n) {
  return sizeof(__nv_bfloat16) *
             (static_cast<size_t>(width) * weight_stride(width) +
              3 * static_cast<size_t>(tt_n + 2) * (tf_n + 2) * halo_stride(width)) +
         2 * sizeof(uint64_t) + sizeof(int) * static_cast<size_t>(tt_n + 2) * (tf_n + 2);
}

// Persistent CTAs walk the TT x TF patches of the (B, T, F) grid. A patch
// with its one-position halo (all w channels of x_i and of y_{i-1}) is
// copied into shared memory with cp.async, zero-filled outside the
// utterance, and the copies complete on the stage's mbarrier; the next
// patch's copies are issued before this patch's MMAs, so loads overlap
// compute. The masked add x_i + mask * y_{i-1} (rounded to bf16) is applied
// in shared memory. The implicit GEMM (M = the patch, N = w, K = 9w) runs on
// mma.sync m16n8k16 with A and B fragments from ldmatrix: every patch is
// staged once per group, for all output channels.
template <int NT, int MT>
__global__ void __launch_bounds__(PIPE_THREADS) split_group_pipe_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* prev,
    const float* __restrict__ mask, const __nv_bfloat16* __restrict__ wt, int woff,
    const float* __restrict__ mean, const float* __restrict__ var, __nv_bfloat16* out,
    int batch, int tlen, int flen, int tt_n, int tf_n, int cin, int x_off, int cout,
    int prev_off, int out_off, int tail_src, int tail_dst, int tail_width, float eps) {
  constexpr int W = 8 * NT, C8 = NT, HS = halo_stride(W), K = 9 * W;
  constexpr int WS = weight_stride(W), CHUNKS = 9 * C8, KSTEPS = (CHUNKS + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int hw = tf_n + 2, hpos = (tt_n + 2) * hw, hbuf = hpos * HS;
  __nv_bfloat16* xs0 = ws + W * WS;
  __nv_bfloat16* ps = xs0 + 2 * hbuf;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ps + hbuf);
  int* hq = reinterpret_cast<int*>(bar + 2);  // halo position q -> (q / hw) << 16 | q % hw

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int tiles_f = (flen + tf_n - 1) / tf_n, tiles_t = (tlen + tt_n - 1) / tt_n;
  const int ntiles = batch * tiles_t * tiles_f;
  const int rows = tt_n * tf_n;
  if (tid == 0) {
    mbar_init(&bar[0], PIPE_THREADS);
    mbar_init(&bar[1], PIPE_THREADS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int q = tid; q < hpos; q += PIPE_THREADS) hq[q] = (q / hw) << 16 | (q % hw);
  __syncthreads();

  // the group's weights: row n = output channel n, K taps x input channels,
  // zero-padded to WS
  for (int i = tid; i < W * (K / 8); i += PIPE_THREADS) {
    const int n = i / (K / 8), k8 = (i % (K / 8)) * 8;
    cp_async16(smem_u32(ws + n * WS + k8), wt + static_cast<long long>(woff + n) * K + k8, true);
  }
  for (int i = tid; i < W * (WS - K); i += PIPE_THREADS)
    ws[(i / (WS - K)) * WS + K + i % (WS - K)] = __float2bfloat16(0.f);

  auto issue = [&](int tile, int stage) {
    const int b = tile / (tiles_t * tiles_f);
    const int t0 = (tile / tiles_f) % tiles_t * tt_n, f0 = tile % tiles_f * tf_n;
    __nv_bfloat16* xs = xs0 + stage * hbuf;
    for (int i = tid; i < hpos * C8; i += PIPE_THREADS) {
      const int q = i / C8, c0 = (i % C8) * 8, qq = hq[q];
      const int t = t0 - 1 + (qq >> 16), f = f0 - 1 + (qq & 0xffff);
      const bool valid = t >= 0 && t < tlen && f >= 0 && f < flen;
      const long long p = valid ? (static_cast<long long>(b) * tlen + t) * flen + f : 0;
      cp_async16(smem_u32(xs + q * HS + c0), x + p * cin + x_off + c0, valid);
      if (prev != nullptr)
        cp_async16(smem_u32(ps + q * HS + c0), prev + p * cout + prev_off + c0, valid);
    }
    cp_async_arrive(&bar[stage]);
  };

  // ldmatrix addressing: A rows lane % 16 of each m tile (tap (1, 1) halo
  // position), k half lane / 16; B rows n = nt * 8 + lane % 8, k half
  // (lane / 8) % 2
  int arow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = min(warp * 16 * MT + mt * 16 + lane % 16, rows - 1);
    arow[mt] = ((r / tf_n + 1) * hw + r % tf_n + 1) * HS;
  }
  const int ahalf = lane / 16;
  const uint32_t wbase = smem_u32(ws + (lane % 8) * WS + ((lane / 8) % 2) * 8);
  // this thread's output channels' eval BN, once per CTA
  float bn_mu[NT][2], bn_inv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = nt * 8 + 2 * tg + e;
      bn_mu[nt][e] = mean[co];
      bn_inv[nt][e] = 1.f / sqrtf(var[co] + eps);
    }

  if (blockIdx.x < ntiles) issue(blockIdx.x, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int stage = it & 1;
    __nv_bfloat16* xs = xs0 + stage * hbuf;
    const int b = tile / (tiles_t * tiles_f);
    const int t0 = (tile / tiles_f) % tiles_t * tt_n, f0 = tile % tiles_f * tf_n;
    mbar_wait(&bar[stage], (it >> 1) & 1);
    if (prev != nullptr) {
      for (int i = tid; i < hpos * C8; i += PIPE_THREADS) {
        const int q = i / C8, c0 = (i % C8) * 8;
        const int t = t0 - 1 + (hq[q] >> 16);
        const float mk = mask == nullptr ? 1.f
                         : (t >= 0 && t < tlen ? mask[static_cast<long long>(b) * tlen + t] : 0.f);
        float v[8], y[8];
        load8(xs + q * HS + c0, v);
        load8(ps + q * HS + c0, y);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = vsv::round_to<__nv_bfloat16>(v[j] + y[j] * mk);
        *reinterpret_cast<uint4*>(xs + q * HS + c0) = pack8(v);
      }
    }
    __syncthreads();  // the patch is complete; the y_{i-1} stage is free
    if (tile + gridDim.x < ntiles) issue(tile + gridDim.x, stage ^ 1);

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
    const uint32_t xbase = smem_u32(xs);
#pragma unroll 2
    for (int ks = 0; ks < KSTEPS; ++ks) {
      // this lane's 8-channel chunk; the dead half of an odd last step reads
      // chunk 2 ks again (finite data, multiplied by the zero weight pad)
      int ch = 2 * ks + ahalf;
      if (ch >= CHUNKS) ch = 2 * ks;
      const int tap = ch / C8;
      const int off = ((tap / 3 - 1) * hw + tap % 3 - 1) * HS + (ch % C8) * 8;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], xbase + 2 * (arow[mt] + off));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bf[2];
        ldmatrix_x2(bf, wbase + 2 * (nt * 8 * WS + 16 * ks));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][nt], af[mt], bf);
      }
    }

    // epilogue: round the conv output to bf16, eval BN, relu, store pairs
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 * MT + mt * 16 + g + 8 * h;
        const int t = t0 + r / tf_n, f = f0 + r % tf_n;
        if (r >= rows || t >= tlen || f >= flen) continue;
        __nv_bfloat16* o =
            out + ((static_cast<long long>(b) * tlen + t) * flen + f) * cout + out_off;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int co = nt * 8 + 2 * tg;
          const float v0 = vsv::round_to<__nv_bfloat16>(acc[mt][nt][2 * h]);
          const float v1 = vsv::round_to<__nv_bfloat16>(acc[mt][nt][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(
              fmaxf((v0 - bn_mu[nt][0]) * bn_inv[nt][0], 0.f),
              fmaxf((v1 - bn_mu[nt][1]) * bn_inv[nt][1], 0.f));
        }
      }
    // the pass-through last group, for the patch's positions
    if (tail_width > 0) {
      const int vecs = tail_width / 8;
      for (int i = tid; i < rows * vecs; i += PIPE_THREADS) {
        const int r = i / vecs, c = (i % vecs) * 8;
        const int t = t0 + r / tf_n, f = f0 + r % tf_n;
        if (t < tlen && f < flen) {
          const long long p = (static_cast<long long>(b) * tlen + t) * flen + f;
          *reinterpret_cast<uint4*>(out + p * cout + tail_dst + c) =
              *reinterpret_cast<const uint4*>(x + p * cin + tail_src + c);
        }
      }
    }
    __syncthreads();  // this stage is read out before the next issue reuses it
  }
}

template <int NT, int MT>
int launch_pipe(const void* x, const void* prev, const float* mask, const void* wt, int woff,
                const float* mean, const float* var, void* out, int batch, int tlen, int flen,
                int tt_n, int tf_n, int cin, int x_off, int cout, int prev_off, int out_off,
                int tail_src, int tail_dst, int tail_width, float eps, long long plan_smem,
                int num_sms, cudaStream_t stream) {
  const size_t smem = pipe_smem(8 * NT, tt_n, tf_n);
  if (tt_n * tf_n > 64 * MT || tt_n * tf_n <= 64 * MT - 64 || smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(smem) != plan_smem) return vsv::kPlanMismatch;
  auto kernel = split_group_pipe_kernel<NT, MT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PIPE_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = static_cast<long long>(batch) * ((tlen + tt_n - 1) / tt_n) *
                          ((flen + tf_n - 1) / tf_n);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = std::min<long long>(tiles, static_cast<long long>(per_sm) * num_sms);
  kernel<<<static_cast<unsigned>(grid), PIPE_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(prev), mask,
      static_cast<const __nv_bfloat16*>(wt), woff, mean, var, static_cast<__nv_bfloat16*>(out),
      batch, tlen, flen, tt_n, tf_n, cin, x_off, cout, prev_off, out_off, tail_src, tail_dst,
      tail_width, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fused-chain variant (bfloat16, w = 8 * NT, G = s - 1 groups): the whole
// stride-1 chain in one launch
// ---------------------------------------------------------------------------

constexpr int FUSED_THREADS = 512;  // sixteen warps, one 16-row m tile each at a time

// Row stride (bf16) of a staged full-width position: C plus 8 where C / 8
// is even, so the stride in 16-byte units is odd (conflict-free ldmatrix).
__host__ __device__ constexpr int chain_stride(int channels) {
  return channels + ((channels / 8) % 2 == 0 ? 8 : 0);
}

// Shared memory: the G groups' weights, two stages of the full-width patch
// with a G-position halo, two mbarriers, the halo table (padded to an even
// count), the groups' eval BN (mean, 1 / std) per channel.
__host__ __device__ constexpr size_t fused_smem(int width, int groups, int tt_n, int tf_n) {
  return sizeof(__nv_bfloat16) *
             (static_cast<size_t>(groups) * width * weight_stride(width) +
              2 * static_cast<size_t>(tt_n + 2 * groups) * (tf_n + 2 * groups) *
                  chain_stride((groups + 1) * width)) +
         2 * sizeof(uint64_t) +
         sizeof(int) * ((static_cast<size_t>(tt_n + 2 * groups) * (tf_n + 2 * groups) + 1) / 2 * 2) +
         sizeof(float2) * static_cast<size_t>(groups) * width;
}

// Persistent CTAs walk the TT x TF patches. A patch is staged once, at full
// width (all s*w channels of x: one contiguous row a position) with a
// G-position halo, by cp.async on the stage's mbarrier; the next patch's
// copies are issued as soon as this one has landed, so they overlap all of
// this patch's compute. Group g's conv is an implicit GEMM (M = the patch
// grown by G-1-g positions a side, N = w, K = 9w) on mma.sync with
// ldmatrix fragments, one 16-row m tile per warp at a time (sixteen warps:
// the shrinking rings keep most of them busy); its epilogue (round, eval
// BN, relu) writes y_g on the patch to the output and, inside the
// utterance, x_{g+1} + mask * y_g into the staged x_{g+1} slice in place --
// the next group's input on a ring one position narrower. Positions
// outside the utterance keep their zero fill (the next conv's "same"
// padding). The ring is recomputed by the neighbouring patches: flops, not
// bytes. Every element takes the per-group chain's arithmetic, x is read
// from HBM about once, and each output row is written by one CTA.
template <int NT, int G>
__global__ void __launch_bounds__(FUSED_THREADS) split_chain_fused_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ mask,
    const __nv_bfloat16* __restrict__ wt, const float* __restrict__ mean,
    const float* __restrict__ var, __nv_bfloat16* __restrict__ out, int batch, int tlen,
    int flen, int tt_n, int tf_n, float eps) {
  constexpr int W = 8 * NT, C = (G + 1) * W, C8 = C / 8, CS = chain_stride(C), K = 9 * W;
  constexpr int WS = weight_stride(W), CHUNKS = 9 * NT, KSTEPS = (CHUNKS + 1) / 2;
  constexpr int WARPS = FUSED_THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int xw = tf_n + 2 * G, xpos = (tt_n + 2 * G) * xw, xbuf = xpos * CS;
  __nv_bfloat16* xs0 = ws + G * W * WS;
  uint64_t* bar = reinterpret_cast<uint64_t*>(xs0 + 2 * xbuf);
  int* hq = reinterpret_cast<int*>(bar + 2);  // staged position q -> (q / xw) << 16 | q % xw
  float2* bnp = reinterpret_cast<float2*>(hq + xpos + (xpos & 1));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, tg = lane % 4;
  const int tiles_f = (flen + tf_n - 1) / tf_n, tiles_t = (tlen + tt_n - 1) / tt_n;
  const int ntiles = batch * tiles_t * tiles_f;
  if (tid == 0) {
    mbar_init(&bar[0], FUSED_THREADS);
    mbar_init(&bar[1], FUSED_THREADS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int q = tid; q < xpos; q += FUSED_THREADS) hq[q] = (q / xw) << 16 | (q % xw);
  for (int i = tid; i < G * W; i += FUSED_THREADS)
    bnp[i] = make_float2(mean[i], 1.f / sqrtf(var[i] + eps));
  // the groups' weights: row n = output channel n (group n / W), K taps x
  // input channels, zero-padded to WS; they land with the first patch
  for (int i = tid; i < G * W * (K / 8); i += FUSED_THREADS) {
    const int n = i / (K / 8), k8 = (i % (K / 8)) * 8;
    cp_async16(smem_u32(ws + n * WS + k8), wt + static_cast<long long>(n) * K + k8, true);
  }
  for (int i = tid; i < G * W * (WS - K); i += FUSED_THREADS)
    ws[(i / (WS - K)) * WS + K + i % (WS - K)] = __float2bfloat16(0.f);
  __syncthreads();

  auto issue = [&](int tile, int stage) {
    const int b = tile / (tiles_t * tiles_f);
    const int t0 = (tile / tiles_f) % tiles_t * tt_n, f0 = tile % tiles_f * tf_n;
    __nv_bfloat16* xs = xs0 + stage * xbuf;
    for (int i = tid; i < xpos * C8; i += FUSED_THREADS) {
      const int q = i / C8, c0 = (i % C8) * 8, qq = hq[q];
      const int t = t0 - G + (qq >> 16), f = f0 - G + (qq & 0xffff);
      const bool valid = t >= 0 && t < tlen && f >= 0 && f < flen;
      const long long p = valid ? (static_cast<long long>(b) * tlen + t) * flen + f : 0;
      cp_async16(smem_u32(xs + q * CS + c0), x + p * C + c0, valid);
    }
    cp_async_arrive(&bar[stage]);
  };

  const int ahalf = lane / 16;
  if (blockIdx.x < ntiles) issue(blockIdx.x, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int stage = it & 1;
    __nv_bfloat16* xs = xs0 + stage * xbuf;
    const int b = tile / (tiles_t * tiles_f);
    const int t0 = (tile / tiles_f) % tiles_t * tt_n, f0 = tile % tiles_f * tf_n;
    mbar_wait(&bar[stage], (it >> 1) & 1);
    // the other stage was released by the barrier that ended the last patch
    if (tile + gridDim.x < ntiles) issue(tile + gridDim.x, stage ^ 1);

#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      const int ring = G - 1 - g;  // y_g is computed on the patch grown by `ring`
      const int rw = tf_n + 2 * ring, rows = (tt_n + 2 * ring) * rw;
      const int mtiles = (rows + 15) / 16;
      const uint32_t xbase = smem_u32(xs + g * W);
      const uint32_t wbase = smem_u32(ws + (g * W + lane % 8) * WS + ((lane / 8) % 2) * 8);
      for (int mt = warp; mt < mtiles; mt += WARPS) {
        // ldmatrix rows: position lane % 16 of the m tile, at tap (1, 1)
        const int ra = min(mt * 16 + lane % 16, rows - 1);
        const int arow = ((ra / rw + g + 1) * xw + ra % rw + g + 1) * CS;
        float acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 3
        for (int ks = 0; ks < KSTEPS; ++ks) {
          int ch = 2 * ks + ahalf;
          if (ch >= CHUNKS) ch = 2 * ks;  // the dead half meets the zero weight pad
          const int tap = ch / NT;
          const int off = ((tap / 3 - 1) * xw + tap % 3 - 1) * CS + (ch % NT) * 8;
          uint32_t af[4];
          ldmatrix_x4(af, xbase + 2 * (arow + off));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bf[2];
            ldmatrix_x2(bf, wbase + 2 * (nt * 8 * WS + 16 * ks));
            mma_bf16_16816(acc[nt], af, bf);
          }
        }
        // epilogue: round the conv output to bf16, eval BN, relu; y_g on
        // the patch to the output, x_{g+1} + mask * y_g into the stage
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g8 + 8 * h;
          if (r >= rows) continue;
          const int rt = r / rw, rf = r % rw;
          const int t = t0 - ring + rt, f = f0 - ring + rf;
          if (t < 0 || t >= tlen || f < 0 || f >= flen) continue;
          const bool on_patch = rt >= ring && rt < ring + tt_n && rf >= ring && rf < ring + tf_n;
          const long long p = (static_cast<long long>(b) * tlen + t) * flen + f;
          const float mk = mask == nullptr ? 1.f : mask[static_cast<long long>(b) * tlen + t];
          __nv_bfloat16* nxt = xs + ((rt + g + 1) * xw + rf + g + 1) * CS + (g + 1) * W;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int co = nt * 8 + 2 * tg;
            const float2 p0 = bnp[g * W + co], p1 = bnp[g * W + co + 1];
            const float v0 = vsv::round_to<__nv_bfloat16>(acc[nt][2 * h]);
            const float v1 = vsv::round_to<__nv_bfloat16>(acc[nt][2 * h + 1]);
            const __nv_bfloat162 y = __floats2bfloat162_rn(fmaxf((v0 - p0.x) * p0.y, 0.f),
                                                           fmaxf((v1 - p1.x) * p1.y, 0.f));
            if (on_patch) *reinterpret_cast<__nv_bfloat162*>(out + p * C + g * W + co) = y;
            if (g + 1 < G) {
              const float2 yf = __bfloat1622float2(y);
              const float2 xf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(nxt + co));
              *reinterpret_cast<__nv_bfloat162*>(nxt + co) =
                  __floats2bfloat162_rn(xf.x + yf.x * mk, xf.y + yf.y * mk);
            }
          }
        }
      }
      __syncthreads();  // group g+1 reads what group g wrote
    }
    // the pass-through last group, for the patch's positions
    for (int i = tid; i < tt_n * tf_n * NT; i += FUSED_THREADS) {
      const int r = i / NT, c = (i % NT) * 8;
      const int t = t0 + r / tf_n, f = f0 + r % tf_n;
      if (t < tlen && f < flen) {
        const long long p = (static_cast<long long>(b) * tlen + t) * flen + f;
        *reinterpret_cast<uint4*>(out + p * C + G * W + c) = *reinterpret_cast<const uint4*>(
            xs + ((r / tf_n + G) * xw + r % tf_n + G) * CS + G * W + c);
      }
    }
    __syncthreads();  // this stage is read out before the next issue reuses it
  }
}

template <int NT, int G>
int launch_fused(const void* x, const float* mask, const void* wt, const float* mean,
                 const float* var, void* out, int batch, int tlen, int flen, int tt_n, int tf_n,
                 float eps, long long plan_smem, int num_sms, cudaStream_t stream) {
  const size_t smem = fused_smem(8 * NT, G, tt_n, tf_n);
  if (tt_n < 1 || tf_n < 1 || smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(smem) != plan_smem) return vsv::kPlanMismatch;
  auto kernel = split_chain_fused_kernel<NT, G>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FUSED_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = static_cast<long long>(batch) * ((tlen + tt_n - 1) / tt_n) *
                          ((flen + tf_n - 1) / tf_n);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = std::min<long long>(tiles, static_cast<long long>(per_sm) * num_sms);
  kernel<<<static_cast<unsigned>(grid), FUSED_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), mask, static_cast<const __nv_bfloat16*>(wt), mean,
      var, static_cast<__nv_bfloat16*>(out), batch, tlen, flen, tt_n, tf_n, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// warpgroup-MMA variant (bfloat16, w % 16 == 0, 64 <= w <= 192): one launch
// per group, wgmma with N = w
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 384;       // a producer warpgroup and two consumer warpgroups
constexpr int WG_PATCH_THREADS = 96;  // producer warps 1-3 stage the patches
constexpr int WG_DRAIN = 4;           // output chunks a consumer thread has in flight (8:
                                      // 168 registers, and a third slower)
#ifdef VSV_WG_PROF
// Built with -DVSV_WG_PROF (scripts/profile_k2_wgmma.py), one thread of each
// role adds its phases' clock64 cycles here, 16 slots a CTA: [0] patch wait,
// [1] ldmatrix, [2] weight-slice wait, [3] wgmma to its wait, [4] epilogue and
// write-out, [5] tiles, [6] producer's stage wait, [7] producer's copies,
// [8] weight thread's ring wait. Consumer slots sum both warpgroups.
__device__ unsigned long long g_wg_prof[1024 * 16];
#define WG_T0(v) const long long v = clock64();
#define WG_ADD(slot, v) if (prof_on) atomicAdd(&g_wg_prof[blockIdx.x * 16 + (slot)], (unsigned long long)(clock64() - (v)));
#else
#define WG_T0(v)
#define WG_ADD(slot, v)
#endif

// Per width: MT 64-row m tiles per consumer warpgroup (two where w is a
// multiple of 32 up to 96, so a tile has 256 rows and the weights, streamed
// from L2 once per tile, are read half as often; one above, where N = w
// alone fills 96 accumulator registers), KPS k steps per weight slice, RING
// slices in flight (as many as fit beside the patch stages: with the MMAs
// and the patches taken away, the weight stream ran at the ring's bytes in
// flight over L2's latency).
template <int W> struct WgShape {
  static constexpr int MT = (W % 32 == 0 && W <= 96) ? 2 : 1;
  static constexpr int ROWS = 2 * 64 * MT;
  static constexpr int KPS = MT == 2 ? 2 : 3;
  static constexpr int RING = MT == 2 ? 12 : 5;
  static constexpr int KSTEPS = 9 * W / 16;
  static constexpr int SLICES = KSTEPS / KPS;
  static constexpr int SLICE_BYTES = KPS * 16 * W * 2;
  static_assert(W % 16 == 0 && KSTEPS % KPS == 0, "width");
};

__host__ __device__ constexpr int wgmma_rows(int width) {
  return (width % 32 == 0 && width <= 96) ? 256 : 128;
}

// Shared memory: the weight ring (RING slices of K = 16 * KPS rows, laid out
// [k / 8][n][k % 8]), two halo-patch stages, the group's eval BN (mean,
// 1 / std) per channel, 4 + 2 * RING mbarriers.
__host__ __device__ constexpr size_t wgmma_smem(int width, int tt_n, int tf_n) {
  return static_cast<size_t>(wgmma_rows(width) == 256 ? 12 * 2 : 5 * 3) * 16 * width * 2 +
         2 * sizeof(__nv_bfloat16) * static_cast<size_t>(tt_n + 2) * (tf_n + 2) *
             halo_stride(width) +
         sizeof(float2) * width + sizeof(uint64_t) * (4 + 2 * (wgmma_rows(width) == 256 ? 12 : 5));
}

// A wait on a stage that lasts this long means a role stopped feeding it:
// trap (a launch error) rather than hang the card
constexpr unsigned long long kWaitTimeoutNs = 10000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, int parity) {
  uint32_t done = 0;
  unsigned long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > kWaitTimeoutNs) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One weight slice of a consumer warpgroup's patch: KPS k steps of 16 input
// channels (each inside one tap): the A fragments by ldmatrix from the
// staged patch, then, once the slice has landed, its wgmmas; the slice's
// stage is released when they are done. `n` counts the slices taken (the
// ring's position and phase).
template <int W>
__device__ __forceinline__ void wgmma_slice(float (&acc)[WgShape<W>::MT][W / 2],
                                            uint32_t (&a)[WgShape<W>::KPS][WgShape<W>::MT][4],
                                            int sl, int& n, uint32_t xbase,
                                            const int (&arow)[WgShape<W>::MT], int hw,
                                            uint64_t* wfull, uint64_t* wempty,
                                            const unsigned char* wring) {
  using S = WgShape<W>;
  constexpr int HS = halo_stride(W), MT = S::MT;
#ifdef VSV_WG_PROF
  const bool prof_on = (threadIdx.x % 128) == 0;
#endif
  WG_T0(c0)
#pragma unroll
  for (int kk = 0; kk < S::KPS; ++kk) {
    const int ks = sl * S::KPS + kk, tap = ks / (W / 16);
    const int off = ((tap / 3 - 1) * hw + tap % 3 - 1) * HS + (ks % (W / 16)) * 16;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[kk][mt], xbase + 2 * (arow[mt] + off));
  }
  const int st = n % S::RING;
  WG_ADD(1, c0)
  WG_T0(c1)
  mbar_wait_bounded(&wfull[st], (n / S::RING) & 1);
  WG_ADD(2, c1)
  WG_T0(c2)
  const uint32_t wb = smem_u32(wring + st * S::SLICE_BYTES);
  uint64_t desc[S::KPS];
#pragma unroll
  for (int kk = 0; kk < S::KPS; ++kk) desc[kk] = vsv::wgmma_desc(wb + kk * 2 * 16 * W, 16 * W, 128);
  const int accumulate = sl > 0 ? 1 : 0;
#pragma unroll
  for (int kk = 0; kk < S::KPS; ++kk)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(a[kk][mt]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(acc[mt]);
  vsv::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < S::KPS; ++kk)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      vsv::WgmmaRS<W>::mma(acc[mt], a[kk][mt], desc[kk], kk > 0 ? 1 : accumulate);
  vsv::wgmma_commit();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(acc[mt]);
  vsv::wgmma_wait<0>();
#pragma unroll
  for (int kk = 0; kk < S::KPS; ++kk)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(a[kk][mt]);
  mbar_arrive(&wempty[st]);  // the slice's MMAs are done: free its stage
  WG_ADD(3, c2)
  ++n;
}

// Persistent CTAs, about one an SM, walk the TT x TF patches of the (B, T, F)
// grid. Warp 0 of the producer warpgroup streams the group's weights (wt:
// (9w / 8, w, 8), [k / 8][output channel][k % 8]) into a ring of RING
// slices, one bulk copy (the TMA's 1-D form) a slice on the slice's
// mbarrier, in the same order for every patch. Warps 1-3 stage the next
// patch of the group's input with its one-position halo into the other of
// two stages by cp.async, zero-filled outside the utterance, the whole
// patch in flight at once, landing on the stage's mbarrier. The input is
// x_i for group 0 and otherwise in_i = x_i + mask * y_{i-1} (rounded to
// bf16), which the previous group's epilogue wrote beside y_{i-1}: so a
// patch is one tensor's copies, with no arithmetic on the way. The two
// consumer warpgroups split the patch's rows (MT 64-row m tiles each) and
// run the implicit GEMM (M = the patch, N = w, K = 9w, tap-major) with
// wgmma m64nWk16: A (the tap's shifted patch rows, not one strided block)
// from registers by ldmatrix, B from the weight ring by descriptor, KPS k
// steps a slice. Their epilogue rounds the conv output to bf16, applies
// eval BN and relu, leaves y_i in the patch's (read-out) stage, and then
// both warpgroups write the stage out in 16-byte row chunks: y_i into
// channel slice i of out and, where a next group follows, in_{i+1} =
// x_{i+1} + mask * y_i into next_in. (Written straight from the MMA
// fragments, 4-byte pieces of eight rows a warp store, the outputs took two
// fifths of the consumers' time.)
template <int W>
__global__ void __launch_bounds__(WG_THREADS, 1) split_group_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ src, int src_stride,
    int src_off, const float* __restrict__ mask, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ mean, const float* __restrict__ var, __nv_bfloat16* out,
    __nv_bfloat16* __restrict__ next_in, int batch, int tlen, int flen, int tt_n, int tf_n,
    int cin, int next_off, int cout, int out_off, int tail_src, int tail_dst, int tail_width,
    float eps) {
  using S = WgShape<W>;
  constexpr int HS = halo_stride(W), C8 = W / 8, MT = S::MT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* wring = smem_raw;
  __nv_bfloat16* patch0 = reinterpret_cast<__nv_bfloat16*>(smem_raw + S::RING * S::SLICE_BYTES);
  const int hw = tf_n + 2, hpos = (tt_n + 2) * hw, hbuf = hpos * HS;
  float2* bnp = reinterpret_cast<float2*>(patch0 + 2 * hbuf);
  uint64_t* pfull = reinterpret_cast<uint64_t*>(bnp + W);
  uint64_t* pempty = pfull + 2;
  uint64_t* wfull = pfull + 4;
  uint64_t* wempty = wfull + S::RING;

  const int tid = threadIdx.x, wg = tid / 128;
  const int tiles_f = (flen + tf_n - 1) / tf_n, tiles_t = (tlen + tt_n - 1) / tt_n;
  const int ntiles = batch * tiles_t * tiles_f, rows = tt_n * tf_n;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&pfull[s], WG_PATCH_THREADS);
      mbar_init(&pempty[s], 256);
    }
    for (int s = 0; s < S::RING; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 256);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int i = tid; i < W; i += WG_THREADS) bnp[i] = make_float2(mean[i], 1.f / sqrtf(var[i] + eps));
  __syncthreads();  // the last block-wide barrier: the roles part here

  if (wg == 0) {
    if (tid == 0) {
      // the weight ring: every patch takes the slices 0 .. SLICES-1 in order
      int n = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
        for (int sl = 0; sl < S::SLICES; ++sl, ++n) {
          const int st = n % S::RING;
#ifdef VSV_WG_PROF
          const bool prof_on = true;
#endif
          WG_T0(c8)
          mbar_wait_bounded(&wempty[st], ((n / S::RING) & 1) ^ 1);
          WG_ADD(8, c8)
          const uint32_t bar = smem_u32(&wfull[st]);
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                       "r"(S::SLICE_BYTES)
                       : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
              "%2, [%3];\n" ::"r"(smem_u32(wring + st * S::SLICE_BYTES)),
              "l"(reinterpret_cast<const unsigned char*>(wt) +
                  static_cast<long long>(sl) * S::SLICE_BYTES),
              "r"(S::SLICE_BYTES), "r"(bar)
              : "memory");
        }
    } else if (tid >= 32) {
      const int pt = tid - 32;
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
        const int ps = it & 1;
        const int b = tile / (tiles_t * tiles_f);
        const int t0 = (tile / tiles_f) % tiles_t * tt_n, f0 = tile % tiles_f * tf_n;
#ifdef VSV_WG_PROF
        const bool prof_on = pt == 0;
#endif
        WG_T0(c6)
        mbar_wait_bounded(&pempty[ps], ((it >> 1) & 1) ^ 1);
        WG_ADD(6, c6)
        WG_T0(c7)
        __nv_bfloat16* xs = patch0 + ps * hbuf;
        for (int i = pt; i < hpos * C8; i += WG_PATCH_THREADS) {
          const int q = i / C8, c0 = (i % C8) * 8;
          const int t = t0 - 1 + q / hw, f = f0 - 1 + q % hw;
          const bool valid = t >= 0 && t < tlen && f >= 0 && f < flen;
          const long long p = valid ? (static_cast<long long>(b) * tlen + t) * flen + f : 0;
          cp_async16(smem_u32(xs + q * HS + c0), src + p * src_stride + src_off + c0, valid);
        }
        cp_async_arrive(&pfull[ps]);  // arrives when this thread's copies land
        WG_ADD(7, c7)
        // the pass-through last group, for the patch's positions
        if (tail_width > 0) {
          const int vecs = tail_width / 8;
          for (int i = pt; i < rows * vecs; i += WG_PATCH_THREADS) {
            const int r = i / vecs, c = (i % vecs) * 8;
            const int t = t0 + r / tf_n, f = f0 + r % tf_n;
            if (t < tlen && f < flen) {
              const long long p = (static_cast<long long>(b) * tlen + t) * flen + f;
              *reinterpret_cast<uint4*>(out + p * cout + tail_dst + c) =
                  __ldg(reinterpret_cast<const uint4*>(x + p * cin + tail_src + c));
            }
          }
        }
      }
      // copies that arrive on an mbarrier must land before the CTA exits
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    return;
  }

  // consumer warpgroup cw: patch rows [cw * 64 * MT, (cw + 1) * 64 * MT)
  const int cw = wg - 1, wtid = tid % 128, wi = wtid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  // ldmatrix rows: lane % 16 of the warp's 16 rows of each m tile, at tap
  // (1, 1); rows past the patch read a valid position and are never stored
  int arow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = min(cw * 64 * MT + mt * 64 + wi * 16 + lane % 16, rows - 1);
    arow[mt] = ((r / tf_n + 1) * hw + r % tf_n + 1) * HS + (lane / 16) * 8;
  }
  float acc[MT][W / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[mt][i] = 0.f;

  int n = 0;  // weight slices taken so far
  for (int tile = blockIdx.x, it = 0; tile < ntiles; tile += gridDim.x, ++it) {
#ifdef VSV_WG_PROF
    const bool prof_on = wtid == 0;
#endif
    WG_T0(c0)
    mbar_wait_bounded(&pfull[it & 1], (it >> 1) & 1);
    WG_ADD(0, c0)
    const uint32_t xbase = smem_u32(patch0 + (it & 1) * hbuf);
    uint32_t a0[S::KPS][MT][4];
    for (int sl = 0; sl < S::SLICES; ++sl)
      wgmma_slice<W>(acc, a0, sl, n, xbase, arow, hw, wfull, wempty, wring);

    WG_T0(c4)
    // epilogue: round the conv output to bf16, eval BN, relu, and leave
    // y_i in the patch's stage (row r at r * HS) once both warpgroups have
    // read the patch
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
    __nv_bfloat16* ob = patch0 + (it & 1) * hbuf;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = cw * 64 * MT + mt * 64 + wi * 16 + g + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          const int co = 8 * j + 2 * tg;
          const float2 p0 = bnp[co], p1 = bnp[co + 1];
          const float v0 = vsv::round_to<__nv_bfloat16>(acc[mt][4 * j + 2 * h]);
          const float v1 = vsv::round_to<__nv_bfloat16>(acc[mt][4 * j + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(ob + r * HS + co) = __floats2bfloat162_rn(
              fmaxf((v0 - p0.x) * p0.y, 0.f), fmaxf((v1 - p1.x) * p1.y, 0.f));
        }
      }
    // then both warpgroups write the stage out: y_i to out and in_{i+1} =
    // x_{i+1} + mask * y_i to next_in, 16-byte row chunks, WG_DRAIN in
    // flight a thread
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
    {
      const int b = tile / (tiles_t * tiles_f);
      const int t0 = (tile / tiles_f) % tiles_t * tt_n, f0 = tile % tiles_f * tf_n;
      const int ct = tid - 128, total = rows * C8;
      for (int base = ct; base < total; base += 256 * WG_DRAIN) {
        uint4 xv[WG_DRAIN];
        float mk[WG_DRAIN];
#pragma unroll
        for (int u = 0; u < WG_DRAIN; ++u) {
          const int i = base + u * 256;
          const int r = i / C8, c0 = (i % C8) * 8;
          const int t = t0 + r / tf_n, f = f0 + r % tf_n;
          if (next_in != nullptr && i < total && t < tlen && f < flen) {
            const long long bt = static_cast<long long>(b) * tlen + t;
            xv[u] = __ldg(reinterpret_cast<const uint4*>(x + (bt * flen + f) * cin + next_off + c0));
            mk[u] = mask != nullptr ? mask[bt] : 1.f;
          }
        }
#pragma unroll
        for (int u = 0; u < WG_DRAIN; ++u) {
          const int i = base + u * 256;
          const int r = i / C8, c0 = (i % C8) * 8;
          const int t = t0 + r / tf_n, f = f0 + r % tf_n;
          if (i >= total || t >= tlen || f >= flen) continue;
          const long long p = (static_cast<long long>(b) * tlen + t) * flen + f;
          const uint4 y = *reinterpret_cast<const uint4*>(ob + r * HS + c0);
          *reinterpret_cast<uint4*>(out + p * cout + out_off + c0) = y;
          if (next_in != nullptr) {
            float a[8], yf[8];
            load8(reinterpret_cast<const __nv_bfloat16*>(&xv[u]), a);
            load8(reinterpret_cast<const __nv_bfloat16*>(&y), yf);
#pragma unroll
            for (int j = 0; j < 8; ++j) a[j] += yf[j] * mk[u];
            *reinterpret_cast<uint4*>(next_in + p * W + c0) = pack8(a);
          }
        }
      }
    }
    mbar_arrive(&pempty[it & 1]);  // the stage is free for the next patch
    WG_ADD(4, c4)
#ifdef VSV_WG_PROF
    if (prof_on) atomicAdd(&g_wg_prof[blockIdx.x * 16 + 5], 1ull);
#endif
  }
}

template <int W>
int launch_wgmma(const void* x, const void* src, int src_stride, int src_off, const float* mask,
                 const void* wt, const float* mean, const float* var, void* out, void* next_in,
                 int batch, int tlen, int flen, int tt_n, int tf_n, int cin, int next_off,
                 int cout, int out_off, int tail_src, int tail_dst, int tail_width, float eps,
                 long long plan_smem, int num_sms, cudaStream_t stream) {
  const size_t smem = wgmma_smem(W, tt_n, tf_n);
  if (tt_n < 1 || tf_n < 1 || tt_n * tf_n > WgShape<W>::ROWS || smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(smem) != plan_smem) return vsv::kPlanMismatch;
  auto kernel = split_group_wgmma_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = static_cast<long long>(batch) * ((tlen + tt_n - 1) / tt_n) *
                          ((flen + tf_n - 1) / tf_n);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = std::min<long long>(tiles, static_cast<long long>(per_sm) * num_sms);
  kernel<<<static_cast<unsigned>(grid), WG_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(src), src_stride,
      src_off, mask, static_cast<const __nv_bfloat16*>(wt), mean, var,
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(next_in), batch, tlen, flen,
      tt_n, tf_n, cin, next_off, cout, out_off, tail_src, tail_dst, tail_width, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Fused-chain variant: bfloat16, x (B, T, F, s*w) channels-last with
// w = 8 * nt (nt 1..4) and groups = s - 1 (3 or 5); wt as split_group_mma's
// (rows [i*w, (i+1)*w) for group i); mean/var: (groups, w) fp32. One launch
// computes the whole chain and writes every channel of out. The patch
// tt_n x tf_n must fit fused_smem(w, groups, tt_n, tf_n) <= 227 KB; the
// caller's plan (models/res2net.py:split_plan) passes that size as
// plan_smem, and a plan whose size differs from this layout's is refused
// (vsv::kPlanMismatch).
extern "C" int split_chain_fused(int nt, int groups, const void* x, const float* mask,
                                 const void* wt, const float* mean, const float* var, void* out,
                                 int batch, int tlen, int flen, int tt_n, int tf_n, float eps,
                                 long long plan_smem, int num_sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VSV_FUSED_CASE(N, GG)                                                                  \
  if (nt == N && groups == GG)                                                                 \
    return launch_fused<N, GG>(x, mask, wt, mean, var, out, batch, tlen, flen, tt_n, tf_n, eps, \
                               plan_smem, num_sms, s);
  VSV_FUSED_CASE(1, 3) VSV_FUSED_CASE(2, 3) VSV_FUSED_CASE(3, 3) VSV_FUSED_CASE(4, 3)
  VSV_FUSED_CASE(1, 5) VSV_FUSED_CASE(2, 5) VSV_FUSED_CASE(3, 5) VSV_FUSED_CASE(4, 5)
#undef VSV_FUSED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Warpgroup-MMA variant, one group: bfloat16, width a multiple of 16 from
// 64 to 192. The group's input is read from src (channel stride src_stride,
// offset src_off): x's slice i for group 0, else the in_i that the previous
// group wrote. wt: this group's weights as (9 * width / 8, width, 8)
// bfloat16, [k / 8][output channel][k % 8] with k = tap * width + input
// channel (tap-major), 16-byte aligned. y_i goes to out's channels [out_off,
// out_off + width); where next_in is not null, in_{i+1} = x's slice at
// next_off + mask * y_i goes to next_in (B, T, F, width). The patch tt_n x
// tf_n positions with tt_n * tf_n <= wgmma_rows(width). Shared memory
// wgmma_smem(width, tt_n, tf_n) <= 227 KB, passed as plan_smem by the plan
// (models/res2net.py:split_plan) and refused where it differs from this
// layout's (vsv::kPlanMismatch). Every offset and width a multiple of 8,
// pointers 16-byte aligned; the other arguments as split_group_mma's.
extern "C" int split_group_wgmma(int width, const void* x, const void* src, int src_stride,
                                 int src_off, const float* mask, const void* wt,
                                 const float* mean, const float* var, void* out, void* next_in,
                                 int batch, int tlen, int flen, int tt_n, int tf_n, int cin,
                                 int next_off, int cout, int out_off, int tail_src, int tail_dst,
                                 int tail_width, float eps, long long plan_smem, int num_sms,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tail_width % 8 != 0 || src_stride % 8 != 0 || src_off % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define VSV_WGMMA_CASE(N)                                                                      \
  case N:                                                                                      \
    return launch_wgmma<N>(x, src, src_stride, src_off, mask, wt, mean, var, out, next_in,     \
                           batch, tlen, flen, tt_n, tf_n, cin, next_off, cout, out_off,        \
                           tail_src, tail_dst, tail_width, eps, plan_smem, num_sms, s);
  switch (width) {
    VSV_WGMMA_CASE(64)
    VSV_WGMMA_CASE(80)
    VSV_WGMMA_CASE(96)
    VSV_WGMMA_CASE(112)
    VSV_WGMMA_CASE(128)
    VSV_WGMMA_CASE(144)
    VSV_WGMMA_CASE(160)
    VSV_WGMMA_CASE(176)
    VSV_WGMMA_CASE(192)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VSV_WGMMA_CASE
}

#ifdef VSV_WG_PROF
extern "C" int split_wgmma_prof(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_wg_prof, sizeof(unsigned long long) * 1024 * 16);
  if (reset) {
    static unsigned long long zeros[1024 * 16];
    cudaMemcpyToSymbol(g_wg_prof, zeros, sizeof(zeros));
  }
  return static_cast<int>(e);
}
#endif

// Pipelined variant: bfloat16, width = 8 * nt with nt one of 1, 2, 3, 4, 6,
// 8, 12; mt (1 or 2) m tiles of 16 patch rows per warp, the patch tt_n x
// tf_n positions with 64 * (mt - 1) < tt_n * tf_n <= 64 * mt. Shared memory
// pipe_smem(width, tt_n, tf_n) <= 227 KB, passed as plan_smem by the plan
// (models/res2net.py:split_plan) and refused where it differs from this
// layout's (vsv::kPlanMismatch). Other arguments as split_group_mma.
extern "C" int split_group_pipe(int nt, int mt, const void* x, const void* prev,
                                const float* mask, const void* wt, int woff,
                                const float* mean, const float* var, void* out, int batch,
                                int tlen, int flen, int tt_n, int tf_n, int cin, int x_off,
                                int cout, int prev_off, int out_off, int tail_src,
                                int tail_dst, int tail_width, float eps, long long plan_smem,
                                int num_sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tail_width % 8 != 0 || (mt != 1 && mt != 2)) return static_cast<int>(cudaErrorInvalidValue);
#define VSV_PIPE_CASE(N)                                                                      \
  case N:                                                                                     \
    return (mt == 2 ? launch_pipe<N, 2> : launch_pipe<N, 1>)(                                 \
        x, prev, mask, wt, woff, mean, var, out, batch, tlen, flen, tt_n, tf_n, cin, x_off,   \
        cout, prev_off, out_off, tail_src, tail_dst, tail_width, eps, plan_smem, num_sms, s);
  switch (nt) {
    VSV_PIPE_CASE(1)
    VSV_PIPE_CASE(2)
    VSV_PIPE_CASE(3)
    VSV_PIPE_CASE(4)
    VSV_PIPE_CASE(6)
    VSV_PIPE_CASE(8)
    VSV_PIPE_CASE(12)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VSV_PIPE_CASE
}

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
