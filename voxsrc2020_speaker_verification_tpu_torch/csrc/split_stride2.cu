// K10: the Res2Net stride-2 split stage, eval mode.
//
// Replaces: voxsrc2020_speaker_verification_tpu/models/res2net.py
// Res2NetSplitConv, strides > 1 branch (lines 52-80): ops.fixed_padding
// (ops/nn.py:88-91), ops.grouped_conv at stride 2 with feature_group_count
// = s - 1 over the first (s-1) w channels (ops/nn.py:223-245), eval BN +
// relu of each group, ops.avg_pool_3x3 of the padded last group
// (ops/nn.py:571-588) and the concat, which XLA ran as a pad, a grouped
// conv, the BNs, nine strided-slice adds and a copy. The port ran them as
// F.pad, a cuDNN grouped conv, K3, nine strided adds and torch.cat.
//
// x (B, T, F, s*w) channels-last; output (B, T', F', s*w) with T' = (T-1)/2
// + 1, F' = (F-1)/2 + 1. Output position (t', f') reads x at rows 2t'-1 ..
// 2t'+1 and columns 2f'-1 .. 2f'+1, zero outside [0, T) x [0, F) (the
// padding is implicit: no padded copy exists):
//   out[..., i*w + n]     = relu((round(conv_i) - mean_i) / sqrt(var_i + eps))
//                           for i < s-1, conv_i over group i's own w channels
//   out[..., (s-1)*w + c] = the nine taps of group s-1 added in (di, dj)
//                           order, each add rounded to the dtype, times 1/9
// written straight into the concatenated output. The conv output is rounded
// to the dtype before the BN, as the JAX package's conv output is; the
// average pool rounds where avg_pool_3x3 does on the card (a bf16 add
// rounds its float sum; the division by the scalar 9 is a product with
// 1.0f / 9.0f), so the tail is that function's bits. The weight is read as
// the module holds it, OIHW ((s-1) w, w, 3, 3).
//
// Bound on the card: bytes. A stage reads x once and writes a quarter of it
// (10 s w bytes an output position in bf16) for 18 w^2 (s-1) flops: 259
// flop/B at w = 192, s = 4, below Hopper's ridge (~295), less at the
// narrower widths. The three stride-2 stages of a res2net50_w24_s4_c32
// serving forward (B = 128, 1000 frames) move 8.60 GB (2.57 ms at 3.35 TB/s)
// for 0.96 TFLOP (0.97 ms at 989 TFLOP/s). One launch a stage.
//
// * "mma" (bfloat16 at the registered Res2Nets' stride-2 widths, 16-192,
//   and the thin variants' 8): persistent CTAs, each a (group, slice of the
//   group's output channels, run of the group's (sample, tile) items), a
//   tile tt x tf output positions of one utterance. The slice's weights are
//   staged once from OIHW and stay resident (the whole group's up to w =
//   96, a quarter at 192). The run's stages, a stage one tile's x patch of
//   a chunk of the input channels, go through a two-stage ring that
//   producer warps fill while the consumer warps run the stage before: one
//   lane's TMA boxes, or two warps' cp.async (w = 16, where TMA's 32-byte
//   rows ran slower). A stage is the patch's even and its odd input columns
//   ((2tt+1) rows of tf + 1 columns two apart, by the tensor map's element
//   stride), zero-filled outside the utterance, so the rows of an MMA
//   fragment (consecutive f', two columns apart in x) are consecutive in
//   shared memory; rows swizzled (TMA) or padded to an odd number of
//   16-byte units (cp.async) so that ldmatrix meets no bank conflict. The
//   consumers: a warpgroup on wgmma (m64 x the slice x k16, A from
//   registers by ldmatrix a group of taps ahead, B the resident weights) at
//   w >= 32, a warp on mma.sync at w = 8 and 16. The epilogue rounds,
//   applies the eval BN (staged once a CTA) and relu, and stores from the
//   accumulators (w = 48, 96, 192: no tile buffer, so larger tiles fit) or
//   through a tile buffer as 16-byte rows into the output's channel slice.
//   The last group's average pool is dealt out over every CTA as stages of
//   their own, spread evenly among its conv stages: a pool stage's patch
//   comes through the same ring and its nine taps are added out of shared
//   memory. At w = 48, s = 4 the whole-row form instead: a CTA takes every
//   group of its tiles, x's 192 channels in three 128-byte-row TMA chunks
//   (x read once; a 96-byte group slice a request ran at 40-50% of the
//   bound), each chunk's k steps into their group's accumulators and the
//   last group's channels pooled. Index math divides by the plan's tile
//   width by multiply-shift, never per element by a runtime division. The
//   kernel per width and the tile are the plan's (models/res2net.py:
//   _STRIDE2_RING, stride2_candidates), the CTA counts from 132 SMs, a
//   constant: a function of the shape alone.
// * "vec" / "single" (float32, and bfloat16 at other widths): the same
//   implicit GEMM as fp32 FMA on CUDA cores (K2's split_group scheme:
//   128 positions by 8 tn output channels a block), x gathered 16 bytes
//   (vec: w fills 16-byte vectors) or one element (single) at a time,
//   the weights in their JAX layout (3, 3, w, w (s-1)). float32 stays off
//   the tensor cores: TF32 would cost 13 mantissa bits the plain version
//   keeps.
//
// The FMA designs' average-pool CTAs read their taps from x directly (16
// bytes or one element at a time); the overlapping taps of neighbouring
// outputs come from L2.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kSmemMax = 232448;  // 227 KB, the most a block can take
constexpr int kMaxThreads = 320;  // eight consumer warps and two producer warps
constexpr int kMaxGroups = 8;      // conv groups s - 1, at most

// Each group's running statistics, passed by value: the BN modules' own
// tensors, so the wrapper concatenates nothing
struct GroupStats {
  const float* mean[kMaxGroups];
  const float* var[kMaxGroups];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
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

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// V consecutive elements: one 16-byte vector (V = 16 / sizeof(T)) or one
// element (V = 1)
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (V == 1) {
    v[0] = vsv::to_f(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    vsv::unpack16(*reinterpret_cast<const uint4*>(p), v, p);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (V == 1) {
    *p = vsv::from_f<T>(v[0]);
  } else {
    vsv::store16(p, v);
  }
}

// Row stride (bf16) of a staged position: w plus a pad that makes it an odd
// number of 16-byte units (models/res2net.py:_halo_stride)
__host__ __device__ constexpr int halo_stride(int width) {
  return width + 2 * ((4 - (width / 2) % 8 + 8) % 8);
}

// K columns of a tap in the mma design's weights: the w input channels
// padded to whole k steps of 16 (models/res2net.py:_stride2_tap_cols)
__host__ __device__ constexpr int tap_cols(int width) { return (width + 15) / 16 * 16; }

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr long long align16(long long v) { return (v + 15) / 16 * 16; }

__host__ __device__ constexpr long long align1024(long long v) { return (v + 1023) / 1024 * 1024; }

// The phase profile (a build with -DVSV_K10_PROF, scripts/profile_k10.py):
// the first consumer thread and the producer warp's first lane of each CTA
// lap clock64 into their phases and add them, once at their end, to
// g_k10_prof[slot]. Without the flag every call is empty.
enum { kPhPatch, kPhWeight, kPhMma, kPhEpilogue, kPhPool, kPhIssue, kPhProduceWait,
       kPhEpiWait, kPhEpiRows, kPhTiles, kPhPoolTiles, kPhCtas, kProfSlots };
#ifdef VSV_K10_PROF
__device__ unsigned long long g_k10_prof[kProfSlots];
struct Prof {
  unsigned long long v[kProfSlots];
  long long t;
  bool on;
  __device__ explicit Prof(bool on_) : on(on_) {
    for (int i = 0; i < kProfSlots; ++i) v[i] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void lap(int slot) {
    const long long n = clock64();
    v[slot] += n - t;
    t = n;
  }
  __device__ __forceinline__ void count(int slot) { ++v[slot]; }
  __device__ __forceinline__ void mark() { t = clock64(); }
  __device__ void flush(bool cta) {
    if (!on) return;
    v[kPhCtas] = cta;
    for (int i = 0; i < kProfSlots; ++i) atomicAdd(&g_k10_prof[i], v[i]);
  }
};
#else
struct Prof {
  __device__ explicit Prof(bool) {}
  __device__ __forceinline__ void mark() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void count(int) {}
  __device__ __forceinline__ void flush(bool) {}
};
#endif

// The average pool of one output position (b, ot, of), V channels from c of
// the last group (channel offset src), in avg_pool_3x3's order and rounding
template <typename T, int V>
__device__ __forceinline__ void pool_at(const T* __restrict__ x, T* __restrict__ out, int b,
                                        int ot, int of, int c, int tlen, int flen, int tout,
                                        int fout, int channels, int src) {
  float acc[V];
#pragma unroll
  for (int di = 0; di < 3; ++di)
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int t = 2 * ot - 1 + di, f = 2 * of - 1 + dj;
      float v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.f;
      if (t >= 0 && t < tlen && f >= 0 && f < flen)
        load_vec<T, V>(x + ((static_cast<long long>(b) * tlen + t) * flen + f) * channels + src + c,
                       v);
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[e] = (di == 0 && dj == 0) ? v[e] : vsv::round_to<T>(acc[e] + v[e]);
    }
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = acc[e] * (1.0f / 9.0f);
  store_vec<T, V>(out + ((static_cast<long long>(b) * tout + ot) * fout + of) * channels + src + c,
                  acc);
}

// ---------------------------------------------------------------------------
// "mma": bfloat16 on the tensor cores, persistent CTAs
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// n / d by a multiply with ceil(2^32 / d), exact for 0 <= n, n d < 2^32 (a
// tile's positions): the per-element loops divide by the plan's tile width
struct FastDiv {
  unsigned long long m;
  int d;
  __device__ explicit FastDiv(int d_)
      : m(((1ULL << 32) + d_ - 1) / static_cast<unsigned long long>(d_)), d(d_) {}
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>((static_cast<unsigned long long>(n) * m) >> 32);
  }
};

// The shape and the plan, passed by value
struct RingArgs {
  int batch, tlen, flen, tout, fout, chan, split, tt, tf, tiles_f, tiles, k, nconv;
  float eps;
};

// The per-width layout (models/res2net.py:_STRIDE2_RING): WSL output
// channels a CTA (its resident weights), CW input channels a ring stage.
// The consumers run the MMAs one of two ways: WG = 0, mma.sync, WN warps
// across the slice, each NT n tiles of 8, down the tile 16 MT rows a warp;
// WG = 1, wgmma (m64nWSLk16, A from registers, B from shared memory), a
// warpgroup 64 MT rows by all WSL channels. A stage's x patch is two boxes,
// the patch's even and its odd columns, rows of RS bytes (CW channels):
// TMA = 1, one producer lane's boxes of the tensor map, rows of 16-128
// bytes swizzled as the map asks (16-byte unit bits 4.. of a byte offset
// XORed with its bits 7..: SWZ the mask), so that the eight rows an
// ldmatrix reads fall in eight different bank groups; TMA = 0, two producer
// warps' cp.async into rows padded to an odd number of 16-byte units, free
// of conflicts. DS: the epilogue stores straight from the accumulators (no
// tile buffer, so larger tiles fit); else the tile goes through shared
// memory to 16-byte rows (the narrow slices, whose rows are one or two
// sectors).
template <int W, int NSL, int NKC, int MT, bool TMA, bool WG, bool DS>
struct RingCfg {
  static constexpr int WSL = W / NSL, CW = W / NKC;
  static constexpr int WN = WG ? 1 : (WSL >= 64 ? 2 : 1), NT = WSL / (8 * WN);
  static constexpr int ROWS = WG ? 64 * MT : 16 * MT;  // a warpgroup's or a warp's rows
  static constexpr int KT = tap_cols(W), WS = 9 * KT + 8, ZS = halo_stride(WSL);
  static constexpr int KSC = (CW + 15) / 16, C8 = CW / 8, CO8 = WSL / 8;
  static constexpr int RS = TMA ? 2 * CW : 2 * halo_stride(CW);
  static constexpr int PW = TMA ? 1 : 2;  // producer warps
  static constexpr int SWZ = !TMA || CW == 8 ? 0 : CW == 16 ? 0x10 : CW == 32 ? 0x30 : 0x70;
  // the weights: mma.sync rows of WS; wgmma [k / 8][n][k % 8]
  static constexpr bool WGMMA = WG;
  static constexpr long long OBYTES_ROW = DS ? 0 : 2LL * ZS;  // a tile row's buffer
  static constexpr long long WBYTES = WG ? 2LL * 9 * KT * WSL : 2LL * WSL * WS;
  static_assert(W % NSL == 0 && W % NKC == 0 && WSL % 8 == 0 && CW % 8 == 0, "whole vectors");
  static_assert(!TMA || CW == 8 || CW == 16 || CW == 32 || CW == 64,
                "a TMA box row of 16-128 bytes");
  static_assert(NKC == 1 || CW % 16 == 0, "a chunk of whole k steps");
  static_assert(!WG || (CW % 16 == 0 && WSL % 16 == 0 && WSL >= 32 && WSL <= 192),
                "a wgmma width");
  static_assert(WSL % (8 * WN) == 0, "whole n tiles a warp");
};

// Bytes of one of a ring stage's two boxes (the patch's even or odd
// columns): 2 tt + 1 input rows of tf + 1 columns, rows of rs bytes
__host__ __device__ constexpr long long ring_box(int rs, int tt, int tf) {
  return static_cast<long long>(2 * tt + 1) * (tf + 1) * rs;
}

// Shared memory of the mma design (models/res2net.py:_stride2_smem): 1 KB
// to align the ring, two ring stages of two boxes each (1 KB aligned, as
// the boxes' swizzle needs), the slice's weights, the output tile's rows
// (unless the epilogue stores straight from the accumulators), the slice's
// eval BN (mean, 1 / std), the ring's four mbarriers
template <class C>
__host__ __device__ constexpr long long ring_smem(int tt, int tf) {
  return 1024 + 4 * align1024(ring_box(C::RS, tt, tf)) + C::WBYTES +
         align16(C::OBYTES_ROW * tt * tf) + 8LL * C::WSL + 4 * 8;
}

// A byte offset in a box as the swizzle places it
template <int SWZ>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ ((off >> 3) & SWZ);
}

// Byte offset of tap (kt, kf) in a stage (boxes of `box` bytes, rows of tf
// + 1 columns of rs bytes), relative to an output position's row offset
// (2 u (tf + 1) + v) rs: the odd box for kf = 1, row kt, the next column
// for kf = 2
__device__ __forceinline__ uint32_t xtap(int tap, int tf, int rs, uint32_t box) {
  const int kt = tap / 3, kf = tap % 3;
  return (kf == 1 ? box : 0) + static_cast<uint32_t>((kt * (tf + 1) + (kf == 2)) * rs);
}

// The conv weights of output channels [n0, n0 + WSL) of group grp from the
// OIHW weight into wsm, K = tap * tap_cols(W) + input channel: mma.sync
// rows n of WS (each tap's pad columns zero), wgmma [k / 8][n][k % 8].
// Plain loads: the caller's barrier publishes them.
template <class C, int W>
__device__ void load_weights(bf16* wsm, const bf16* __restrict__ weight, int grp, int n0) {
  constexpr int KT = C::KT, V9 = 9 * W / 8, WSL = C::WSL;
  for (int i = threadIdx.x; i < WSL * V9; i += blockDim.x) {
    const int n = i / V9, v = i - n * V9;
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(
        weight + (static_cast<long long>(grp) * W + n0 + n) * W * 9 + 8 * v));
    const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = 8 * v + e, k = (idx % 9) * KT + idx / 9;  // idx = c * 9 + tap
      if constexpr (C::WGMMA)
        wsm[((k / 8) * WSL + n) * 8 + k % 8] = h[e];
      else
        wsm[n * C::WS + k] = h[e];
    }
  }
  if constexpr (!C::WGMMA && KT > W)
    for (int i = threadIdx.x; i < WSL * 9 * (KT - W); i += blockDim.x)
      wsm[(i / (9 * (KT - W))) * C::WS + (i / (KT - W) % 9) * KT + W + i % (KT - W)] =
          __float2bfloat16(0.f);
}

// One k step (16 K columns, step ks of a tap's CW) of a warp's 16 MT rows
// by 8 NT channels on mma.sync: A rows from the stage at the lane's byte
// offsets (its rows' and the tap's), B from the weights (row stride WS) at
// column col
template <class C, int MT>
__device__ __forceinline__ void mma_kstep(float (&acc)[MT][4 * C::NT], uint32_t sbase,
                                          const uint32_t (&rowoff)[MT], uint32_t toff, int ks,
                                          uint32_t wbase, int col, int lane) {
  constexpr int NT = C::NT, WS = C::WS;
  int cc = 16 * ks;
  // a tap's pad chunk (odd C8: w = 8) reads the last real chunk again, times
  // the zero weights
  if (C::C8 % 2 != 0 && cc + (lane / 16) * 8 >= C::CW) cc -= 8;
  uint32_t af[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    ldmatrix_x4(af[mt], sbase + swz<C::SWZ>(rowoff[mt] + toff + 2 * cc));
  const int bcol4 = ((lane % 8) + 8 * (lane / 16)) * WS + ((lane / 8) % 2) * 8;
  const int bcol2 = (lane % 8) * WS + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int np = 0; np + 1 < NT; np += 2) {
    uint32_t bq[4];
    ldmatrix_x4(bq, wbase + 2 * (np * 8 * WS + bcol4 + col));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16_16816(acc[mt] + 4 * np, af[mt], bq);
      mma_bf16_16816(acc[mt] + 4 * np + 4, af[mt], bq + 2);
    }
  }
  if constexpr (NT % 2 != 0) {
    uint32_t bf[2];
    ldmatrix_x2(bf, wbase + 2 * ((NT - 1) * 8 * WS + bcol2 + col));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt] + 4 * (NT - 1), af[mt], bf);
  }
}

// A stage of a warpgroup on wgmma: 9 taps x KSC k steps of chunk kc, in
// groups of TG taps (one commit each): a group's A fragments (ldmatrix, the
// warp's 16 rows of each m64 tile) load while the previous group's wgmmas
// run; all of the stage's wgmmas are done on return. (Carrying the groups
// across stages left the wgmmas in a divergent path, which the compiler
// serializes.)
template <class C, int MT>
__device__ __forceinline__ void wg_stage(float (&acc)[MT][C::WSL / 2], uint32_t sbase,
                                         const uint32_t (&rowoff)[MT], uint32_t box, int tf,
                                         int kc, uint32_t wbase) {
  constexpr int KSC = C::KSC, N = C::WSL;
  constexpr int TG = KSC * MT == 1 ? 9 : KSC * MT <= 3 ? 3 : 1, NG = 9 / TG;
  uint32_t a[2][TG][KSC][MT][4];
  auto load = [&](int grp, uint32_t (&dst)[TG][KSC][MT][4]) {
#pragma unroll
    for (int i = 0; i < TG; ++i) {
      const uint32_t toff = xtap(grp * TG + i, tf, C::RS, box);
#pragma unroll
      for (int ks = 0; ks < KSC; ++ks)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(dst[i][ks][mt], sbase + swz<C::SWZ>(rowoff[mt] + toff + 32 * ks));
    }
  };
  load(0, a[0]);
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    uint32_t (&cur)[TG][KSC][MT][4] = a[grp & 1];
#pragma unroll
    for (int i = 0; i < TG; ++i)
#pragma unroll
      for (int ks = 0; ks < KSC; ++ks)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(cur[i][ks][mt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(acc[mt]);
    vsv::wgmma_fence();
#pragma unroll
    for (int i = 0; i < TG; ++i)
#pragma unroll
      for (int ks = 0; ks < KSC; ++ks) {
        // K column tap KT + kc CW + 16 ks: its k / 8 block, N rows of 16 bytes
        const uint32_t kb = ((grp * TG + i) * C::KT + kc * C::CW + 16 * ks) / 8;
        const uint64_t desc = vsv::wgmma_desc(wbase + kb * 16 * N, 16 * N, 128);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) vsv::WgmmaRS<N>::mma(acc[mt], cur[i][ks][mt], desc, 1);
      }
    vsv::wgmma_commit();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(acc[mt]);
    if (grp + 1 < NG) {
      vsv::wgmma_wait<1>();  // the wgmmas that read the other register set are done
      load(grp + 1, a[(grp + 1) & 1]);
    }
  }
  vsv::wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(acc[mt]);
}

// A stage of a CTA's run: the conv of chunk kc of item (b, tile), or a pool
// stage (chunk kc of the last group at item (b, tile))
struct Stage {
  bool pool;
  int b, t0, f0, kc;
};

// A CTA (group grp, slice sl, run j of k): conv items [e0, e1) of the
// group's B tiles (sample, tile) items, each NKC stages (chunks of the
// input channels, in order), and pool stages [q0, q1) of the B tiles NKC
// (item, chunk) pool stages, dealt over all nconv CTAs in order. The pool
// stages are spread evenly among the conv stages: stage s is a pool stage
// where floor((s + 1) sp / n) > floor(s sp / n).
struct Run {
  int e0, sc, q0, sp, n;
  __device__ Run(const RingArgs& a, int cta, int j, int nkc) {
    const long long items = static_cast<long long>(a.batch) * a.tiles;
    e0 = static_cast<int>(items * j / a.k);
    sc = (static_cast<int>(items * (j + 1) / a.k) - e0) * nkc;
    const long long ps = items * nkc;
    q0 = static_cast<int>(ps * cta / a.nconv);
    sp = static_cast<int>(ps * (cta + 1) / a.nconv) - q0;
    n = sc + sp;
  }
  __device__ Stage at(const RingArgs& a, int s, int nkc) const {
    Stage st;
    const int pb = static_cast<int>(static_cast<long long>(s) * sp / n);
    st.pool = static_cast<int>(static_cast<long long>(s + 1) * sp / n) > pb;
    const int q = st.pool ? q0 + pb : (e0 * nkc + s - pb);
    const int item = q / nkc;
    st.kc = q - item * nkc;
    st.b = item / a.tiles;
    const int tile = item - st.b * a.tiles, tr = tile / a.tiles_f;
    st.t0 = tr * a.tt;
    st.f0 = (tile - tr * a.tiles_f) * a.tf;
    return st;
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// A ring wait that lasts this long means a role stopped feeding it: trap (a
// launch error) rather than hang the card
constexpr unsigned long long kWaitTimeoutNs = 10000000000ull;

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
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t0 == 0) t0 = t;
    else if (t - t0 > kWaitTimeoutNs) __trap();
  }
}

// The consumer warps' own barrier (the producer warp takes no part)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// A CTA: consumer warps (mma.sync: WN x WM warps of 16 MT rows by 8 NT
// channels; wgmma: warpgroups of 64 MT rows by the whole slice) and PW
// producer warps. The producers stage each stage into a ring buffer (TMA:
// the first lane issues two boxes; else the lanes' cp.async), completing on
// the buffer's "full" mbarrier, and refill a buffer when the consumer
// warps' arrivals on its "empty" mbarrier release it; no consumer issues a
// copy. The consumers run the MMAs (K tap by tap over the stage's chunk,
// no division in the loop), the epilogue and the pool stages.
template <int W, int NSL, int NKC, int MT, bool TMA, bool WG, bool DS>
__global__ void __launch_bounds__(kMaxThreads) stride2_ring_kernel(
    const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ x,
    const bf16* __restrict__ weight, const GroupStats stats, bf16* __restrict__ out,
    const RingArgs a) {
  using C = RingCfg<W, NSL, NKC, MT, TMA, WG, DS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cta = blockIdx.x, grp = cta / (NSL * a.k), sl = cta / a.k % NSL, j = cta % a.k;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int consumers = blockDim.x - 32 * C::PW;
  const bool producer = tid >= consumers;
  const int plane = tid - consumers;  // a producer thread's lane of the C::PW producer warps
  Prof pr(tid == 0 || tid == consumers);
  const int rows = a.tt * a.tf;
  const uint32_t box = static_cast<uint32_t>(align1024(ring_box(C::RS, a.tt, a.tf)));
  // the ring at the first 1 KB boundary: buffer i's boxes at 2 i box, its
  // odd columns' box box bytes after its even columns'
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  bf16* wsm = reinterpret_cast<bf16*>(ring_ptr + 4 * box);
  bf16* obuf = reinterpret_cast<bf16*>(ring_ptr + 4 * box + C::WBYTES);
  float* bn = reinterpret_cast<float*>(ring_ptr + 4 * box + C::WBYTES +
                                       align16(C::OBYTES_ROW * rows));
  uint64_t* full = reinterpret_cast<uint64_t*>(bn + 2 * C::WSL);
  uint64_t* empty = full + 2;
  const Run run(a, cta, j, NKC);
  if (run.n == 0) return;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], TMA ? 1 : 32 * C::PW);
      mbar_init(&empty[i], consumers / 32);
    }
  }
  vsv::tma::mbar_init_fence();
  __syncthreads();
  const FastDiv tfd(a.tf);
  // stage s into buffer s % 2: the patch's even columns (2 f0 - 1, 2 f0 +
  // 1, ..) and its odd ones (2 f0, 2 f0 + 2, ..), rows 2 t0 - 1 onwards,
  // zeros outside the utterance. TMA: the producer's first lane issues the
  // two boxes; else the producer warps' lanes copy the same columns by
  // cp.async, a lane a 16-byte column of the boxes walking its rows, each
  // lane's arrival on full triggered when its copies land
  auto produce = [&](int s) {
    const Stage st = run.at(a, s, NKC);
    const int c0 = (st.pool ? a.split - 1 : grp) * W + st.kc * C::CW;
    if constexpr (TMA) {
      unsigned char* dst = ring_ptr + (s & 1) * 2 * box;
      vsv::tma::mbar_expect(&full[s & 1], 2 * C::RS * (2 * a.tt + 1) * (a.tf + 1));
      vsv::tma::copy_4d(dst, &xmap, c0, 2 * st.f0 - 1, 2 * st.t0 - 1, st.b, &full[s & 1]);
      vsv::tma::copy_4d(dst + box, &xmap, c0, 2 * st.f0, 2 * st.t0 - 1, st.b, &full[s & 1]);
    } else {
      const uint32_t dst = ring + (s & 1) * 2 * box;
      const int cols = 2 * (a.tf + 1) * C::C8, pt_n = 2 * a.tt + 1;
      const int nrg = imax(1, 32 * C::PW / cols);
      const long long rowe = static_cast<long long>(a.flen) * a.chan;
      const bf16* xb = x + static_cast<long long>(st.b) * a.tlen * rowe + c0;
      for (int cl = plane; cl < cols * nrg; cl += 32 * C::PW) {
        const int rg = cl / cols, col = cl - rg * cols, i = col / C::C8;
        const int c = (col - i * C::C8) * 8, p = i > a.tf, slot = i - p * (a.tf + 1);
        const int f = 2 * st.f0 - 1 + p + 2 * slot;
        const bool fv = f >= 0 && f < a.flen;
        for (int pt = rg; pt < pt_n; pt += nrg) {
          const int t = 2 * st.t0 - 1 + pt;
          const bool v = fv && t >= 0 && t < a.tlen;
          cp_async16(dst + p * box + swz<C::SWZ>((pt * (a.tf + 1) + slot) * C::RS + 2 * c),
                     xb + (v ? t * rowe + f * a.chan + c : 0), v);
        }
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                       smem_u32(&full[s & 1]))
                   : "memory");
    }
  };
  if (TMA ? tid == consumers : producer)
    for (int s = 0; s < min(2, run.n); ++s) produce(s);
  load_weights<C, W>(wsm, weight, grp, sl * C::WSL);
  // the slice's eval BN, once: the epilogue reads it from shared memory
  for (int c = tid; c < C::WSL; c += blockDim.x) {
    bn[c] = stats.mean[grp][sl * C::WSL + c];
    bn[C::WSL + c] = 1.f / sqrtf(stats.var[grp][sl * C::WSL + c] + a.eps);
  }
  __syncthreads();  // the weights and the BN
  if (producer) {
    if (TMA ? plane == 0 : true) {
      pr.mark();
      for (int s = 2; s < run.n; ++s) {
        // the consumers are done with stage s - 2
        mbar_wait_bounded(&empty[s & 1], ((s >> 1) - 1) & 1);
        pr.lap(kPhProduceWait);
        if constexpr (TMA) vsv::tma::fence_async();
        produce(s);
        pr.lap(kPhIssue);
      }
      if constexpr (!TMA) asm volatile("cp.async.wait_all;\n" ::: "memory");
      pr.flush(false);
    }
    return;
  }
  pr.lap(kPhWeight);
  // this lane's A rows (lane % 16 of each of its m16 tiles) at tap (0, 0),
  // byte offsets in a box; rows past the tile read a valid row and are
  // never stored. mma.sync: warp (wm, wn), m16 tiles of rows wm 16 MT ..;
  // wgmma: warp q of warpgroup wg, rows wg 64 MT + 64 mt + 16 q ..
  const int wn = WG ? 0 : warp % C::WN;
  const int rbase = WG ? (warp / 4) * C::ROWS + 16 * (warp % 4) : (warp / C::WN) * C::ROWS;
  constexpr int RSTEP = WG ? 64 : 16;
  uint32_t rowoff[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = min(rbase + RSTEP * mt + lane % 16, rows - 1), u = tfd.div(r);
    rowoff[mt] = static_cast<uint32_t>((2 * u * (a.tf + 1) + r - u * a.tf) * C::RS +
                                       (lane / 16) * 16);
  }
  const uint32_t wbase = smem_u32(wsm) + (WG ? 0 : 2 * wn * C::NT * 8 * C::WS);
  // accumulators: mma.sync [mt][nt][4]; wgmma [mt][WSL / 2], element 4 nt +
  // 2 h + e the mma.sync fragment's (nt, 2 h + e)
  constexpr int NACC = C::NT * 4;
  float acc[MT][NACC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[mt][e] = 0.f;
  for (int s = 0; s < run.n; ++s) {
    mbar_wait_bounded(&full[s & 1], (s >> 1) & 1);
    pr.lap(kPhPatch);
    const Stage st = run.at(a, s, NKC);
    const uint32_t sbase = ring + (s & 1) * 2 * box;
    if (st.pool) {  // the average pool of chunk kc of the last group
      bf16* ob = out + (a.split - 1) * W + st.kc * C::CW;
      const unsigned char* sp = ring_ptr + (s & 1) * 2 * box;
      for (int i = tid; i < rows * C::C8; i += consumers) {
        const int r = i / C::C8, c = (i - r * C::C8) * 8, u = tfd.div(r), v = r - u * a.tf;
        if (st.t0 + u >= a.tout || st.f0 + v >= a.fout) continue;
        const uint32_t base = static_cast<uint32_t>((2 * u * (a.tf + 1) + v) * C::RS + 2 * c);
        float v8[8];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const bf16* q =
              reinterpret_cast<const bf16*>(sp + swz<C::SWZ>(base + xtap(tap, a.tf, C::RS, box)));
          float t8[8];
          vsv::unpack16(*reinterpret_cast<const uint4*>(q), t8, q);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v8[e] = tap == 0 ? t8[e] : vsv::round_to<bf16>(v8[e] + t8[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) v8[e] = v8[e] * (1.0f / 9.0f);
        vsv::store16(ob + ((static_cast<long long>(st.b) * a.tout + st.t0 + u) * a.fout + st.f0 +
                           v) * a.chan + c,
                     v8);
      }
      __syncwarp();
      if (lane == 0) vsv::tma::mbar_arrive(&empty[s & 1]);
      pr.count(kPhPoolTiles);
      pr.lap(kPhPool);
      continue;
    }
    if constexpr (WG) {
      wg_stage<C, MT>(acc, sbase, rowoff, box, a.tf, st.kc, wbase);
    } else {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t toff = xtap(tap, a.tf, C::RS, box);
#pragma unroll
        for (int ks = 0; ks < C::KSC; ++ks)
          mma_kstep<C, MT>(acc, sbase, rowoff, toff, ks, wbase,
                           tap * C::KT + st.kc * C::CW + 16 * ks, lane);
      }
    }
    __syncwarp();
    if (lane == 0) vsv::tma::mbar_arrive(&empty[s & 1]);
    pr.lap(kPhMma);
    if (st.kc != NKC - 1) continue;
    // epilogue: the conv output rounded to bf16, eval BN, relu; DS: stored
    // from the accumulators, a thread's rows (mt, h) at pairs of channels;
    // else into the tile's rows in shared memory (stride ZS), then 16-byte
    // rows to the output's slice
    long long orow[MT][2];
    if constexpr (DS) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + RSTEP * mt + g + 8 * h, u = tfd.div(r);
          const int ot = st.t0 + u, of = st.f0 + r - u * a.tf;
          orow[mt][h] = r < rows && ot < a.tout && of < a.fout
              ? ((static_cast<long long>(st.b) * a.tout + ot) * a.fout + of) * a.chan + grp * W +
                    sl * C::WSL
              : -1;
        }
    } else {
      consumer_sync(consumers);  // every consumer is done with the last tile's rows
    }
    pr.lap(kPhEpiWait);
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int co = (wn * C::NT + nt) * 8 + 2 * tg;
      const float m0 = bn[co], m1 = bn[co + 1], i0 = bn[C::WSL + co], i1 = bn[C::WSL + co + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + RSTEP * mt + g + 8 * h;
          const float v0 = vsv::round_to<bf16>(acc[mt][4 * nt + 2 * h]);
          const float v1 = vsv::round_to<bf16>(acc[mt][4 * nt + 2 * h + 1]);
          acc[mt][4 * nt + 2 * h] = acc[mt][4 * nt + 2 * h + 1] = 0.f;
          const __nv_bfloat162 y =
              __floats2bfloat162_rn(fmaxf((v0 - m0) * i0, 0.f), fmaxf((v1 - m1) * i1, 0.f));
          if constexpr (DS) {
            if (orow[mt][h] >= 0) *reinterpret_cast<__nv_bfloat162*>(out + orow[mt][h] + co) = y;
          } else if (r < rows) {
            *reinterpret_cast<__nv_bfloat162*>(obuf + r * C::ZS + co) = y;
          }
        }
    }
    if constexpr (!DS) {
      consumer_sync(consumers);
      pr.lap(kPhEpiRows);
      bf16* ob = out + grp * W + sl * C::WSL;
      for (int i = tid; i < rows * C::CO8; i += consumers) {
        const int r = i / C::CO8, c = (i - r * C::CO8) * 8, u = tfd.div(r);
        const int ot = st.t0 + u, of = st.f0 + r - u * a.tf;
        if (ot < a.tout && of < a.fout)
          *reinterpret_cast<uint4*>(
              ob + ((static_cast<long long>(st.b) * a.tout + ot) * a.fout + of) * a.chan + c) =
              *reinterpret_cast<const uint4*>(obuf + r * C::ZS + c);
      }
    }
    pr.count(kPhTiles);
    pr.lap(kPhEpilogue);
  }
  pr.flush(true);
}

template <int W, int NSL, int NKC, int MT, bool TMA, bool WG, bool DS>
int launch_ring(const void* x, const void* weight, const GroupStats& stats, void* out, int batch,
                int tlen, int flen, int split, int tt, int tf, int k, int per_sm, float eps,
                long long plan_smem, cudaStream_t stream) {
  using C = RingCfg<W, NSL, NKC, MT, TMA, WG, DS>;
  RingArgs a;
  a.batch = batch; a.tlen = tlen; a.flen = flen; a.split = split; a.chan = split * W;
  a.tout = (tlen - 1) / 2 + 1; a.fout = (flen - 1) / 2 + 1;
  a.tt = tt; a.tf = tf; a.k = k; a.eps = eps;
  const int groups = WG ? cdiv(tt * tf, C::ROWS) : C::WN * cdiv(tt * tf, C::ROWS);
  const int threads = 32 * ((WG ? 4 : 1) * groups + C::PW);
  if (tt < 1 || tf < 1 || tf > 16 || tt > a.tout || 2 * tt + 1 > 256 || threads > kMaxThreads ||
      k < 1 || per_sm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = ring_smem<C>(tt, tf);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem != plan_smem) return vsv::kPlanMismatch;
  a.tiles_f = cdiv(a.fout, tf);
  const long long tiles = static_cast<long long>(cdiv(a.tout, tt)) * a.tiles_f;
  const long long items = batch * tiles, nconv = static_cast<long long>(split - 1) * NSL * k;
  if (items * NKC > 0x7fffffffLL || k > items || nconv > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  a.nconv = static_cast<int>(nconv);
  if ((reinterpret_cast<uintptr_t>(x) & 15) != 0) return static_cast<int>(cudaErrorInvalidValue);
  // TMA: x (B, T, F, C) as a 4-D tensor map, innermost first; a box: CW
  // channels, tf + 1 columns two apart, 2 tt + 1 rows, zeros past the edges
  CUtensorMap xmap{};
  if constexpr (TMA) {
    const vsv::tma::EncodeTiled encode = vsv::tma::encode_tiled();
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.chan), static_cast<cuuint64_t>(flen),
                                static_cast<cuuint64_t>(tlen), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {2ULL * a.chan, 2ULL * a.chan * flen,
                                   2ULL * a.chan * flen * tlen};
    const cuuint32_t box[4] = {C::CW, static_cast<cuuint32_t>(2 * tf + 1),
                               static_cast<cuuint32_t>(2 * tt + 1), 1};
    const cuuint32_t steps[4] = {1, 2, 1, 1};
    const CUtensorMapSwizzle swizzle = C::SWZ == 0      ? CU_TENSOR_MAP_SWIZZLE_NONE
                                       : C::SWZ == 0x10 ? CU_TENSOR_MAP_SWIZZLE_32B
                                       : C::SWZ == 0x30 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                        : CU_TENSOR_MAP_SWIZZLE_128B;
    if (encode == nullptr ||
        encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
               box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = stride2_ring_kernel<W, NSL, NKC, MT, TMA, WG, DS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the plan's CTAs a SM must fit at once: the run lengths assume one wave
  int fit = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit < per_sm) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(nconv), threads, smem, stream>>>(
      xmap, static_cast<const bf16*>(x), static_cast<const bf16*>(weight), stats,
      static_cast<bf16*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

// The whole-row form (w = 48, s = 4; models/res2net.py:_STRIDE2_RING, nsl =
// 0): a CTA takes every group of its run's tiles, so x is read once, in
// 128-byte TMA box rows. A stage is one tile's patch of 64 of x's s w
// channels (chunk c of NCH); its 16-channel k steps belong to conv groups
// (wgmma into that group's accumulators, the group's weights resident) or
// to the last group (the average pool of those channels); the conv
// groups' epilogue follows the tile's last chunk. One warpgroup or two of
// consumers, one producer warp.
template <int W, int SPLIT>
struct RowsCfg {
  static constexpr int CH = 64, NCH = SPLIT * W / CH, NG = SPLIT - 1, KT = tap_cols(W);
  static constexpr int RS = 2 * CH, SWZ = 0x70, NACC = W / 2;
  static constexpr long long WGROUP = 2LL * 9 * KT * W;  // a group's weights, [k / 8][n][k % 8]
  static_assert(SPLIT * W % CH == 0 && W % 16 == 0 && W >= 32 && W <= 192, "whole chunks");
};

// Chunk CI of a tile on wgmma: its conv k steps, tap by tap (a tap's A
// fragments of the chunk's KS k steps loading while the previous tap's
// wgmmas run), each into its group's accumulators
template <int W, int SPLIT, int CI>
__device__ __forceinline__ void rows_chunk(float (&acc)[SPLIT - 1][W / 2], uint32_t sbase,
                                           uint32_t rowoff, uint32_t box, int tf,
                                           uint32_t wbase) {
  using C = RowsCfg<W, SPLIT>;
  // the chunk's conv k steps: channels 64 CI + 16 j below (SPLIT - 1) W
  constexpr int KS = imax(0, (imin(C::CH * (CI + 1), C::NG * W) - C::CH * CI) / 16);
  if constexpr (KS > 0) {
    uint32_t a[2][KS][4];
    auto load = [&](int tap, uint32_t (&dst)[KS][4]) {
      const uint32_t toff = xtap(tap, tf, C::RS, box);
#pragma unroll
      for (int j = 0; j < KS; ++j)
        ldmatrix_x4(dst[j], sbase + swz<C::SWZ>(rowoff + toff + 32 * j));
    };
    load(0, a[0]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t (&cur)[KS][4] = a[tap & 1];
#pragma unroll
      for (int j = 0; j < KS; ++j) vsv::wgmma_fence_regs(cur[j]);
#pragma unroll
      for (int gi = 0; gi < C::NG; ++gi) vsv::wgmma_fence_regs(acc[gi]);
      vsv::wgmma_fence();
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int ch = C::CH * CI + 16 * j, gi = ch / W;
        // K column tap KT + (ch % W) of group gi: its k / 8 block, W rows of
        // 16 bytes
        const uint32_t kb = (tap * C::KT + ch % W) / 8;
        const uint64_t desc = vsv::wgmma_desc(
            wbase + static_cast<uint32_t>(gi * C::WGROUP) + kb * 16 * W, 16 * W, 128);
#pragma unroll
        for (int g2 = 0; g2 < C::NG; ++g2)
          if (g2 == gi) vsv::WgmmaRS<W>::mma(acc[g2], cur[j], desc, 1);
      }
      vsv::wgmma_commit();
#pragma unroll
      for (int gi = 0; gi < C::NG; ++gi) vsv::wgmma_fence_regs(acc[gi]);
      if (tap + 1 < 9) {
        vsv::wgmma_wait<1>();
        load(tap + 1, a[(tap + 1) & 1]);
      }
    }
    vsv::wgmma_wait<0>();
#pragma unroll
    for (int gi = 0; gi < C::NG; ++gi) vsv::wgmma_fence_regs(acc[gi]);
  }
}

template <int W, int SPLIT>
__global__ void __launch_bounds__(kMaxThreads) stride2_rows_kernel(
    const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ weight,
    const GroupStats stats, bf16* __restrict__ out, const RingArgs a) {
  using C = RowsCfg<W, SPLIT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int j = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int consumers = blockDim.x - 32;
  const bool producer = tid >= consumers;
  Prof pr(tid == 0 || tid == consumers);
  const int rows = a.tt * a.tf;
  const uint32_t box = static_cast<uint32_t>(align1024(ring_box(C::RS, a.tt, a.tf)));
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  bf16* wsm = reinterpret_cast<bf16*>(ring_ptr + 4 * box);
  float* bn = reinterpret_cast<float*>(ring_ptr + 4 * box + C::NG * C::WGROUP);
  uint64_t* full = reinterpret_cast<uint64_t*>(bn + 2 * C::NG * W);
  uint64_t* empty = full + 2;
  // the run: items [e0, e1) of the B tiles, NCH stages each
  const long long items = static_cast<long long>(a.batch) * a.tiles;
  const int e0 = static_cast<int>(items * j / a.k);
  const int n = (static_cast<int>(items * (j + 1) / a.k) - e0) * C::NCH;
  if (n == 0) return;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], consumers / 32);
    }
  }
  vsv::tma::mbar_init_fence();
  __syncthreads();
  const FastDiv tfd(a.tf);
  // stage s: chunk s % NCH of item e0 + s / NCH, the patch's even and odd
  // columns as two boxes
  auto item_of = [&](int s, int* b, int* t0, int* f0) {
    const int item = e0 + s / C::NCH;
    *b = item / a.tiles;
    const int tile = item - *b * a.tiles, tr = tile / a.tiles_f;
    *t0 = tr * a.tt;
    *f0 = (tile - tr * a.tiles_f) * a.tf;
  };
  auto produce = [&](int s) {
    int b, t0, f0;
    item_of(s, &b, &t0, &f0);
    const int c0 = (s % C::NCH) * C::CH;
    unsigned char* dst = ring_ptr + (s & 1) * 2 * box;
    vsv::tma::mbar_expect(&full[s & 1], 2 * C::RS * (2 * a.tt + 1) * (a.tf + 1));
    vsv::tma::copy_4d(dst, &xmap, c0, 2 * f0 - 1, 2 * t0 - 1, b, &full[s & 1]);
    vsv::tma::copy_4d(dst + box, &xmap, c0, 2 * f0, 2 * t0 - 1, b, &full[s & 1]);
  };
  if (tid == consumers)
    for (int s = 0; s < min(2, n); ++s) produce(s);
  // every conv group's weights and eval BN, once
  for (int gi = 0; gi < C::NG; ++gi) {
    constexpr int V9 = 9 * W / 8;
    bf16* wg = wsm + gi * (C::WGROUP / 2);
    for (int i = tid; i < W * V9; i += blockDim.x) {
      const int nn = i / V9, v = i - nn * V9;
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(
          weight + (static_cast<long long>(gi) * W + nn) * W * 9 + 8 * v));
      const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = 8 * v + e, k = (idx % 9) * C::KT + idx / 9;  // idx = c * 9 + tap
        wg[((k / 8) * W + nn) * 8 + k % 8] = h[e];
      }
    }
    for (int c = tid; c < W; c += blockDim.x) {
      bn[2 * gi * W + c] = stats.mean[gi][c];
      bn[(2 * gi + 1) * W + c] = 1.f / sqrtf(stats.var[gi][c] + a.eps);
    }
  }
  __syncthreads();
  if (producer) {
    if (lane == 0) {
      pr.mark();
      for (int s = 2; s < n; ++s) {
        mbar_wait_bounded(&empty[s & 1], ((s >> 1) - 1) & 1);
        pr.lap(kPhProduceWait);
        vsv::tma::fence_async();
        produce(s);
        pr.lap(kPhIssue);
      }
      pr.flush(false);
    }
    return;
  }
  pr.lap(kPhWeight);
  // warp q of warpgroup wq: rows 64 wq + 16 q ..
  const int rbase = (warp / 4) * 64 + 16 * (warp % 4);
  uint32_t rowoff;
  {
    const int r = min(rbase + lane % 16, rows - 1), u = tfd.div(r);
    rowoff = static_cast<uint32_t>((2 * u * (a.tf + 1) + r - u * a.tf) * C::RS + (lane / 16) * 16);
  }
  const uint32_t wbase = smem_u32(wsm);
  float acc[C::NG][C::NACC];
#pragma unroll
  for (int gi = 0; gi < C::NG; ++gi)
#pragma unroll
    for (int e = 0; e < C::NACC; ++e) acc[gi][e] = 0.f;
  for (int s = 0; s < n; ++s) {
    mbar_wait_bounded(&full[s & 1], (s >> 1) & 1);
    pr.lap(kPhPatch);
    const int c = s % C::NCH;
    int b, t0, f0;
    item_of(s, &b, &t0, &f0);
    const uint32_t sbase = ring + (s & 1) * 2 * box;
    static_assert(C::NCH <= 3, "three chunks a row, at most");
    if (c == 0)
      rows_chunk<W, SPLIT, 0>(acc, sbase, rowoff, box, a.tf, wbase);
    else if (c == 1)
      rows_chunk<W, SPLIT, 1>(acc, sbase, rowoff, box, a.tf, wbase);
    else
      rows_chunk<W, SPLIT, 2>(acc, sbase, rowoff, box, a.tf, wbase);
    pr.lap(kPhMma);
    // the chunk's channels of the last group: their average pool
    const int plo = imax(0, C::NG * W - C::CH * c);
    if (plo < C::CH) {
      const unsigned char* sp = ring_ptr + (s & 1) * 2 * box;
      const int vecs = (C::CH - plo) / 8;
      for (int i = tid; i < rows * vecs; i += consumers) {
        const int r = i / vecs, cv = plo + (i - r * vecs) * 8, u = tfd.div(r), v = r - u * a.tf;
        if (t0 + u >= a.tout || f0 + v >= a.fout) continue;
        const uint32_t base = static_cast<uint32_t>((2 * u * (a.tf + 1) + v) * C::RS + 2 * cv);
        float v8[8];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const bf16* q =
              reinterpret_cast<const bf16*>(sp + swz<C::SWZ>(base + xtap(tap, a.tf, C::RS, box)));
          float t8[8];
          vsv::unpack16(*reinterpret_cast<const uint4*>(q), t8, q);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v8[e] = tap == 0 ? t8[e] : vsv::round_to<bf16>(v8[e] + t8[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) v8[e] = v8[e] * (1.0f / 9.0f);
        vsv::store16(out + ((static_cast<long long>(b) * a.tout + t0 + u) * a.fout + f0 + v) *
                               a.chan + C::CH * c + cv,
                     v8);
      }
      pr.count(kPhPoolTiles);
      pr.lap(kPhPool);
    }
    __syncwarp();
    if (lane == 0) vsv::tma::mbar_arrive(&empty[s & 1]);
    if (c != C::NCH - 1) continue;
    // epilogue: each conv group's output rounded to bf16, eval BN, relu,
    // stored from the accumulators
    long long orow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rbase + g + 8 * h, u = tfd.div(r);
      const int ot = t0 + u, of = f0 + r - u * a.tf;
      orow[h] = r < rows && ot < a.tout && of < a.fout
          ? ((static_cast<long long>(b) * a.tout + ot) * a.fout + of) * a.chan
          : -1;
    }
#pragma unroll
    for (int gi = 0; gi < C::NG; ++gi)
#pragma unroll
      for (int nt = 0; nt < W / 8; ++nt) {
        const int co = nt * 8 + 2 * tg;
        const float* bg = bn + 2 * gi * W;
        const float m0 = bg[co], m1 = bg[co + 1], i0 = bg[W + co], i1 = bg[W + co + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = vsv::round_to<bf16>(acc[gi][4 * nt + 2 * h]);
          const float v1 = vsv::round_to<bf16>(acc[gi][4 * nt + 2 * h + 1]);
          acc[gi][4 * nt + 2 * h] = acc[gi][4 * nt + 2 * h + 1] = 0.f;
          if (orow[h] >= 0)
            *reinterpret_cast<__nv_bfloat162*>(out + orow[h] + gi * W + co) =
                __floats2bfloat162_rn(fmaxf((v0 - m0) * i0, 0.f), fmaxf((v1 - m1) * i1, 0.f));
        }
      }
    pr.count(kPhTiles);
    pr.lap(kPhEpilogue);
  }
  pr.flush(true);
}

template <int W, int SPLIT>
int launch_rows(const void* x, const void* weight, const GroupStats& stats, void* out, int batch,
                int tlen, int flen, int tt, int tf, int k, int per_sm, float eps,
                long long plan_smem, cudaStream_t stream) {
  using C = RowsCfg<W, SPLIT>;
  RingArgs a;
  a.batch = batch; a.tlen = tlen; a.flen = flen; a.split = SPLIT; a.chan = SPLIT * W;
  a.tout = (tlen - 1) / 2 + 1; a.fout = (flen - 1) / 2 + 1;
  a.tt = tt; a.tf = tf; a.k = k; a.eps = eps;
  const int threads = 32 * (4 * cdiv(tt * tf, 64) + 1);
  if (tt < 1 || tf < 1 || tf > 16 || tt > a.tout || 2 * tt + 1 > 256 || threads > kMaxThreads ||
      k < 1 || per_sm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 1024 + 4 * align1024(ring_box(C::RS, tt, tf)) + C::NG * C::WGROUP +
                         8LL * C::NG * W + 4 * 8;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem != plan_smem) return vsv::kPlanMismatch;
  a.tiles_f = cdiv(a.fout, tf);
  const long long tiles = static_cast<long long>(cdiv(a.tout, tt)) * a.tiles_f;
  const long long items = batch * tiles;
  if (items * C::NCH > 0x7fffffffLL || k > items || (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  a.nconv = k;
  const vsv::tma::EncodeTiled encode = vsv::tma::encode_tiled();
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.chan), static_cast<cuuint64_t>(flen),
                              static_cast<cuuint64_t>(tlen), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {2ULL * a.chan, 2ULL * a.chan * flen, 2ULL * a.chan * flen * tlen};
  const cuuint32_t box[4] = {C::CH, static_cast<cuuint32_t>(2 * tf + 1),
                             static_cast<cuuint32_t>(2 * tt + 1), 1};
  const cuuint32_t steps[4] = {1, 2, 1, 1};
  CUtensorMap xmap{};
  if (encode == nullptr ||
      encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = stride2_rows_kernel<W, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int fit = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit < per_sm) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(k), threads, smem, stream>>>(
      xmap, static_cast<const bf16*>(weight), stats, static_cast<bf16*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// "vec" / "single": fp32 FMA on CUDA cores
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;  // 32 rows x 8 columns of threads
constexpr int BM = 128;           // output positions a block
constexpr int KC = 8;             // input channels a staged chunk
constexpr int TM = 4;             // positions a thread
constexpr int APAD = 4;           // keeps the staged A stores conflict-free

template <typename T, int V, int TN>
__global__ void __launch_bounds__(FMA_THREADS) stride2_fma_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const GroupStats stats,
    T* __restrict__ out, int total, int tlen, int flen, int tout,
    int fout, int split, int width, int nblk, float eps) {
  constexpr int BN = 8 * TN, KV = KC / V, ITEMS = BM * KV;
  constexpr int LOADS = (ITEMS + FMA_THREADS - 1) / FMA_THREADS;
  __shared__ __align__(16) float as[KC][BM + APAD];
  __shared__ __align__(16) float bs[KC][BN];

  const int tid = threadIdx.x, channels = split * width, m0 = blockIdx.x * BM;
  if (static_cast<int>(blockIdx.y) == (split - 1) * nblk) {  // the average pool
    const int vecs = width / V;
    for (int i = tid; i < BM * vecs; i += FMA_THREADS) {
      const int m = m0 + i / vecs;
      if (m >= total) continue;
      const int of = m % fout, bt = m / fout;
      pool_at<T, V>(x, out, bt / tout, bt % tout, of, (i % vecs) * V, tlen, flen, tout, fout,
                    channels, (split - 1) * width);
    }
    return;
  }
  const int group = blockIdx.y / nblk, n0 = (blockIdx.y % nblk) * BN;
  const int ty = tid / 8, tx = tid % 8, ldw = width * (split - 1);

  // the (position, channel vector) items this thread stages
  int lb[LOADS], lt[LOADS], lf[LOADS];
#pragma unroll
  for (int r = 0; r < LOADS; ++r) {
    const int it = tid + FMA_THREADS * r, m = m0 + it / KV;
    lb[r] = -1; lt[r] = 0; lf[r] = 0;
    if (it < ITEMS && m < total) {
      lf[r] = m % fout;
      const int bt = m / fout;
      lt[r] = bt % tout;
      lb[r] = bt / tout;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int di = tap / 3, dj = tap % 3;
    for (int c0 = 0; c0 < width; c0 += KC) {
#pragma unroll
      for (int r = 0; r < LOADS; ++r) {
        const int it = tid + FMA_THREADS * r;
        if (it >= ITEMS) continue;
        const int ci = c0 + (it % KV) * V;
        const int t = 2 * lt[r] - 1 + di, f = 2 * lf[r] - 1 + dj;
        float v[V];
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = 0.f;
        if (lb[r] >= 0 && ci < width && t >= 0 && t < tlen && f >= 0 && f < flen)
          load_vec<T, V>(x + ((static_cast<long long>(lb[r]) * tlen + t) * flen + f) * channels +
                             group * width + ci,
                         v);
#pragma unroll
        for (int e = 0; e < V; ++e) as[(it % KV) * V + e][it / KV] = v[e];
      }
      for (int i = tid; i < KC * BN; i += FMA_THREADS) {
        const int kk = i / BN, nn = i % BN;
        const int c = c0 + kk, co = n0 + nn;
        bs[kk][nn] = (c < width && co < width)
            ? vsv::to_f(w[(static_cast<long long>(tap) * width + c) * ldw + group * width + co])
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
    const float mu = stats.mean[group][co];
    const float inv = 1.f / sqrtf(stats.var[group][co] + eps);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= total) continue;
      const float v = vsv::round_to<T>(acc[i][j]);
      out[static_cast<long long>(m) * channels + group * width + co] =
          vsv::from_f<T>(fmaxf((v - mu) * inv, 0.f));
    }
  }
}

template <typename T, int V>
int launch_fma(int tn, const void* x, const void* w, const GroupStats& stats, void* out,
               int batch, int tlen, int flen, int split, int width, float eps,
               cudaStream_t stream) {
  const int tout = (tlen - 1) / 2 + 1, fout = (flen - 1) / 2 + 1;
  const long long total = static_cast<long long>(batch) * tout * fout;
  if (width % V != 0 || total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (width + 8 * tn - 1) / (8 * tn);
  const long long gy = static_cast<long long>(split - 1) * nblk + 1;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((total + BM - 1) / BM), static_cast<unsigned>(gy));
#define VSV_S2_FMA(N)                                                                          \
  case N:                                                                                      \
    stride2_fma_kernel<T, V, N><<<grid, FMA_THREADS, 0, stream>>>(                             \
        static_cast<const T*>(x), static_cast<const T*>(w), stats, static_cast<T*>(out),       \
        static_cast<int>(total), tlen, flen, tout, fout, split, width, nblk, eps);             \
    break;
  switch (tn) {
    VSV_S2_FMA(1)
    VSV_S2_FMA(2)
    VSV_S2_FMA(3)
    VSV_S2_FMA(4)
    VSV_S2_FMA(6)
    VSV_S2_FMA(8)
    VSV_S2_FMA(12)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VSV_S2_FMA
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One stride-2 split stage in eval mode, one launch. dtype: 0 = float32, 1 =
// bfloat16. plan: 12 host ints (models/res2net.py:stride2_plan): design (0
// "mma", 1 "vec", 2 "single"), nsl, nkc, mt, tma, wg, ds, tt, tf, k,
// per_sm, tn. x: (B, T, F, split * width) channels-last; wk: "mma" the
// OIHW weight ((split-1) width, width, 3, 3) bfloat16; "vec" / "single"
// the JAX layout (3, 3, width, width * (split-1)). stats: a host array of 2
// (split-1) device pointers, each group's (width,) float32 running mean,
// then each group's running variance. out: (B, T', F', split * width)
// channels-last. "mma" and "vec" need 16-byte aligned pointers; "mma" takes
// bfloat16 at the kernels below (width, nsl, nkc, mt, tma, wg, ds), tiles
// of tt x tf (tf <= 16) output positions, (split-1) nsl k persistent CTAs
// of which per_sm must fit an SM at once, its shared memory ring_smem(...)
// passed as plan_smem (refused where it differs: vsv::kPlanMismatch);
// "vec" and "single" pass plan_smem 0.
extern "C" int split_stride2(int dtype, const int* plan, const void* x, const void* wk,
                             const void* const* stats, void* out, int batch, int tlen, int flen,
                             int split, int width, float eps, long long plan_smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int design = plan[0], nsl = plan[1], nkc = plan[2], mt = plan[3];
  const bool tma = plan[4] != 0, wg = plan[5] != 0, ds = plan[6] != 0;
  const int tt = plan[7], tf = plan[8], k = plan[9], per_sm = plan[10], tn = plan[11];
  if (batch < 1 || tlen < 1 || flen < 1 || split < 2 || split - 1 > kMaxGroups || width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GroupStats st{};
  for (int i = 0; i < split - 1; ++i) {
    st.mean[i] = static_cast<const float*>(stats[i]);
    st.var[i] = static_cast<const float*>(stats[split - 1 + i]);
  }
  if (design == 0) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (nsl == 0) {  // the whole-row form
      if (width == 48 && split == 4 && nkc == 3 && mt == 1 && tma && wg && ds)
        return launch_rows<48, 4>(x, wk, st, out, batch, tlen, flen, tt, tf, k, per_sm, eps,
                                  plan_smem, s);
      return static_cast<int>(cudaErrorInvalidValue);
    }
#define VSV_S2_RING(W, S, K, M, T, G, D)                                                       \
  if (width == W && nsl == S && nkc == K && mt == M && tma == T && wg == G && ds == D)         \
    return launch_ring<W, S, K, M, T, G, D>(x, wk, st, out, batch, tlen, flen, split, tt, tf,  \
                                            k, per_sm, eps, plan_smem, s);
    VSV_S2_RING(8, 1, 1, 2, true, false, false)
    VSV_S2_RING(16, 1, 1, 2, false, false, false)
    VSV_S2_RING(32, 1, 1, 1, true, true, false)
    VSV_S2_RING(64, 1, 1, 1, true, true, false)
    VSV_S2_RING(96, 1, 3, 1, true, true, true)
    VSV_S2_RING(192, 4, 6, 1, true, true, true)
#undef VSV_S2_RING
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (design != 1 && design != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (plan_smem != 0) return vsv::kPlanMismatch;
  if (dtype == 0)
    return design == 1
        ? launch_fma<float, 4>(tn, x, wk, st, out, batch, tlen, flen, split, width, eps, s)
        : launch_fma<float, 1>(tn, x, wk, st, out, batch, tlen, flen, split, width, eps, s);
  if (dtype == 1)
    return design == 1
        ? launch_fma<__nv_bfloat16, 8>(tn, x, wk, st, out, batch, tlen, flen, split, width, eps,
                                       s)
        : launch_fma<__nv_bfloat16, 1>(tn, x, wk, st, out, batch, tlen, flen, split, width, eps,
                                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef VSV_K10_PROF
// The phase profile's counters (kProfSlots unsigned 64-bit) into host,
// zeroed after when reset is non-zero: present only in the profile build.
extern "C" int split_stride2_prof(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_k10_prof, sizeof(g_k10_prof));
  if (e == cudaSuccess && reset) {
    static unsigned long long zeros[kProfSlots];
    e = cudaMemcpyToSymbol(g_k10_prof, zeros, sizeof(zeros));
  }
  return static_cast<int>(e);
}
#endif
