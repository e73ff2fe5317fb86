// K11 / K11b: the Res2Net stride-2 split stage in training, forward and
// backward.
//
// Replaces: voxsrc2020_speaker_verification_tpu/ops/nn.py grouped_conv
// (lines 223-284: the custom_vjp, its forward at 244 and _grouped_conv_bwd
// at 248-281) as models/res2net.py Res2NetSplitConv (strides > 1 branch,
// lines 52-80) calls it in training: fixed_padding, the grouped 3x3 conv at
// stride 2 over the s-1 groups, training BN per group (statistics over BN
// groups of B / G samples, ops/nn.py:117-174), relu, avg_pool_3x3 of the
// padded last group (ops/nn.py:571-588) and the concat; and their
// gradients. XLA ran them as a pad, the grouped conv and its hand-written
// backward, s-1 grouped BNs, nine strided adds and a copy; the port's
// earlier route ran F.pad, cuDNN's grouped conv, K5 over the groups, nine
// strided adds and torch.cat, with autograd scattering the backward into
// zeroed full-size gradients before cuDNN's dgrad and wgrad.
//
// x (B, T, F, s*w) channels-last; output (B, T', F', s*w) with T' = (T-1)/2
// + 1, F' = (F-1)/2 + 1. Output (t', f') reads x at rows 2t'-1 .. 2t'+1 and
// columns 2f'-1 .. 2f'+1, zero outside [0, T) x [0, F) (the padding is
// implicit). Per group i < s-1, BN group g:
//   z_i  = conv3x3_stride2(x_i, W_i)                 (rounded to the dtype)
//   y_i  = relu((z_i - mean_g) * rstd_g)             (rounded to the dtype)
// with mean_g and var_g = E[z^2] - mean_g^2 over the group's (B/G) T' F'
// output positions, rstd_g = 1 / sqrt(var_g + eps); y_{s-1} = the 3x3
// average pool of the padded last group, the pads counted, rounded where
// avg_pool_3x3 rounds (bit-equal to it).
//
// Forward (K11), two launches a stage:
//   split_stride2_train_fwd: CTAs walk slabs (a group, one utterance, a
//     run of its output tiles: a slab never straddles a BN group), each
//     tile staging its input patch with the padding implicit and the even
//     and odd columns apart (the rows of a tile, two columns apart in x,
//     are consecutive in shared memory), the conv, z rounded and written
//     (saved for the backward), z and z^2 summed per channel over the slab
//     into its partials; CTAs of their own write the average pool of the
//     last group into the output. The last conv CTA to arrive (an integer
//     ticket, no float atomics) adds the partials in slab order per (BN
//     group, channel), publishes mean, rstd and var, and applies the
//     running update (momentum, Bessel n/(n-1), n the output's rows of a
//     BN group) unless its pointers are null.
//   split_stride2_train_finish: y_i = relu((z_i - mean) * rstd) into the
//     output's s-1 group slices.
// Backward (K11b), two launches a stage:
//   split_stride2_train_bwd_stats: d = dout * [y > 0] (y recomputed from z
//     by the forward's own expression, so the relu decision agrees bit for
//     bit) and its sums d and d * xhat per (BN group, channel), by slab
//     partials and a ticket: mean(d), mean(d xhat).
//   split_stride2_train_bwd_grad, three kinds of CTA in one launch:
//     dz = rstd (d - mean(d) - xhat mean(d xhat)), rounded to the dtype,
//     computed where it is staged;
//     dx of groups < s-1, the transposed stride-2 conv written as a gather
//       by input parity: with the pad of 1, an even input index takes tap 1
//       of output t/2, an odd one tap 0 of (t+1)/2 and tap 2 of (t-1)/2, so
//       the (even, even), (even, odd), (odd, even) and (odd, odd) inputs of
//       a tile are four dense convs of 1, 2, 2 and 4 taps over the tile's dz
//       patch (one more output row and column), nine taps in all: no
//       atomics, no padded buffer;
//     dx of the tail: the pool's backward, dout / 9 gathered from the 1, 2
//       or 4 windows that cover each input position;
//     dW per group: the sum over output positions of x_pad(2t'+kt, 2f'+kf)
//       dz, a CTA a (group, chunk of (tap, input channel) rows, split of
//       the group's tiles); the last split of a chunk to arrive (a ticket)
//       adds the splits' partials in split order. The split count is a
//       function of the shape alone (models/res2net.py:_S2T_WGRAD_CTAS), so
//       dW is the same bits on every run and every card.
//
// Two designs (the plan, models/res2net.py:stride2_train_plan):
// * "mma" (bfloat16 at the registered stride-2 widths 8, 16, 32, 48, 64,
//   96, 192): the conv, the dgrad and the weight gradient on mma.sync
//   m16n8k16 with fp32 accumulation. Conv and dgrad: A by ldmatrix from
//   the staged patch (a lane's row address is its position's plus the
//   tap's offset, the K of a tap padded to whole k steps of 16 as in K10),
//   B from the weights in shared memory (resident where they fit, else two
//   slots of k steps, the next loading while this one computes). Weight
//   gradient: (tap, 16 channels) m tiles by all w channels, K the tile's
//   positions, both operands by ldmatrix.trans out of the x and dz
//   patches. The patch of x by cp.async; the pool on CUDA cores.
// * "fma" (float32, and bfloat16 at other widths): the same tiles on CUDA
//   cores, a thread 8 rows by 4 (or 1) channels, a tap's weights staged at
//   a time. float32 stays off the tensor cores: TF32 would cost 13 mantissa
//   bits the plain version keeps.
//
// Bound on the card: bytes. Forward: x read and z written (the conv), z
// read and the output written; backward: dout and z read twice (the sums,
// then dz), x read (dW), dx written. At the bench step's stride-2 stages
// (res2net50_w8_s6_c16, B = 256, 200 frames, bf16) about 1.3 / 0.66 / 0.33
// GB forward and 2.1 / 1.1 / 0.53 GB backward a microbatch; the convs are
// 18 w^2 (s-1) flops a position three times over, below Hopper's ridge at
// these widths. What bounds this first design: the patch loads exposed
// between tiles (staged, waited, then computed, in one buffer), and dz
// computed again by each kind of CTA that stages it (the dgrad's slabs and
// every chunk of the weight gradient).
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSmemMax = 232448;  // 227 KB, the most a block can take
constexpr int kMaxGroups = 8;     // conv groups s - 1, at most
constexpr int kFmaThreads = 128;
constexpr int kFmaTm = 8;         // rows a thread of the FMA convs, at most
constexpr int kStatThreads = 256;  // bwd_stats, finish
constexpr int kMaxUpt = 8;        // (tap, channel) rows a thread of the weight gradient
constexpr int kRedFloats = 2 * kFmaThreads * 4;  // the FMA forward's per-thread sums

// The running statistics, passed by value: the BN modules' own tensors
struct Running {
  float* mean[kMaxGroups];
  float* var[kMaxGroups];
};

struct Plan {
  // from the caller (models/res2net.py:_stride2_train_ints)
  int batch, tlen, flen, split, width, groups, design, tt, tf, k, kstat, pool_ctas, nsplit,
      upt, sk, ring, threads;
  // derived
  int tout, fout, tiles_f, tiles, bpg, ng, nconv, nstat, xs, nb, pg, pc, nchunks, nwgrad;
  long long npos;
};

__host__ __device__ inline long long align16(long long v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// bf16 row stride of a staged position in the mma design: w plus a pad
// that makes it an odd number of 16-byte units (models/res2net.py:
// _halo_stride)
__host__ __device__ constexpr int halo_stride(int width) {
  return width + 2 * ((4 - (width / 2) % 8 + 8) % 8);
}

// K columns of a tap in the mma weights: w padded to whole k steps of 16
__host__ __device__ constexpr int tap_cols(int width) { return (width + 15) / 16 * 16; }

// the mma design's (width, n tiles a warp): WN = w / (8 NT) warps across
// the channels, 8 / WN (at most 4) down the rows
__host__ __device__ inline int mma_nt(int width) {
  switch (width) {
    case 8: return 1;
    case 16: return 2;
    case 32: return 4;
    case 48: return 6;
    case 64: return 8;
    case 96: return 6;
    case 192: return 8;
    default: return 0;
  }
}

__host__ __device__ inline int fma_tn(int width) { return width % 4 == 0 ? 4 : 1; }

// The mma design's weight gradient: m tiles of (tap, 16 input channels),
// 9 ceil(w / 16) of them; WMT a warp (at most 64 accumulator registers a
// thread, w / 2 an m tile), the CTA's warps times WMT a chunk
__host__ __device__ constexpr int wg_mtiles(int width) { return 9 * ((width + 15) / 16); }
__host__ __device__ constexpr int wg_wmt(int width, int warps) {
  return ((wg_mtiles(width) + warps - 1) / warps) < (128 / width > 1 ? 128 / width : 1)
             ? (wg_mtiles(width) + warps - 1) / warps
             : (128 / width > 1 ? 128 / width : 1);
}
// the mma threads a CTA at width w (32 wm wn)
__host__ __device__ inline int mma_threads(int width) {
  const int nt = mma_nt(width);
  if (nt == 0) return 0;
  const int wn = width / (8 * nt);
  return 32 * wn * (4 < 8 / wn ? 4 : 8 / wn);
}

// Shared memory (models/res2net.py:_stride2_train_smem), in bytes
__host__ __device__ inline long long xpatch_bytes(const Plan& p, int item) {
  return align16(static_cast<long long>(2 * p.tt + 1) * (2 * p.tf + 1) * p.xs * item);
}
__host__ __device__ inline long long dpatch_bytes(const Plan& p, int item) {
  return align16(static_cast<long long>(p.tt + 1) * (p.tf + 1) * p.xs * item);
}
__host__ __device__ inline long long mma_weight_bytes(const Plan& p) {
  return 2LL * p.ring * p.width * (16 * p.sk + 8);
}
inline long long fwd_smem(const Plan& p, int item) {
  if (p.design == 1)
    return mma_weight_bytes(p) + xpatch_bytes(p, 2) + 8LL * (p.threads / 32) * p.width;
  return align16(4LL * p.width * p.width) + 4LL * kRedFloats + xpatch_bytes(p, item);
}
// the mma weight gradient's dz patch, a zero row after it, and the tile's
// row tables (x and dz offsets of each of the tile's positions, padded to
// whole k steps of 16)
__host__ __device__ inline int wg_ksteps(const Plan& p) { return (p.tt * p.tf + 15) / 16; }
__host__ __device__ inline long long wg_dpatch_bytes(const Plan& p) {
  return align16(static_cast<long long>((p.tt + 1) * (p.tf + 1) + 1) * p.xs * 2);
}
inline long long grad_smem(const Plan& p, int item) {
  const long long wgrad = p.design == 1
      ? xpatch_bytes(p, 2) + wg_dpatch_bytes(p) + 2LL * 4 * 16 * wg_ksteps(p)
      : xpatch_bytes(p, item) + dpatch_bytes(p, item);
  const long long dgrad = p.design == 1 ? mma_weight_bytes(p) + dpatch_bytes(p, 2)
                                        : align16(4LL * p.width * p.width) + dpatch_bytes(p, item);
  return std::max(wgrad, dgrad);
}

bool make_plan(const int* a, Plan* p) {
  p->batch = a[0]; p->tlen = a[1]; p->flen = a[2]; p->split = a[3]; p->width = a[4];
  p->groups = a[5]; p->design = a[6]; p->tt = a[7]; p->tf = a[8]; p->k = a[9];
  p->kstat = a[10]; p->pool_ctas = a[11]; p->nsplit = a[12]; p->upt = a[13]; p->sk = a[14];
  p->ring = a[15]; p->threads = a[16];
  const int w = p->width;
  if (p->batch < 1 || p->tlen < 1 || p->flen < 1 || p->split < 2 || p->split - 1 > kMaxGroups ||
      w < 1 || w > 256 || p->groups < 1 || p->batch % p->groups || p->tt < 1 || p->tf < 1 ||
      p->tf > 16 || p->k < 1 || p->kstat < 1 || p->pool_ctas < 1 || p->nsplit < 1 ||
      p->upt < 1 || p->threads < 32 || p->threads > 256 ||
      p->threads % 32)
    return false;
  p->tout = (p->tlen - 1) / 2 + 1;
  p->fout = (p->flen - 1) / 2 + 1;
  p->npos = static_cast<long long>(p->tout) * p->fout;
  p->tiles_f = (p->fout + p->tf - 1) / p->tf;
  p->tiles = ((p->tout + p->tt - 1) / p->tt) * p->tiles_f;
  p->bpg = p->batch / p->groups;
  p->ng = p->split - 1;
  if (p->k > p->tiles || p->kstat > p->npos) return false;
  if (p->design == 1) {
    const int nt = mma_nt(w);
    if (nt == 0 || p->ring < 1 || p->ring > 2 || p->sk < 1) return false;
    const int wn = w / (8 * nt), ksteps = 9 * tap_cols(w) / 16;
    if (p->threads != mma_threads(w) || p->tt * p->tf > 32 * (p->threads / 32 / wn))
      return false;
    if (p->ring == 1 ? p->sk != ksteps : p->sk >= ksteps) return false;
    p->xs = halo_stride(w);
  } else if (p->design == 0) {
    const int tn = fma_tn(w), nb = (w + tn - 1) / tn;
    if (p->threads != kFmaThreads || nb > kFmaThreads || p->upt > kMaxUpt ||
        p->tt * p->tf > imin(128, (kFmaThreads / nb) * kFmaTm) || p->ring != 0 || p->sk != 0)
      return false;
    p->xs = w | 1;
  } else {
    return false;
  }
  if (p->design == 1) {
    const int warps = p->threads / 32;
    if (p->threads != mma_threads(w) || p->upt != wg_wmt(w, warps)) return false;
    p->nb = p->pg = 0;
    p->pc = warps * p->upt * 16;
    p->nchunks = (wg_mtiles(w) + warps * p->upt - 1) / (warps * p->upt);
  } else {
    p->nb = (w + 3) / 4;
    p->pg = p->threads / p->nb;
    if (p->pg < 1) return false;
    p->pc = p->pg * p->upt;
    p->nchunks = (9 * w + p->pc - 1) / p->pc;
  }
  p->nconv = p->ng * p->batch * p->k;
  p->nstat = p->ng * p->batch * p->kstat;
  p->nwgrad = p->ng * p->nchunks * p->nsplit;
  if (static_cast<long long>(p->nwgrad) + p->nconv + p->pool_ctas > 0x7fffffffLL ||
      static_cast<long long>(p->batch) * p->npos * p->split * w > (1LL << 40))
    return false;
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* q) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(q));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
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

// V consecutive elements: one 16-byte vector (V * sizeof(T) == 16) or one
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* q, float* v) {
  if constexpr (V == 1) {
    v[0] = vsv::to_f(*q);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    vsv::unpack16(*reinterpret_cast<const uint4*>(q), v, q);
  }
}
template <typename T, int V>
__device__ __forceinline__ void store_v(T* q, const float* v) {
  if constexpr (V == 1) {
    *q = vsv::from_f<T>(v[0]);
  } else {
    vsv::store16(q, v);
  }
}

// The output tile `tile` of a sample: its first output row and column
__device__ __forceinline__ void tile_origin(const Plan& p, int tile, int* t0, int* f0) {
  *t0 = tile / p.tiles_f * p.tt;
  *f0 = tile % p.tiles_f * p.tf;
}

// The patch slot of patch column pf: even columns first, then odd ones
__device__ __forceinline__ int xslot(int pf, int tf) {
  return (pf & 1) ? tf + 1 + (pf >> 1) : (pf >> 1);
}

// Offset of tap (kt, kf) in the x patch, relative to an output position's
// row offset (2 ot pf_n + of) xs: row kt, and the slot of column 2 of + kf
__device__ __forceinline__ int xtap(int tap, int pf_n, int tf, int xs) {
  const int kf = tap % 3;
  return ((tap / 3) * pf_n + (kf == 1 ? tf + 1 : kf / 2)) * xs;
}

// Stage the x patch of output tile (t0, f0) of sample b, group grp: input
// rows 2 t0 - 1 .. 2 t0 + 2 tt - 1, columns 2 f0 - 1 .. 2 f0 + 2 tf - 1, at
// (row pt, slot) of stride xs, zero outside the utterance. ASYNC: 16-byte
// cp.async (bf16, w % 8 == 0; the caller commits and waits); else element
// by element.
template <typename T, bool ASYNC>
__device__ void stage_x(const T* __restrict__ x, T* patch, const Plan& p, int b, int grp, int t0,
                        int f0) {
  const int w = p.width, pt_n = 2 * p.tt + 1, pf_n = 2 * p.tf + 1, chan = p.split * w;
  const int per = ASYNC ? w / 8 : w, n = pt_n * pf_n * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int pos = i / per, c = (i % per) * (ASYNC ? 8 : 1);
    const int pt = pos / pf_n, pf = pos % pf_n;
    const int t = 2 * t0 - 1 + pt, f = 2 * f0 - 1 + pf;
    const bool valid = t >= 0 && t < p.tlen && f >= 0 && f < p.flen;
    const long long src = (valid ? (static_cast<long long>(b) * p.tlen + t) * p.flen + f : 0) *
                              chan + grp * w + c;
    T* dst = patch + (pt * pf_n + xslot(pf, p.tf)) * p.xs + c;
    if constexpr (ASYNC) {
      cp_async16(smem_u32(dst), x + src, valid);
    } else {
      *dst = valid ? x[src] : vsv::from_f<T>(0.f);
    }
  }
}

// The forward's relu decision and xhat of z at (group, BN group, channel)
// statistics (mean, rstd): v = (z - mean) * rstd; the output is relu(v)
// rounded, so y > 0 exactly where round(v) > 0.
__device__ __forceinline__ float bn_v(float z, float m, float r) {
  return (z - m) * r;
}

// dz at one element: d = dout [round(v) > 0], dz = rstd (d - mean(d) - v
// mean(d v)), rounded to the dtype by the caller's store
template <typename T>
__device__ __forceinline__ float dz_of(float z, float dout, float m, float r, float md,
                                       float mdx) {
  const float v = bn_v(z, m, r);
  const float d = vsv::round_to<T>(v) > 0.f ? dout : 0.f;
  return r * (d - md - v * mdx);
}

// Stage dz of group grp, sample b at output positions (t0 + du, f0 + dv),
// du <= tt, dv <= tf, at row du (tf + 1) + dv of stride xs, zero outside
// T' x F'. V channels at a time (16-byte vectors where the plan's layout
// allows).
template <typename T, int V>
__device__ void stage_dz(const T* __restrict__ dout, const T* __restrict__ z,
                         const float* __restrict__ stats, const float* __restrict__ bsums, T* dp,
                         const Plan& p, int b, int grp, int t0, int f0) {
  const int w = p.width, vecs = w / V, chan = p.split * w, gw = p.groups * w;
  const int g = b / p.bpg, n = (p.tt + 1) * (p.tf + 1) * vecs;
  const float* st = stats + static_cast<long long>(grp) * 3 * gw + g * w;
  const float* bs = bsums + static_cast<long long>(grp) * 2 * gw + g * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int pos = i / vecs, c = (i % vecs) * V;
    const int ot = t0 + pos / (p.tf + 1), of = f0 + pos % (p.tf + 1);
    float o[V];
    if (ot < p.tout && of < p.fout) {
      const long long q = (static_cast<long long>(b) * p.tout + ot) * p.fout + of;
      float zv[V], dv[V];
      load_v<T, V>(z + (static_cast<long long>(grp) * p.batch * p.npos + q) * w + c, zv);
      load_v<T, V>(dout + q * chan + grp * w + c, dv);
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = dz_of<T>(zv[e], dv[e], st[c + e], st[gw + c + e], bs[c + e], bs[gw + c + e]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = 0.f;
    }
    store_v<T, V>(dp + pos * p.xs + c, o);
  }
}

// The average pool of output position (b, ot, of), V channels from c of the
// last group, in avg_pool_3x3's order and rounding: the nine taps added in
// (di, dj) order, each add rounded to the dtype, times 1 / 9
template <typename T, int V>
__device__ void pool_fwd_items(const T* __restrict__ x, T* __restrict__ out, const Plan& p,
                               long long first, long long stride) {
  const int w = p.width, vecs = w / V, chan = p.split * w, src = (p.split - 1) * w;
  const long long n = static_cast<long long>(p.batch) * p.npos * vecs;
  for (long long i = first; i < n; i += stride) {
    const int c = static_cast<int>(i % vecs) * V;
    const long long q = i / vecs;
    const int of = static_cast<int>(q % p.fout), ot = static_cast<int>(q / p.fout % p.tout);
    const long long b = q / p.npos;
    float acc[V];
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int t = 2 * ot - 1 + di, f = 2 * of - 1 + dj;
        float v[V];
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = 0.f;
        if (t >= 0 && t < p.tlen && f >= 0 && f < p.flen)
          load_v<T, V>(x + ((b * p.tlen + t) * p.flen + f) * chan + src + c, v);
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] = (di == 0 && dj == 0) ? v[e] : vsv::round_to<T>(acc[e] + v[e]);
      }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = acc[e] * (1.0f / 9.0f);
    store_v<T, V>(out + q * chan + src + c, acc);
  }
}

// The pool's backward at input position (b, t, f), V channels: dout / 9 of
// the 1, 2 or 4 windows covering it, each rounded to the dtype as autograd
// rounds the division's gradient, added in float and rounded once
template <typename T, int V>
__device__ void pool_bwd_items(const T* __restrict__ dout, T* __restrict__ dx, const Plan& p,
                               long long first, long long stride) {
  const int w = p.width, vecs = w / V, chan = p.split * w, src = (p.split - 1) * w;
  const long long n = static_cast<long long>(p.batch) * p.tlen * p.flen * vecs;
  for (long long i = first; i < n; i += stride) {
    const int c = static_cast<int>(i % vecs) * V;
    const long long q = i / vecs;
    const int f = static_cast<int>(q % p.flen), t = static_cast<int>(q / p.flen % p.tlen);
    const long long b = q / (static_cast<long long>(p.tlen) * p.flen);
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    // windows ot with 2 ot - 1 <= t <= 2 ot + 1
    const int ot0 = t / 2, ot1 = imin((t + 1) / 2, p.tout - 1);
    const int of0 = f / 2, of1 = imin((f + 1) / 2, p.fout - 1);
    for (int ot = ot0; ot <= ot1; ++ot)
      for (int of = of0; of <= of1; ++of) {
        float v[V];
        load_v<T, V>(dout + ((b * p.tout + ot) * p.fout + of) * chan + src + c, v);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += vsv::round_to<T>(v[e] * (1.0f / 9.0f));
      }
    store_v<T, V>(dx + q * chan + src + c, acc);
  }
}

// An integer ticket: true in the last of `arrivals` CTAs to call it, once
// every CTA's writes before the call are visible; that CTA leaves the
// ticket zero for the next launch.
__device__ bool last_to_arrive(unsigned int* ticket, unsigned int arrivals) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == arrivals - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    if (threadIdx.x == 0) *ticket = 0u;
  }
  return last;
}

// After every slab wrote its (2, w) partials (part[slab][sum][channel],
// slab = (group * B + sample) * per + run): per (group, BN group, channel)
// the sums in slab order, divided by the rows n of a BN group.
// FWD: mean, rstd = 1 / sqrt(var + eps), var = E[z^2] - mean^2 into stats
// (group, 3, G, w), then the running update unless run is null; else mean(d)
// and mean(d xhat) into bsums (group, 2, G, w).
template <bool FWD>
__device__ void collapse(const float* part, int per, const Plan& p, float* out,
                         const Running* run, float eps, float mom, float upd_mean, float upd_var) {
  const int w = p.width, gw = p.groups * w;
  const float n = static_cast<float>(static_cast<long long>(p.bpg) * p.npos);
  for (int idx = threadIdx.x; idx < p.ng * gw; idx += blockDim.x) {
    const int grp = idx / gw, g = idx / w % p.groups, c = idx % w;
    float s1 = 0.f, s2 = 0.f;
    for (int b = g * p.bpg; b < (g + 1) * p.bpg; ++b)
      for (int r = 0; r < per; ++r) {
        const float* q = part + ((static_cast<long long>(grp) * p.batch + b) * per + r) * 2 * w + c;
        s1 += __ldcg(q);
        s2 += __ldcg(q + w);
      }
    if constexpr (FWD) {
      const float mu = s1 / n, var = s2 / n - mu * mu;
      float* st = out + static_cast<long long>(grp) * 3 * gw + g * w + c;
      st[0] = mu;
      st[gw] = 1.f / sqrtf(var + eps);
      st[2 * gw] = var;
    } else {
      float* bs = out + static_cast<long long>(grp) * 2 * gw + g * w + c;
      bs[0] = s1 / n;
      bs[gw] = s2 / n;
    }
  }
  if constexpr (FWD) {
    if (run == nullptr) return;
    __syncthreads();
    for (int idx = threadIdx.x; idx < p.ng * w; idx += blockDim.x) {
      const int grp = idx / w, c = idx % w;
      const float* st = out + static_cast<long long>(grp) * 3 * gw + c;
      float ms = 0.f, vs = 0.f;
      for (int g = 0; g < p.groups; ++g) {
        ms += st[g * w];
        vs += st[2 * gw + g * w];
      }
      const float gf = static_cast<float>(p.groups);
      float* rm = run->mean[grp] + c;
      float* rv = run->var[grp] + c;
      *rm = __fadd_rn(__fmul_rn(mom, *rm), __fmul_rn(upd_mean, ms / gf));
      *rv = __fadd_rn(__fmul_rn(mom, *rv), __fmul_rn(upd_var, vs / gf));
    }
  }
}

// A conv slab's (group, sample, tiles [first, end))
__device__ __forceinline__ void slab_of(const Plan& p, int slab, int* grp, int* b, int* first,
                                        int* end) {
  *grp = slab / (p.batch * p.k);
  *b = slab / p.k % p.batch;
  const int r = slab % p.k;
  *first = p.tiles * r / p.k;
  *end = p.tiles * (r + 1) / p.k;
}

// ---------------------------------------------------------------------------
// Weight gradient of the FMA design: CTA item = (group, chunk, split)
// ---------------------------------------------------------------------------

// dW of group grp, (tap, input channel) rows [chunk pc, (chunk + 1) pc) of
// the 9 w (p = tap w + c), over the split's tiles. A thread: 4 output
// channels (n-block j) by upt rows (its pair group's), accumulating x
// patch values times dz; partials by split, the last split to arrive adds
// them in split order and writes dW in the dtype (OIHW).
template <typename T>
__device__ void wgrad_item(int item, const T* __restrict__ x, const T* __restrict__ dout,
                           const T* __restrict__ z, const float* __restrict__ stats,
                           const float* __restrict__ bsums, T* __restrict__ dweight,
                           float* __restrict__ wpart, unsigned int* tickets, const Plan& p,
                           unsigned char* smem) {
  const int w = p.width, xs = p.xs, pf_n = 2 * p.tf + 1;
  const int grp = item / (p.nchunks * p.nsplit), chunk = item / p.nsplit % p.nchunks;
  const int split = item % p.nsplit;
  T* xp = reinterpret_cast<T*>(smem);
  T* dp = reinterpret_cast<T*>(smem + xpatch_bytes(p, sizeof(T)));
  const int j = threadIdx.x % p.nb, pg = threadIdx.x / p.nb;
  const bool active = pg < p.pg;
  int xo[kMaxUpt];
  bool pv[kMaxUpt];
#pragma unroll
  for (int i = 0; i < kMaxUpt; ++i) {
    const int q = chunk * p.pc + pg + i * p.pg;
    pv[i] = active && i < p.upt && q < 9 * w;
    xo[i] = pv[i] ? xtap(q / w, pf_n, p.tf, xs) + q % w : 0;
  }
  float acc[kMaxUpt][4];
#pragma unroll
  for (int i = 0; i < kMaxUpt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const long long ntiles = static_cast<long long>(p.batch) * p.tiles;
  const int first = static_cast<int>(ntiles * split / p.nsplit);
  const int end = static_cast<int>(ntiles * (split + 1) / p.nsplit);
  for (int tile = first; tile < end; ++tile) {
    const int b = tile / p.tiles;
    int t0, f0;
    tile_origin(p, tile % p.tiles, &t0, &f0);
    __syncthreads();  // the previous tile's patches are free
    stage_x<T, false>(x, xp, p, b, grp, t0, f0);
    stage_dz<T, 1>(dout, z, stats, bsums, dp, p, b, grp, t0, f0);
    __syncthreads();
    if (!active) continue;
    const int rt = imin(p.tt, p.tout - t0), rf = imin(p.tf, p.fout - f0);
    for (int ot = 0; ot < rt; ++ot)
      for (int of = 0; of < rf; ++of) {
        const T* xr = xp + (2 * ot * pf_n + of) * xs;
        const T* dr = dp + (ot * (p.tf + 1) + of) * xs + 4 * j;
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = 4 * j + e < w ? vsv::to_f(dr[e]) : 0.f;
#pragma unroll
        for (int i = 0; i < kMaxUpt; ++i) {
          if (!pv[i]) continue;
          const float xv = vsv::to_f(xr[xo[i]]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(xv, d[e], acc[i][e]);
        }
      }
  }
  const long long pcw = static_cast<long long>(p.pc) * w;
  const long long cbase = static_cast<long long>(grp * p.nchunks + chunk) * p.nsplit;
  float* mine = wpart + (cbase + split) * pcw;
#pragma unroll
  for (int i = 0; i < kMaxUpt; ++i) {
    if (!pv[i]) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * j + e < w) mine[(pg + i * p.pg) * w + 4 * j + e] = acc[i][e];
  }
  if (!last_to_arrive(tickets + grp * p.nchunks + chunk, p.nsplit)) return;
  for (long long idx = threadIdx.x; idx < pcw; idx += blockDim.x) {
    const int pl = static_cast<int>(idx / w), n = static_cast<int>(idx % w);
    const int q = chunk * p.pc + pl;
    if (q >= 9 * w) continue;
    float s = 0.f;
    for (int sp = 0; sp < p.nsplit; ++sp) s += __ldcg(wpart + (cbase + sp) * pcw + idx);
    dweight[((static_cast<long long>(grp) * w + n) * w + q % w) * 9 + q / w] = vsv::from_f<T>(s);
  }
}

// ---------------------------------------------------------------------------
// "fma": the forward conv and the dgrad on CUDA cores
// ---------------------------------------------------------------------------

// out[r][n] += sum over k < w of P[rowoff[i] + toff + k] * ws[k][n] for
// this thread's rows (r0 + i rs) and channels (nb tn + e): one tap
template <typename T, int TN>
__device__ __forceinline__ void fma_tap(float (&acc)[kFmaTm][TN], const T* pp, const float* ws,
                                        const int (&rowoff)[kFmaTm], int toff, int w, int nb,
                                        int tm) {
  for (int k = 0; k < w; ++k) {
    float bv[TN];
#pragma unroll
    for (int e = 0; e < TN; ++e) bv[e] = nb * TN + e < w ? ws[k * w + nb * TN + e] : 0.f;
#pragma unroll
    for (int i = 0; i < kFmaTm; ++i) {
      if (i >= tm) break;
      const float a = vsv::to_f(pp[rowoff[i] + toff + k]);
#pragma unroll
      for (int e = 0; e < TN; ++e) acc[i][e] = fmaf(a, bv[e], acc[i][e]);
    }
  }
}

// the weights of tap slot `slot` of group grp ((9, w, w) a group: [k][n])
// into ws as floats
template <typename T>
__device__ __forceinline__ void stage_tap_weights(float* ws, const T* __restrict__ wk, int grp,
                                                  int slot, int w) {
  const T* src = wk + (static_cast<long long>(grp) * 9 + slot) * w * w;
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) ws[i] = vsv::to_f(src[i]);
}

struct FwdArgs {
  float* part;
  unsigned int* ticket;
  float* stats;
  Running run;
  bool update;
  float eps, mom, upd_mean, upd_var;
};

// wk: (s-1, 9, w, w) [group][tap][c][n]
template <typename T, int TN, int V>
__global__ void __launch_bounds__(kFmaThreads) fwd_fma_kernel(const T* __restrict__ x,
                                                              const T* __restrict__ wk,
                                                              T* __restrict__ z,
                                                              T* __restrict__ out, Plan p,
                                                              FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) >= p.nconv) {
    pool_fwd_items<T, V>(x, out, p, (blockIdx.x - p.nconv) * static_cast<long long>(blockDim.x) +
                                        threadIdx.x,
                         static_cast<long long>(p.pool_ctas) * blockDim.x);
    return;
  }
  const int w = p.width, nbk = (w + TN - 1) / TN, rs = kFmaThreads / nbk;
  float* ws = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(4LL * w * w));
  T* xp = reinterpret_cast<T*>(smem + align16(4LL * w * w) + 4LL * kRedFloats);
  const int tid = threadIdx.x, nb = tid % nbk, r0 = tid / nbk;
  const bool active = r0 < rs;
  const int rows = p.tt * p.tf, pf_n = 2 * p.tf + 1;
  const int tm = active ? imin(kFmaTm, (rows - r0 + rs - 1) / rs) : 0;
  int rowoff[kFmaTm];
#pragma unroll
  for (int i = 0; i < kFmaTm; ++i) {
    const int r = imin(r0 + i * rs, rows - 1);
    rowoff[i] = (2 * (r / p.tf) * pf_n + r % p.tf) * p.xs;
  }
  int grp, b, first, end;
  slab_of(p, blockIdx.x, &grp, &b, &first, &end);
  float s1[TN], s2[TN];
#pragma unroll
  for (int e = 0; e < TN; ++e) s1[e] = s2[e] = 0.f;
  for (int tile = first; tile < end; ++tile) {
    int t0, f0;
    tile_origin(p, tile, &t0, &f0);
    __syncthreads();
    stage_x<T, false>(x, xp, p, b, grp, t0, f0);
    float acc[kFmaTm][TN];
#pragma unroll
    for (int i = 0; i < kFmaTm; ++i)
#pragma unroll
      for (int e = 0; e < TN; ++e) acc[i][e] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      __syncthreads();  // the previous tap's weights are consumed
      stage_tap_weights(ws, wk, grp, tap, w);
      __syncthreads();
      fma_tap<T, TN>(acc, xp, ws, rowoff, xtap(tap, pf_n, p.tf, p.xs), w, nb, tm);
    }
#pragma unroll
    for (int i = 0; i < kFmaTm; ++i) {
      const int r = r0 + i * rs;
      if (i >= tm || r >= rows) continue;
      const int ot = t0 + r / p.tf, of = f0 + r % p.tf;
      if (ot >= p.tout || of >= p.fout) continue;
      T* zr = z + ((static_cast<long long>(grp) * p.batch + b) * p.npos +
                   static_cast<long long>(ot) * p.fout + of) * w;
#pragma unroll
      for (int e = 0; e < TN; ++e) {
        const int n = nb * TN + e;
        if (n >= w) continue;
        const float v = vsv::round_to<T>(acc[i][e]);
        zr[n] = vsv::from_f<T>(v);
        s1[e] += v;
        s2[e] += v * v;
      }
    }
  }
  // the slab's sums: the threads of a channel block in row order
#pragma unroll
  for (int e = 0; e < TN; ++e) {
    red[(2 * tid) * TN + e] = active ? s1[e] : 0.f;
    red[(2 * tid + 1) * TN + e] = active ? s2[e] : 0.f;
  }
  __syncthreads();
  float* mine = a.part + static_cast<long long>(blockIdx.x) * 2 * w;
  for (int n = tid; n < w; n += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < rs; ++r) {
      const int th = r * nbk + n / TN;
      t1 += red[(2 * th) * TN + n % TN];
      t2 += red[(2 * th + 1) * TN + n % TN];
    }
    mine[n] = t1;
    mine[w + n] = t2;
  }
  if (last_to_arrive(a.ticket, p.nconv))
    collapse<true>(a.part, p.k, p, a.stats, a.update ? &a.run : nullptr, a.eps, a.mom,
                   a.upd_mean, a.upd_var);
}

// dgrad on CUDA cores, slab (group, sample, tiles): for each tile the dz
// patch, then the four parity classes, each over its taps (wkd: (s-1, 9,
// w, w) [group][slot][n][c], the slots in class order)
template <typename T, int TN>
__device__ void dgrad_fma_slab(int slab, const T* __restrict__ dout, const T* __restrict__ z,
                               const float* __restrict__ stats, const float* __restrict__ bsums,
                               const T* __restrict__ wkd, T* __restrict__ dx, const Plan& p,
                               unsigned char* smem) {
  const int w = p.width, nbk = (w + TN - 1) / TN, rs = kFmaThreads / nbk;
  float* ws = reinterpret_cast<float*>(smem);
  T* dp = reinterpret_cast<T*>(smem + align16(4LL * w * w));
  const int tid = threadIdx.x, nb = tid % nbk, r0 = tid / nbk;
  const bool active = r0 < rs;
  const int rows = p.tt * p.tf, chan = p.split * w;
  const int tm = active ? imin(kFmaTm, (rows - r0 + rs - 1) / rs) : 0;
  int rowoff[kFmaTm];
#pragma unroll
  for (int i = 0; i < kFmaTm; ++i) {
    const int r = imin(r0 + i * rs, rows - 1);
    rowoff[i] = ((r / p.tf) * (p.tf + 1) + r % p.tf) * p.xs;
  }
  int grp, b, first, end;
  slab_of(p, slab, &grp, &b, &first, &end);
  for (int tile = first; tile < end; ++tile) {
    int t0, f0;
    tile_origin(p, tile, &t0, &f0);
    __syncthreads();
    stage_dz<T, 1>(dout, z, stats, bsums, dp, p, b, grp, t0, f0);
    for (int cls = 0; cls < 4; ++cls) {
      const int pt = cls / 2, pf = cls % 2;
      float acc[kFmaTm][TN];
#pragma unroll
      for (int i = 0; i < kFmaTm; ++i)
#pragma unroll
        for (int e = 0; e < TN; ++e) acc[i][e] = 0.f;
      for (int slot = cls == 0 ? 0 : 2 * cls - 1; slot < (cls == 3 ? 9 : 2 * cls + 1); ++slot) {
        __syncthreads();
        stage_tap_weights(ws, wkd, grp, slot, w);
        __syncthreads();
        const int toff = (((0x68 >> slot) & 1) * (p.tf + 1) + ((0xA2 >> slot) & 1)) * p.xs;
        fma_tap<T, TN>(acc, dp, ws, rowoff, toff, w, nb, tm);
      }
#pragma unroll
      for (int i = 0; i < kFmaTm; ++i) {
        const int r = r0 + i * rs;
        if (i >= tm || r >= rows) continue;
        const int t = 2 * (t0 + r / p.tf) + pt, f = 2 * (f0 + r % p.tf) + pf;
        if (t >= p.tlen || f >= p.flen) continue;
        T* xr = dx + ((static_cast<long long>(b) * p.tlen + t) * p.flen + f) * chan + grp * w;
#pragma unroll
        for (int e = 0; e < TN; ++e)
          if (nb * TN + e < w) xr[nb * TN + e] = vsv::from_f<T>(acc[i][e]);
      }
    }
  }
}

struct GradArgs {
  const float* stats;
  const float* bsums;
  float* wpart;
  unsigned int* tickets;
};

template <typename T, int TN, int V>
__global__ void __launch_bounds__(kFmaThreads) grad_fma_kernel(
    const T* __restrict__ x, const T* __restrict__ dout, const T* __restrict__ z,
    const T* __restrict__ wkd, T* __restrict__ dx, T* __restrict__ dweight, Plan p, GradArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blk = blockIdx.x;
  if (blk < p.nwgrad) {
    wgrad_item<T>(blk, x, dout, z, a.stats, a.bsums, dweight, a.wpart, a.tickets, p,
                            smem);
  } else if (blk < p.nwgrad + p.nconv) {
    dgrad_fma_slab<T, TN>(blk - p.nwgrad, dout, z, a.stats, a.bsums, wkd, dx, p, smem);
  } else {
    pool_bwd_items<T, V>(dout, dx, p,
                         (blk - p.nwgrad - p.nconv) * static_cast<long long>(blockDim.x) +
                             threadIdx.x,
                         static_cast<long long>(p.pool_ctas) * blockDim.x);
  }
}

// ---------------------------------------------------------------------------
// "mma": the forward conv and the dgrad on mma.sync (bfloat16)
// ---------------------------------------------------------------------------

// One k step (16 K columns of tap `tap`, chunk ch) of a warp's 32 rows by 8
// NT channels: A rows from the patch at the lane's row offset plus the
// tap's, B from a weight buffer of row stride ws at column col
template <int W, int NT>
__device__ __forceinline__ void mma_kstep(float (&acc)[2][NT][4], uint32_t pbase,
                                          const int (&rowoff)[2], int toff, int ch,
                                          uint32_t wbase, int ws, int col, int lane) {
  constexpr int C8 = W / 8;
  int cc = 16 * ch;
  // a tap's pad chunk (odd C8) reads the last real chunk again, times the
  // zero weights
  if (C8 % 2 != 0 && cc + (lane / 16) * 8 >= W) cc -= 8;
  uint32_t af[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(af[mt], pbase + 2 * (rowoff[mt] + toff + cc));
  const int bcol4 = ((lane % 8) + 8 * (lane / 16)) * ws + ((lane / 8) % 2) * 8;
  const int bcol2 = (lane % 8) * ws + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int np = 0; np + 1 < NT; np += 2) {
    uint32_t bq[4];
    ldmatrix_x4(bq, wbase + 2 * (np * 8 * ws + bcol4 + col));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma_bf16_16816(acc[mt][np], af[mt], bq);
      mma_bf16_16816(acc[mt][np + 1], af[mt], bq + 2);
    }
  }
  if constexpr (NT % 2 != 0) {
    uint32_t bf[2];
    ldmatrix_x2(bf, wbase + 2 * ((NT - 1) * 8 * ws + bcol2 + col));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][NT - 1], af[mt], bf);
  }
}

// The weights of group grp ((s-1, W, 9 KT): row n, K = slot * KT + k),
// k steps [j sk, (j + 1) sk) into buffer buf (rows of 16 sk + 8 columns)
template <int W>
__device__ __forceinline__ void load_wslot(bf16* wsm, const bf16* __restrict__ wk, int grp,
                                           int j, int buf, const Plan& p) {
  constexpr int KPAD = 9 * tap_cols(W), KSTEPS = KPAD / 16;
  const int ws = 16 * p.sk + 8, k0 = j * p.sk;
  const int k8 = 2 * (imin(p.sk, KSTEPS - k0));
  const bf16* src = wk + static_cast<long long>(grp) * W * KPAD + 16 * k0;
  bf16* dst = wsm + buf * W * ws;
  for (int i = threadIdx.x; i < W * k8; i += blockDim.x) {
    const int n = i / k8, c = (i % k8) * 8;
    cp_async16(smem_u32(dst + n * ws + c), src + static_cast<long long>(n) * KPAD + c, true);
  }
}

// The k steps [ks0, ks1) of a tile, the weights resident (ring 1, loaded by
// the caller) or streamed through two buffers of sk k steps (ring 2: the
// caller loaded slot ks0 / sk into its buffer and committed); TOFF(slot)
// gives a tap slot's offset in the patch.
template <int W, int NT, typename TOFF>
__device__ __forceinline__ void mma_ksteps(float (&acc)[2][NT][4], uint32_t pbase,
                                           const int (&rowoff)[2], bf16* wsm,
                                           const bf16* __restrict__ wk, int grp, int ks0,
                                           int ks1, const Plan& p, int nbase, int lane,
                                           TOFF toff_of) {
  constexpr int KSPT = tap_cols(W) / 16, KSTEPS = 9 * KSPT;
  const int ws = 16 * p.sk + 8, nslots = (KSTEPS + p.sk - 1) / p.sk;
  for (int ks = ks0; ks < ks1; ++ks) {
    int buf = 0, col = 16 * ks;
    if (p.ring == 2) {
      const int j = ks / p.sk;
      if (ks % p.sk == 0) {
        cp_async_wait_all();
        __syncthreads();  // slot j landed; every warp is done with slot j - 1
        if (j + 1 < nslots) load_wslot<W>(wsm, wk, grp, j + 1, (j + 1) & 1, p);
        cp_async_commit();
      }
      buf = j & 1;
      col = 16 * (ks % p.sk);
    }
    const int slot = ks / KSPT;
    mma_kstep<W, NT>(acc, pbase, rowoff, toff_of(slot), ks % KSPT,
                     smem_u32(wsm + buf * W * ws + nbase), ws, col, lane);
  }
}

// wk: (s-1, W, 9 KT) bf16, row n of group i its output channel's taps
template <int W, int NT>
__global__ void __launch_bounds__(256) fwd_mma_kernel(const bf16* __restrict__ x,
                                                      const bf16* __restrict__ wk,
                                                      bf16* __restrict__ z,
                                                      bf16* __restrict__ out, Plan p,
                                                      FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) >= p.nconv) {
    pool_fwd_items<bf16, 8>(x, out, p,
                            (blockIdx.x - p.nconv) * static_cast<long long>(blockDim.x) +
                                threadIdx.x,
                            static_cast<long long>(p.pool_ctas) * blockDim.x);
    return;
  }
  constexpr int WN = W / (8 * NT), HS = halo_stride(W);
  constexpr int KSTEPS = 9 * tap_cols(W) / 16;
  const int ws = 16 * p.sk + 8;
  bf16* wsm = reinterpret_cast<bf16*>(smem);
  bf16* xp = reinterpret_cast<bf16*>(smem + mma_weight_bytes(p));
  float* red = reinterpret_cast<float*>(smem + mma_weight_bytes(p) + xpatch_bytes(p, 2));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int wm_idx = warp / WN, wn_idx = warp % WN;
  const int rows = p.tt * p.tf, pf_n = 2 * p.tf + 1;
  int rowoff[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = imin(wm_idx * 32 + mt * 16 + lane % 16, rows - 1);
    rowoff[mt] = (2 * (r / p.tf) * pf_n + r % p.tf) * HS + (lane / 16) * 8;
  }
  const int nbase = wn_idx * NT * 8 * ws;
  const uint32_t pbase = smem_u32(xp);
  auto toff_of = [&](int slot) { return xtap(slot, pf_n, p.tf, HS); };
  int grp, b, first, end;
  slab_of(p, blockIdx.x, &grp, &b, &first, &end);
  if (p.ring == 1) load_wslot<W>(wsm, wk, grp, 0, 0, p);  // waited with the first patch
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;
  for (int tile = first; tile < end; ++tile) {
    int t0, f0;
    tile_origin(p, tile, &t0, &f0);
    stage_x<bf16, true>(x, xp, p, b, grp, t0, f0);
    if (p.ring == 2) load_wslot<W>(wsm, wk, grp, 0, 0, p);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    // ring 2: the first slot is waited here already, the loop's first
    // boundary waits again (nothing pending) and issues the second
    mma_ksteps<W, NT>(acc, pbase, rowoff, wsm, wk, grp, 0, KSTEPS, p, nbase, lane, toff_of);
    // epilogue: z rounded, written; the slab's sums of z and z^2
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int co = (wn_idx * NT + nt) * 8 + 2 * tg;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm_idx * 32 + mt * 16 + g + 8 * h;
          if (r >= rows) continue;
          const int ot = t0 + r / p.tf, of = f0 + r % p.tf;
          if (ot >= p.tout || of >= p.fout) continue;
          const float v0 = vsv::round_to<bf16>(acc[mt][nt][2 * h]);
          const float v1 = vsv::round_to<bf16>(acc[mt][nt][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              z + ((static_cast<long long>(grp) * p.batch + b) * p.npos +
                   static_cast<long long>(ot) * p.fout + of) * W + co) = __floats2bfloat162_rn(v0, v1);
          s1[nt][0] += v0;
          s1[nt][1] += v1;
          s2[nt][0] += v0 * v0;
          s2[nt][1] += v1 * v1;
        }
    }
    __syncthreads();  // every warp is done with the patch (and the weight buffers)
  }
  // the slab's sums: over the 8 row lanes g by a fixed shuffle tree, then
  // over the warps down the rows in order
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o *= 2) {
        s1[nt][e] += __shfl_xor_sync(0xffffffffu, s1[nt][e], o);
        s2[nt][e] += __shfl_xor_sync(0xffffffffu, s2[nt][e], o);
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = (wn_idx * NT + nt) * 8 + 2 * tg + e;
        red[(wm_idx * 2) * W + co] = s1[nt][e];
        red[(wm_idx * 2 + 1) * W + co] = s2[nt][e];
      }
  }
  __syncthreads();
  const int wm_n = blockDim.x / 32 / WN;
  float* mine = a.part + static_cast<long long>(blockIdx.x) * 2 * W;
  for (int n = tid; n < W; n += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int m = 0; m < wm_n; ++m) {
      t1 += red[(2 * m) * W + n];
      t2 += red[(2 * m + 1) * W + n];
    }
    mine[n] = t1;
    mine[W + n] = t2;
  }
  if (last_to_arrive(a.ticket, p.nconv))
    collapse<true>(a.part, p.k, p, a.stats, a.update ? &a.run : nullptr, a.eps, a.mom,
                   a.upd_mean, a.upd_var);
}

// dgrad on mma.sync, slab (group, sample, tiles): per tile the dz patch of
// (tt + 1) x (tf + 1) output positions, then the four parity classes, each
// the k steps of its tap slots (wkd: (s-1, W, 9 KT), row c, K = slot * KT +
// n, the slots in class order); class (pt, pf)'s rows are the tile's input
// positions (2 (t0 + u) + pt, 2 (f0 + v) + pf)
template <int W, int NT>
__device__ void dgrad_mma_slab(int slab, const bf16* __restrict__ dout,
                               const bf16* __restrict__ z, const float* __restrict__ stats,
                               const float* __restrict__ bsums, const bf16* __restrict__ wkd,
                               bf16* __restrict__ dx, const Plan& p, unsigned char* smem) {
  constexpr int WN = W / (8 * NT), HS = halo_stride(W), KSPT = tap_cols(W) / 16;
  const int ws = 16 * p.sk + 8;
  bf16* wsm = reinterpret_cast<bf16*>(smem);
  bf16* dp = reinterpret_cast<bf16*>(smem + mma_weight_bytes(p));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int wm_idx = warp / WN, wn_idx = warp % WN;
  const int rows = p.tt * p.tf, chan = p.split * W;
  int rowoff[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = imin(wm_idx * 32 + mt * 16 + lane % 16, rows - 1);
    rowoff[mt] = ((r / p.tf) * (p.tf + 1) + r % p.tf) * HS + (lane / 16) * 8;
  }
  const int nbase = wn_idx * NT * 8 * ws;
  const uint32_t pbase = smem_u32(dp);
  auto toff_of = [&](int slot) {
    return (((0x68 >> slot) & 1) * (p.tf + 1) + ((0xA2 >> slot) & 1)) * HS;
  };
  int grp, b, first, end;
  slab_of(p, slab, &grp, &b, &first, &end);
  if (p.ring == 1) {
    load_wslot<W>(wsm, wkd, grp, 0, 0, p);
    cp_async_commit();
  }
  for (int tile = first; tile < end; ++tile) {
    int t0, f0;
    tile_origin(p, tile, &t0, &f0);
    if (p.ring == 2) {
      load_wslot<W>(wsm, wkd, grp, 0, 0, p);
      cp_async_commit();
    }
    stage_dz<bf16, 8>(dout, z, stats, bsums, dp, p, b, grp, t0, f0);
    cp_async_wait_all();
    __syncthreads();
    for (int cls = 0; cls < 4; ++cls) {
      const int pt = cls / 2, pf = cls % 2;
      float acc[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      const int s0 = cls == 0 ? 0 : 2 * cls - 1, s1 = cls == 3 ? 9 : 2 * cls + 1;
      mma_ksteps<W, NT>(acc, pbase, rowoff, wsm, wkd, grp, s0 * KSPT, s1 * KSPT, p, nbase, lane,
                        toff_of);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = (wn_idx * NT + nt) * 8 + 2 * tg;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm_idx * 32 + mt * 16 + g + 8 * h;
            if (r >= rows) continue;
            const int t = 2 * (t0 + r / p.tf) + pt, f = 2 * (f0 + r % p.tf) + pf;
            if (t >= p.tlen || f >= p.flen) continue;
            *reinterpret_cast<__nv_bfloat162*>(
                dx + ((static_cast<long long>(b) * p.tlen + t) * p.flen + f) * chan + grp * W +
                co) = __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          }
      }
    }
    __syncthreads();  // every warp is done with the dz patch and the weight buffers
  }
}

// The mma design's weight gradient, CTA item = (group, chunk, split):
// C[(tap, c)][n] = sum over the tiles' positions r of x_patch(r, tap)[c]
// dz[r][n], the tile's positions the K dimension in k steps of 16. A (rows
// (tap, c), K = r) by ldmatrix.trans out of the x patch, whose rows are
// positions; B (K = r, n) by ldmatrix.trans out of the dz patch; positions
// past the tile read a zero dz row. A warp: WMT m tiles of one (tap, 16
// channels) each, all w / 8 n tiles. Partials by split as the FMA design's,
// rows (m tile, row) of the chunk.
template <int W>
__device__ void wgrad_mma_item(int item, const bf16* __restrict__ x,
                               const bf16* __restrict__ dout, const bf16* __restrict__ z,
                               const float* __restrict__ stats, const float* __restrict__ bsums,
                               bf16* __restrict__ dweight, float* __restrict__ wpart,
                               unsigned int* tickets, const Plan& p, unsigned char* smem) {
  constexpr int HS = halo_stride(W), CB = (W + 15) / 16, NTL = W / 8;
  // the CTA's warps (mma_threads / 32: 4 at w <= 64, 8 at 96, 6 at 192)
  constexpr int MTW = wg_wmt(W, W <= 64 ? 4 : W == 96 ? 8 : 6);
  const int pf_n = 2 * p.tf + 1, rows = p.tt * p.tf, ksteps = wg_ksteps(p);
  const int grp = item / (p.nchunks * p.nsplit), chunk = item / p.nsplit % p.nchunks;
  const int split = item % p.nsplit;
  bf16* xp = reinterpret_cast<bf16*>(smem);
  bf16* dp = reinterpret_cast<bf16*>(smem + xpatch_bytes(p, 2));
  int* rows_x = reinterpret_cast<int*>(smem + xpatch_bytes(p, 2) + wg_dpatch_bytes(p));
  int* rows_d = rows_x + 16 * ksteps;
  const int dzero = (p.tt + 1) * (p.tf + 1) * HS;
  for (int i = threadIdx.x; i < 16 * ksteps; i += blockDim.x) {
    rows_x[i] = i < rows ? (2 * (i / p.tf) * pf_n + i % p.tf) * HS : 0;
    rows_d[i] = i < rows ? ((i / p.tf) * (p.tf + 1) + i % p.tf) * HS : dzero;
  }
  for (int i = threadIdx.x; i < HS; i += blockDim.x) dp[dzero + i] = vsv::from_f<bf16>(0.f);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
  const int warps = blockDim.x / 32, cm = warps * MTW;
  // this warp's m tiles: (tap, channel block) and their x patch offsets
  int xo[MTW];
  bool mv[MTW];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi) {
    const int mt = chunk * cm + warp * MTW + mi;
    mv[mi] = mt < wg_mtiles(W);
    int cc = (mt % CB) * 16 + ((lane >> 3) & 1) * 8;
    if (cc >= W) cc -= 8;  // w = 8: the pad rows read the real channels again (discarded)
    xo[mi] = mv[mi] ? xtap(mt / CB, pf_n, p.tf, HS) + cc : 0;
  }
  float acc[MTW][NTL][4];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
  const uint32_t xbase = smem_u32(xp), dbase = smem_u32(dp);
  const long long ntiles = static_cast<long long>(p.batch) * p.tiles;
  const int first = static_cast<int>(ntiles * split / p.nsplit);
  const int end = static_cast<int>(ntiles * (split + 1) / p.nsplit);
  for (int tile = first; tile < end; ++tile) {
    const int b = tile / p.tiles;
    int t0, f0;
    tile_origin(p, tile % p.tiles, &t0, &f0);
    __syncthreads();  // the previous tile's patches are free (and the tables written)
    stage_x<bf16, true>(x, xp, p, b, grp, t0, f0);
    cp_async_commit();
    stage_dz<bf16, 8>(dout, z, stats, bsums, dp, p, b, grp, t0, f0);
    cp_async_wait_all();
    __syncthreads();
    for (int ks = 0; ks < ksteps; ++ks) {
      const int rb = 16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int ra = 16 * ks + (lane >> 4) * 8 + (lane & 7);
      uint32_t bq[(NTL + 1) / 2][4];
      if constexpr (NTL == 1) {
        ldmatrix_x2_trans(bq[0], dbase + 2 * rows_d[rb]);
      } else {
#pragma unroll
        for (int np = 0; np < NTL / 2; ++np)
          ldmatrix_x4_trans(bq[np], dbase + 2 * (rows_d[rb] + 16 * np + (lane >> 4) * 8));
      }
      const int xr = rows_x[ra];
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        if (!mv[mi]) continue;
        uint32_t af[4];
        ldmatrix_x4_trans(af, xbase + 2 * (xr + xo[mi]));
        if constexpr (NTL == 1) {
          mma_bf16_16816(acc[mi][0], af, bq[0]);
        } else {
#pragma unroll
          for (int np = 0; np < NTL / 2; ++np) {
            mma_bf16_16816(acc[mi][2 * np], af, bq[np]);
            mma_bf16_16816(acc[mi][2 * np + 1], af, bq[np] + 2);
          }
        }
      }
    }
  }
  const long long pcw = static_cast<long long>(p.pc) * W;
  const long long cbase = static_cast<long long>(grp * p.nchunks + chunk) * p.nsplit;
  float* mine = wpart + (cbase + split) * pcw;
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi) {
    if (!mv[mi]) continue;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pl = (warp * MTW + mi) * 16 + g + 8 * h, n = nt * 8 + 2 * tg;
        mine[pl * W + n] = acc[mi][nt][2 * h];
        mine[pl * W + n + 1] = acc[mi][nt][2 * h + 1];
      }
  }
  if (!last_to_arrive(tickets + grp * p.nchunks + chunk, p.nsplit)) return;
  for (long long idx = threadIdx.x; idx < pcw; idx += blockDim.x) {
    const int pl = static_cast<int>(idx / W), n = static_cast<int>(idx % W);
    const int mt = chunk * cm + pl / 16, c = (mt % CB) * 16 + pl % 16;
    if (mt >= wg_mtiles(W) || c >= W) continue;
    float s = 0.f;
    for (int sp = 0; sp < p.nsplit; ++sp) s += __ldcg(wpart + (cbase + sp) * pcw + idx);
    dweight[((static_cast<long long>(grp) * W + n) * W + c) * 9 + mt / CB] = vsv::from_f<bf16>(s);
  }
}

template <int W, int NT>
__global__ void __launch_bounds__(256) grad_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dout, const bf16* __restrict__ z,
    const bf16* __restrict__ wkd, bf16* __restrict__ dx, bf16* __restrict__ dweight, Plan p,
    GradArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blk = blockIdx.x;
  if (blk < p.nwgrad) {
    wgrad_mma_item<W>(blk, x, dout, z, a.stats, a.bsums, dweight, a.wpart, a.tickets, p, smem);
  } else if (blk < p.nwgrad + p.nconv) {
    dgrad_mma_slab<W, NT>(blk - p.nwgrad, dout, z, a.stats, a.bsums, wkd, dx, p, smem);
  } else {
    pool_bwd_items<bf16, 8>(dout, dx, p,
                            (blk - p.nwgrad - p.nconv) * static_cast<long long>(blockDim.x) +
                                threadIdx.x,
                            static_cast<long long>(p.pool_ctas) * blockDim.x);
  }
}

// ---------------------------------------------------------------------------
// finish and bwd_stats: element-wise over z, V channels a thread
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kStatThreads) finish_kernel(const T* __restrict__ z,
                                                              const float* __restrict__ stats,
                                                              T* __restrict__ out, Plan p) {
  const int w = p.width, vecs = w / V, chan = p.split * w, gw = p.groups * w;
  const long long n = static_cast<long long>(p.ng) * p.batch * p.npos * vecs;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % vecs) * V;
    const long long q = i / vecs, pos = q % p.npos, gb = q / p.npos;
    const int b = static_cast<int>(gb % p.batch), grp = static_cast<int>(gb / p.batch);
    const float* st = stats + static_cast<long long>(grp) * 3 * gw + (b / p.bpg) * w + c;
    float v[V];
    load_v<T, V>(z + q * w + c, v);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = fmaxf(bn_v(v[e], st[e], st[gw + e]), 0.f);
    store_v<T, V>(out + (static_cast<long long>(b) * p.npos + pos) * chan + grp * w + c, v);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kStatThreads) bwd_stats_kernel(
    const T* __restrict__ dout, const T* __restrict__ z, const float* __restrict__ stats,
    float* __restrict__ bsums, float* __restrict__ part, unsigned int* ticket, Plan p) {
  __shared__ float red[kStatThreads * 2 * V];
  const int w = p.width, vecs = w / V, chan = p.split * w, gw = p.groups * w;
  const int slab = blockIdx.x, grp = slab / (p.batch * p.kstat), b = slab / p.kstat % p.batch;
  const int r = slab % p.kstat;
  const long long first = p.npos * r / p.kstat, end = p.npos * (r + 1) / p.kstat;
  const int tid = threadIdx.x, vec = tid % vecs, p0 = tid / vecs, pstride = blockDim.x / vecs;
  const bool active = p0 < pstride;
  const int c = vec * V;
  const float* st = stats + static_cast<long long>(grp) * 3 * gw + (b / p.bpg) * w + c;
  float m[V], rs[V], sd[V], sx[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = st[e];
    rs[e] = st[gw + e];
    sd[e] = sx[e] = 0.f;
  }
  if (active) {
    for (long long q = first + p0; q < end; q += pstride) {
      float zv[V], dv[V];
      load_v<T, V>(z + ((static_cast<long long>(grp) * p.batch + b) * p.npos + q) * w + c, zv);
      load_v<T, V>(dout + (static_cast<long long>(b) * p.npos + q) * chan + grp * w + c, dv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = bn_v(zv[e], m[e], rs[e]);
        const float d = vsv::round_to<T>(v) > 0.f ? dv[e] : 0.f;
        sd[e] += d;
        sx[e] += d * v;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    red[(2 * tid) * V + e] = active ? sd[e] : 0.f;
    red[(2 * tid + 1) * V + e] = active ? sx[e] : 0.f;
  }
  __syncthreads();
  float* mine = part + static_cast<long long>(slab) * 2 * w;
  for (int n = tid; n < w; n += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < pstride; ++q) {
      const int th = q * vecs + n / V;
      t1 += red[(2 * th) * V + n % V];
      t2 += red[(2 * th + 1) * V + n % V];
    }
    mine[n] = t1;
    mine[w + n] = t2;
  }
  if (last_to_arrive(ticket, p.nstat))
    collapse<false>(part, p.kstat, p, bsums, nullptr, 0.f, 0.f, 0.f, 0.f);
}

// threads a CTA and CTAs of the element-wise launches
inline unsigned elementwise_grid(long long n) {
  return static_cast<unsigned>(std::min<long long>((n + kStatThreads - 1) / kStatThreads, 4096));
}

template <typename K>
int set_smem(K kernel, long long smem) {
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

}  // namespace

// K11, the forward's conv launch (see the top of the file). dtype: 0 =
// float32, 1 = bfloat16. plan: 17 host ints (models/res2net.py:
// stride2_train_plan, _stride2_train_ints). x (B, T, F, s w) channels-last;
// wk: "mma" (s-1, w, 9 tap_cols(w)) bf16, row n of group i its output
// channel's taps, each tap's w input channels zero-padded to tap_cols;
// "fma" (s-1, 9, w, w) [group][tap][c][n]. z (s-1, B, T', F', w) written;
// stats (s-1, 3, G, w) float32 written (mean, rstd, var); running: a host
// array of 2 (s-1) device pointers (each group's running mean, then
// variance), or null for no update; out (B, T', F', s w) channels-last (the
// last group's slice written here, the others by _finish); part: nconv * 2 w
// floats, ticket one int (zero, left zero). smem: the plan's shared memory
// (refused where it differs from the layout's: vsv::kPlanMismatch).
extern "C" int split_stride2_train_fwd(int dtype, const int* plan, const void* x, const void* wk,
                                       void* z, float* stats, const void* const* running,
                                       void* out, float* part, unsigned int* ticket, float eps,
                                       float momentum, float upd_mean, float upd_var,
                                       long long smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(plan, &p) || (dtype != 0 && dtype != 1) || (p.design == 1 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int item = dtype == 1 ? 2 : 4;
  if (smem != fwd_smem(p, item)) return vsv::kPlanMismatch;
  FwdArgs a{part, ticket, stats, {}, running != nullptr, eps, momentum, upd_mean, upd_var};
  if (running != nullptr)
    for (int i = 0; i < p.ng; ++i) {
      a.run.mean[i] = static_cast<float*>(const_cast<void*>(running[i]));
      a.run.var[i] = static_cast<float*>(const_cast<void*>(running[p.ng + i]));
    }
  const unsigned grid = static_cast<unsigned>(p.nconv + p.pool_ctas);
  const int w = p.width;
  int err = 0;
#define VSV_LAUNCH(KERNEL, T)                                                                  \
  do {                                                                                         \
    err = set_smem(KERNEL, smem);                                                              \
    if (err) return err;                                                                       \
    KERNEL<<<grid, p.threads, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(wk),  \
                                         static_cast<T*>(z), static_cast<T*>(out), p, a);      \
  } while (0)
  if (p.design == 1) {
    if (!aligned16(x) || !aligned16(wk) || !aligned16(z) || !aligned16(out))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (w) {
      case 8: VSV_LAUNCH((fwd_mma_kernel<8, 1>), bf16); break;
      case 16: VSV_LAUNCH((fwd_mma_kernel<16, 2>), bf16); break;
      case 32: VSV_LAUNCH((fwd_mma_kernel<32, 4>), bf16); break;
      case 48: VSV_LAUNCH((fwd_mma_kernel<48, 6>), bf16); break;
      case 64: VSV_LAUNCH((fwd_mma_kernel<64, 8>), bf16); break;
      case 96: VSV_LAUNCH((fwd_mma_kernel<96, 6>), bf16); break;
      case 192: VSV_LAUNCH((fwd_mma_kernel<192, 8>), bf16); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    if (w % 4 == 0 && aligned16(x) && aligned16(out)) VSV_LAUNCH((fwd_fma_kernel<float, 4, 4>), float);
    else if (w % 4 == 0) VSV_LAUNCH((fwd_fma_kernel<float, 4, 1>), float);
    else VSV_LAUNCH((fwd_fma_kernel<float, 1, 1>), float);
  } else {
    if (w % 8 == 0 && aligned16(x) && aligned16(out)) VSV_LAUNCH((fwd_fma_kernel<bf16, 4, 8>), bf16);
    else if (w % 4 == 0) VSV_LAUNCH((fwd_fma_kernel<bf16, 4, 1>), bf16);
    else VSV_LAUNCH((fwd_fma_kernel<bf16, 1, 1>), bf16);
  }
#undef VSV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// K11, the forward's second launch: y_i = relu((z_i - mean) * rstd) into the
// output's s-1 group slices. z, stats and out as split_stride2_train_fwd's.
extern "C" int split_stride2_train_finish(int dtype, const int* plan, const void* z,
                                          const float* stats, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(plan, &p) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = p.width;
  const bool vec = aligned16(z) && aligned16(out) && w % (dtype == 1 ? 8 : 4) == 0;
  const long long n = static_cast<long long>(p.ng) * p.batch * p.npos * w;
  if (dtype == 1 && vec)
    finish_kernel<bf16, 8><<<elementwise_grid(n / 8), kStatThreads, 0, s>>>(
        static_cast<const bf16*>(z), stats, static_cast<bf16*>(out), p);
  else if (dtype == 1)
    finish_kernel<bf16, 1><<<elementwise_grid(n), kStatThreads, 0, s>>>(
        static_cast<const bf16*>(z), stats, static_cast<bf16*>(out), p);
  else if (vec)
    finish_kernel<float, 4><<<elementwise_grid(n / 4), kStatThreads, 0, s>>>(
        static_cast<const float*>(z), stats, static_cast<float*>(out), p);
  else
    finish_kernel<float, 1><<<elementwise_grid(n), kStatThreads, 0, s>>>(
        static_cast<const float*>(z), stats, static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// K11b, the backward's first launch: mean(d) and mean(d xhat) per (group,
// BN group, channel) into bsums (s-1, 2, G, w). dout (B, T', F', s w)
// channels-last; z, stats as the forward's; part: nstat * 2 w floats,
// ticket one int (zero, left zero).
extern "C" int split_stride2_train_bwd_stats(int dtype, const int* plan, const void* dout,
                                             const void* z, const float* stats, float* bsums,
                                             float* part, unsigned int* ticket, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(plan, &p) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = p.width;
  const bool vec = aligned16(z) && aligned16(dout) && w % (dtype == 1 ? 8 : 4) == 0;
  const unsigned grid = static_cast<unsigned>(p.nstat);
  if (dtype == 1 && vec)
    bwd_stats_kernel<bf16, 8><<<grid, kStatThreads, 0, s>>>(
        static_cast<const bf16*>(dout), static_cast<const bf16*>(z), stats, bsums, part, ticket, p);
  else if (dtype == 1)
    bwd_stats_kernel<bf16, 1><<<grid, kStatThreads, 0, s>>>(
        static_cast<const bf16*>(dout), static_cast<const bf16*>(z), stats, bsums, part, ticket, p);
  else if (vec)
    bwd_stats_kernel<float, 4><<<grid, kStatThreads, 0, s>>>(
        static_cast<const float*>(dout), static_cast<const float*>(z), stats, bsums, part, ticket,
        p);
  else
    bwd_stats_kernel<float, 1><<<grid, kStatThreads, 0, s>>>(
        static_cast<const float*>(dout), static_cast<const float*>(z), stats, bsums, part, ticket,
        p);
  return static_cast<int>(cudaGetLastError());
}

// K11b, the backward's second launch: dx (B, T, F, s w) channels-last and
// dweight (s-1) w x w x 3 x 3 (OIHW) in the dtype, both written whole. x,
// dout, z, stats, bsums as above; wkd: "mma" (s-1, w, 9 tap_cols(w)) bf16,
// row c of group i its input channel's transposed taps (K = slot tap_cols +
// n), the tap slots in class order (1,1) (1,0) (1,2) (0,1) (2,1) (0,0) (0,2)
// (2,0) (2,2); "fma" (s-1, 9, w, w) [group][slot][n][c], the same order.
// wpart: nwgrad pc w floats; tickets: (s-1) nchunks ints (zero, left zero).
extern "C" int split_stride2_train_bwd_grad(int dtype, const int* plan, const void* x,
                                            const void* dout, const void* z, const float* stats,
                                            const float* bsums, const void* wkd, void* dx,
                                            void* dweight, float* wpart, unsigned int* tickets,
                                            long long smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(plan, &p) || (dtype != 0 && dtype != 1) || (p.design == 1 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int item = dtype == 1 ? 2 : 4;
  if (smem != grad_smem(p, item)) return vsv::kPlanMismatch;
  GradArgs a{stats, bsums, wpart, tickets};
  const unsigned grid = static_cast<unsigned>(p.nwgrad + p.nconv + p.pool_ctas);
  const int w = p.width;
  int err = 0;
#define VSV_LAUNCH(KERNEL, T)                                                                  \
  do {                                                                                         \
    err = set_smem(KERNEL, smem);                                                              \
    if (err) return err;                                                                       \
    KERNEL<<<grid, p.threads, smem, s>>>(                                                      \
        static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const T*>(z),       \
        static_cast<const T*>(wkd), static_cast<T*>(dx), static_cast<T*>(dweight), p, a);      \
  } while (0)
  if (p.design == 1) {
    if (!aligned16(x) || !aligned16(dout) || !aligned16(z) || !aligned16(wkd) || !aligned16(dx))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (w) {
      case 8: VSV_LAUNCH((grad_mma_kernel<8, 1>), bf16); break;
      case 16: VSV_LAUNCH((grad_mma_kernel<16, 2>), bf16); break;
      case 32: VSV_LAUNCH((grad_mma_kernel<32, 4>), bf16); break;
      case 48: VSV_LAUNCH((grad_mma_kernel<48, 6>), bf16); break;
      case 64: VSV_LAUNCH((grad_mma_kernel<64, 8>), bf16); break;
      case 96: VSV_LAUNCH((grad_mma_kernel<96, 6>), bf16); break;
      case 192: VSV_LAUNCH((grad_mma_kernel<192, 8>), bf16); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    if (w % 4 == 0 && aligned16(dout) && aligned16(dx)) VSV_LAUNCH((grad_fma_kernel<float, 4, 4>), float);
    else if (w % 4 == 0) VSV_LAUNCH((grad_fma_kernel<float, 4, 1>), float);
    else VSV_LAUNCH((grad_fma_kernel<float, 1, 1>), float);
  } else {
    if (w % 8 == 0 && aligned16(dout) && aligned16(dx)) VSV_LAUNCH((grad_fma_kernel<bf16, 4, 8>), bf16);
    else if (w % 4 == 0) VSV_LAUNCH((grad_fma_kernel<bf16, 4, 1>), bf16);
    else VSV_LAUNCH((grad_fma_kernel<bf16, 1, 1>), bf16);
  }
#undef VSV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
