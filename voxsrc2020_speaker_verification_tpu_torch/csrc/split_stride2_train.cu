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
// avg_pool_3x3 rounds (bit-equal to it). W is read as the module holds it,
// OIHW ((s-1) w, w, 3, 3): each CTA stages it into its own layout.
//
// Forward (K11), two launches a stage:
//   split_stride2_train_fwd: the conv's CTAs write z (rounded, saved for
//     the backward) and partial sums of z and z^2 per channel. The last
//     CTA to arrive (an integer ticket, no float atomics) adds the
//     partials in a fixed order per (BN group, channel), publishes mean,
//     rstd and var, and applies the running update (momentum, Bessel
//     n/(n-1), n the output's rows of a BN group) unless its pointers are
//     null. Which positions a partial holds is a function
//     of the shape alone (the plan), so the statistics are the same bits on
//     every card.
//   split_stride2_train_finish: y_i = relu((z_i - mean) * rstd) into the
//     output's s-1 group slices, and the average pool of the last group.
// Backward (K11b), two launches a stage:
//   split_stride2_train_bwd_stats: d = dout * [y > 0] (y recomputed from z
//     by the forward's own expression, so the relu decision agrees bit for
//     bit) and its sums d and d * xhat per (BN group, channel), by slab
//     partials and a ticket: mean(d), mean(d xhat); CTAs of their own
//     write dx of the tail, the pool's backward: dout / 9 gathered from the
//     1, 2 or 4 windows that cover each input position.
//   split_stride2_train_bwd_grad: dz = rstd (d - mean(d) - xhat
//     mean(d xhat)), rounded to the dtype; dx of groups < s-1, the
//     transposed stride-2 conv written as a gather by input parity: with
//     the pad of 1, an even input index takes tap 1 of output t/2, an odd
//     one tap 0 of (t+1)/2 and tap 2 of (t-1)/2, so the (even, even),
//     (even, odd), (odd, even) and (odd, odd) inputs of a tile are four
//     dense convs of 1, 2, 2 and 4 taps over the tile's dz patch (one more
//     output row and column), nine taps in all: no atomics, no padded
//     buffer; dW per group, the sum over output positions of
//     x_pad(2t'+kt, 2f'+kf) dz, split over CTAs whose partials the last to
//     arrive (a ticket) adds in split order (the split count a function of
//     the shape alone, so dW is the same bits on every run and card).
//
// Two designs (the plan, models/res2net.py:stride2_train_plan):
// * "mma" (bfloat16 at the registered stride-2 widths 8, 16, 32, 48, 64,
//   96, 192), mma.sync m16n8k16 with fp32 accumulation, A and B by ldmatrix
//   out of shared memory. Forward: persistent CTAs, each a (group, slice of
//   the output channels, run of the group's (sample, tile) items); the
//   slice's weights load once a CTA and stay resident (the whole group's up
//   to w = 64; half at 96; a quarter at 192); the x patch of each tile (with
//   the padding implicit and the even and odd columns apart) streams
//   through a two-stage cp.async ring, tile i + 1 landing while tile i
//   computes (at w = 192 a stage is a quarter of the input channels). A
//   CTA's z sums go into one partial per BN group its run touches (at most
//   two). Grad: persistent CTAs, each a (group, chunk of dW's (tap, 16
//   channels) m tiles, run of tiles); each tile's x patch and raw dout and z
//   arrive on a two-stage cp.async ring, the CTA turns dout and z into the
//   tile's dz patch once (by dz_of, the forward's relu decision), and the
//   one dz patch feeds both the CTA's dW chunk (accumulated in registers
//   across its tiles: both operands by ldmatrix.trans) and the dgrad (its
//   dgrad weights resident: the tiles of a run shared out over the chunks,
//   or at w = 96 / 192 a 16-channel slice of dx a chunk).
// * "fma" (float32, and bfloat16 at other widths): CTAs of one sample's
//   tiles on CUDA cores, a thread 8 rows by 4 (or 1) channels, a tap's
//   weights staged at a time; the weight gradient by CTAs of (chunk of
//   (tap, channel) rows, split of the tiles). float32 stays off the tensor
//   cores: TF32 would cost 13 mantissa bits the plain version keeps.
//
// Bound on the card: bytes. Forward: x read and z written (the conv), z
// read and the output written; backward: dout and z read twice (the sums,
// then dz), x read, dx written. The convs are 18 w^2 (s-1) flops a
// position three times over, below Hopper's ridge at these widths.
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
constexpr int kMaxUpt = 8;        // (tap, channel) rows a thread of the FMA weight gradient
constexpr int kRedFloats = 2 * kFmaThreads * 4;  // the FMA forward's per-thread sums

// The phase profile (a build with -DVSV_K11_PROF, scripts/profile_k11.py):
// thread 0 of each CTA laps clock64 into its role's phases and adds them,
// once at its end, to g_k11_prof[role][slot]. Without the flag every call
// is empty.
enum { kRoleFwd, kRolePool, kRoleStats, kRoleDgrad, kRoleWgrad, kRoleGrad, kRolePoolBwd,
       kProfRoles };
enum { kPhStage, kPhMma, kPhDgrad, kPhEpilogue, kPhSums, kPhReduce, kPhProduce,
       kPhProduceWait, kPhPatches, kPhCtas, kProfSlots };
#ifdef VSV_K11_PROF
__device__ unsigned long long g_k11_prof[kProfRoles * kProfSlots];
struct Prof {
  unsigned long long v[kProfSlots];
  long long t;
  bool on;
  __device__ Prof() : on(threadIdx.x == 0) {
    for (int i = 0; i < kProfSlots; ++i) v[i] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void lap(int slot) {
    const long long n = clock64();
    v[slot] += n - t;
    t = n;
  }
  __device__ __forceinline__ void count(int slot) { ++v[slot]; }
  __device__ void flush(int role) {
    if (!on) return;
    v[kPhCtas] = 1;
    for (int i = 0; i < kProfSlots; ++i) atomicAdd(&g_k11_prof[role * kProfSlots + i], v[i]);
  }
};
#else
struct Prof {
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void count(int) {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

// The running statistics, passed by value: the BN modules' own tensors
struct Running {
  float* mean[kMaxGroups];
  float* var[kMaxGroups];
};

struct Plan {
  // from the caller (models/res2net.py:_stride2_train_ints): 20 ints
  int batch, tlen, flen, split, width, groups, design, tt, tf, k, kstat, pool_ctas, nsplit,
      upt, nsl, nkc, threads, gtt, gthreads, nds;
  // derived
  int tout, fout, tiles_f, tiles, gtiles, bpg, ng, nconv, nstat, xs, nb, pg, pc, nchunks, nwgrad;
  long long npos;
};

__host__ __device__ inline long long align16(long long v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// bf16 row stride of a staged position in the mma design: w plus a pad
// that makes it an odd number of 16-byte units (models/res2net.py:
// _halo_stride)
__host__ __device__ constexpr int halo_stride(int width) {
  return width + 2 * ((4 - (width / 2) % 8 + 8) % 8);
}

// K columns of a tap in the mma weights: w padded to whole k steps of 16
__host__ __device__ constexpr int tap_cols(int width) { return (width + 15) / 16 * 16; }

__host__ __device__ constexpr bool mma_width(int w) {
  return w == 8 || w == 16 || w == 32 || w == 48 || w == 64 || w == 96 || w == 192;
}
// The mma forward (models/res2net.py:_S2T_FWD_SLICES): slices of a group's
// output channels (a CTA's weights) and chunks of its input channels (a
// ring stage)
__host__ __device__ constexpr int fwd_nsl(int w) { return w == 96 ? 2 : w == 192 ? 4 : 1; }
__host__ __device__ constexpr int fwd_nkc(int w) { return w == 192 ? 4 : 1; }
// and warps across a slice (each 8 NT channels), WM down the tile's rows
__host__ __device__ constexpr int fwd_wn(int w) { return w / fwd_nsl(w) >= 32 ? 2 : 1; }
// The mma grad launch (models/res2net.py:_S2T_GRAD_WARPS): warps, slices of
// dx's channels (a chunk's dgrad weights; 1: the whole width, the tiles
// shared out over the chunks), warps across a slice
__host__ __device__ constexpr int grad_warps(int w) { return w <= 16 ? 4 : 8; }
__host__ __device__ constexpr int grad_nds(int w) { return w == 96 ? 6 : w == 192 ? 12 : 1; }
__host__ __device__ constexpr int grad_wnd(int w) { return w <= 16 ? 1 : 2; }
// The weight gradient's m tiles of (tap, 16 input channels), 9 ceil(w / 16);
// a warp's upt of them (at most 96 accumulator registers a thread at w <=
// 64, 64 above, w / 2 an m tile, or one), a chunk the CTA's warps', chunk c
// the m tiles c, c + nchunks, ...
__host__ __device__ constexpr int wg_mtiles(int w) { return 9 * ((w + 15) / 16); }
__host__ __device__ constexpr int wg_nchunks(int w) {
  return cdiv(wg_mtiles(w), grad_warps(w) * imin(cdiv(wg_mtiles(w), grad_warps(w)),
                                                 imax(1, (w <= 64 ? 192 : 128) / w)));
}
__host__ __device__ constexpr int wg_upt(int w) {
  return cdiv(wg_mtiles(w), wg_nchunks(w) * grad_warps(w));
}

__host__ __device__ inline int fma_tn(int width) { return width % 4 == 0 ? 4 : 1; }

// Shared memory (models/res2net.py:_s2t_smem), in bytes
__host__ __device__ inline long long xpatch_bytes(const Plan& p, int item) {
  return align16(static_cast<long long>(2 * p.tt + 1) * (2 * p.tf + 1) * p.xs * item);
}
__host__ __device__ inline long long dpatch_bytes(const Plan& p, int item) {
  return align16(static_cast<long long>(p.tt + 1) * (p.tf + 1) * p.xs * item);
}
// mma forward: the slice's weights (rows of 9 tap_cols + 8), a ring stage
__host__ __device__ inline long long fwd_wbytes(int w) {
  return 2LL * (w / fwd_nsl(w)) * (9 * tap_cols(w) + 8);
}
__host__ __device__ inline long long fwd_stage_bytes(const Plan& p) {
  return align16(2LL * (2 * p.tt + 1) * (2 * p.tf + 1) * halo_stride(p.width / fwd_nkc(p.width)));
}
// mma grad: the dgrad slice's weights, a ring stage's x patch and raw dout
// and z, the dz patch with a zero row after it, the weight gradient's row
// tables (x and dz offsets of the tile's positions, whole k steps of 16),
// a BN group's mean, rstd, mean(d) and mean(d xhat) (4 w floats)
__host__ __device__ inline long long grad_wbytes(int w) {
  return 2LL * (w / grad_nds(w)) * (9 * tap_cols(w) + 8);
}
__host__ __device__ inline long long gx_bytes(const Plan& p) {
  return align16(2LL * (2 * p.gtt + 1) * (2 * p.tf + 1) * halo_stride(p.width));
}
__host__ __device__ inline long long graw_bytes(const Plan& p) {
  return align16(4LL * (p.gtt + 1) * (p.tf + 1) * p.width);
}
__host__ __device__ inline long long gdz_bytes(const Plan& p) {
  return align16(2LL * ((p.gtt + 1) * (p.tf + 1) + 1) * halo_stride(p.width));
}
__host__ __device__ inline int gksteps(const Plan& p) { return (p.gtt * p.tf + 15) / 16; }
inline long long fwd_smem(const Plan& p, int item) {
  if (p.design == 1)
    return fwd_wbytes(p.width) + 2 * fwd_stage_bytes(p) +
           8LL * (p.threads / 32 / fwd_wn(p.width)) * (p.width / fwd_nsl(p.width));
  return align16(4LL * p.width * p.width) + 4LL * kRedFloats + xpatch_bytes(p, item);
}
inline long long grad_smem(const Plan& p, int item) {
  if (p.design == 1)
    return grad_wbytes(p.width) + 2 * (gx_bytes(p) + graw_bytes(p)) + gdz_bytes(p) +
           2LL * 4 * 16 * gksteps(p) + 16LL * p.width;
  return std::max(xpatch_bytes(p, item) + dpatch_bytes(p, item),
                  align16(4LL * p.width * p.width) + dpatch_bytes(p, item));
}

bool make_plan(const int* a, Plan* p) {
  p->batch = a[0]; p->tlen = a[1]; p->flen = a[2]; p->split = a[3]; p->width = a[4];
  p->groups = a[5]; p->design = a[6]; p->tt = a[7]; p->tf = a[8]; p->k = a[9];
  p->kstat = a[10]; p->pool_ctas = a[11]; p->nsplit = a[12]; p->upt = a[13]; p->nsl = a[14];
  p->nkc = a[15]; p->threads = a[16]; p->gtt = a[17]; p->gthreads = a[18]; p->nds = a[19];
  const int w = p->width;
  if (p->batch < 1 || p->tlen < 1 || p->flen < 1 || p->split < 2 || p->split - 1 > kMaxGroups ||
      w < 1 || w > 256 || p->groups < 1 || p->batch % p->groups || p->tt < 1 || p->tf < 1 ||
      p->tf > 16 || p->gtt < 1 || p->k < 1 || p->kstat < 1 || p->pool_ctas < 1 ||
      p->nsplit < 1 || p->upt < 1 || p->threads < 32 || p->threads > 256 || p->threads % 32 ||
      p->gthreads < 32 || p->gthreads > 256 || p->gthreads % 32)
    return false;
  p->tout = (p->tlen - 1) / 2 + 1;
  p->fout = (p->flen - 1) / 2 + 1;
  p->npos = static_cast<long long>(p->tout) * p->fout;
  p->tiles_f = (p->fout + p->tf - 1) / p->tf;
  p->tiles = ((p->tout + p->tt - 1) / p->tt) * p->tiles_f;
  p->gtiles = ((p->tout + p->gtt - 1) / p->gtt) * p->tiles_f;
  p->bpg = p->batch / p->groups;
  p->ng = p->split - 1;
  if (p->kstat > p->npos) return false;
  const long long items = static_cast<long long>(p->batch) * p->tiles;
  if (p->design == 1) {
    // every CTA of the forward a run within two BN groups, every CTA a tile
    if (!mma_width(w) || p->nsl != fwd_nsl(w) || p->nkc != fwd_nkc(w) || p->nds != grad_nds(w) ||
        p->threads != 32 * fwd_wn(w) * cdiv(p->tt * p->tf, 32) || p->tt * p->tf > 128 ||
        p->gthreads != 32 * grad_warps(w) ||
        p->gtt * p->tf > 32 * (grad_warps(w) / grad_wnd(w)) || p->upt != wg_upt(w) ||
        p->k < p->groups || p->k > items ||
        p->nsplit > static_cast<long long>(p->batch) * p->gtiles)
      return false;
    p->xs = halo_stride(w);
    // a tile's z rows (forward) and dx rows (dgrad) are staged in a consumed
    // ring stage
    if (fwd_stage_bytes(*p) < 2LL * p->tt * p->tf * halo_stride(w / fwd_nsl(w)) ||
        gx_bytes(*p) < 8LL * p->gtt * p->tf * halo_stride(w / grad_nds(w)))
      return false;
    // and the collapse's table of the CTAs' runs in the ring
    if (2 * fwd_stage_bytes(*p) < 4LL * (2 * p->k + 2 * p->groups)) return false;
    p->nb = p->pg = 0;
    p->pc = grad_warps(w) * p->upt * 16;
    p->nchunks = wg_nchunks(w);
    p->nconv = p->ng * p->nsl * p->k;
  } else if (p->design == 0) {
    const int tn = fma_tn(w), nb = (w + tn - 1) / tn;
    if (p->threads != kFmaThreads || p->gthreads != kFmaThreads || nb > kFmaThreads ||
        p->upt > kMaxUpt || p->tt * p->tf > imin(128, (kFmaThreads / nb) * kFmaTm) ||
        p->nsl != 0 || p->nkc != 0 || p->nds != 0 || p->gtt != p->tt || p->k > p->tiles)
      return false;
    p->xs = w | 1;
    p->nb = (w + 3) / 4;
    p->pg = p->threads / p->nb;
    if (p->pg < 1) return false;
    p->pc = p->pg * p->upt;
    p->nchunks = (9 * w + p->pc - 1) / p->pc;
    p->nconv = p->ng * p->batch * p->k;
  } else {
    return false;
  }
  p->nstat = p->ng * p->batch * p->kstat;
  p->nwgrad = p->ng * p->nchunks * p->nsplit;
  if (static_cast<long long>(p->nwgrad) + p->nconv + p->nstat + p->pool_ctas > 0x7fffffffLL ||
      static_cast<long long>(p->batch) * p->npos * p->split * w > (1LL << 40) ||
      static_cast<long long>(p->tlen) * p->flen * p->split * w >= (1LL << 31))
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
// wait until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// The dgrad's tap slots in class order (models/res2net.py:_S2T_DGRAD_TAPS):
// (even, even) (1,1); (even, odd) (1,0) (1,2); (odd, even) (0,1) (2,1);
// (odd, odd) (0,0) (0,2) (2,0) (2,2). A slot's tap kt * 3 + kf and a tap's
// slot, a nibble each.
__host__ __device__ constexpr int slot_tap(int slot) {
  return static_cast<int>((0x862071534ULL >> (4 * slot)) & 0xF);
}
__host__ __device__ constexpr int tap_slot(int tap) {
  return static_cast<int>((0x847201635ULL >> (4 * tap)) & 0xF);
}
// A dgrad slot's offset in the dz patch (rows of tf + 1): one row down
// where kt = 0 (slots 3, 5, 6), one column where kf = 0 (slots 1, 5, 7)
__device__ __forceinline__ int dslot_off(int slot, int tf, int xs) {
  return (((0x68 >> slot) & 1) * (tf + 1) + ((0xA2 >> slot) & 1)) * xs;
}

// n / d by a multiply with ceil(2^32 / d), exact for 0 <= n, n d < 2^32 (a
// tile's and a patch's positions): the mma design's staging loops divide
// by the plan's tile widths
struct FastDiv {
  unsigned long long m;
  int d;
  __device__ explicit FastDiv(int d_)
      : m(((1ULL << 32) + d_ - 1) / static_cast<unsigned long long>(d_)), d(d_) {}
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>((static_cast<unsigned long long>(n) * m) >> 32);
  }
};

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

// The output tile `tile` of a sample, tiles of tt x tf: its first output
// row and column
__device__ __forceinline__ void tile_origin(const Plan& p, int tile, int tt, int* t0, int* f0) {
  *t0 = tile / p.tiles_f * tt;
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

// Stage the x patch of output tile (t0, f0) of sample b, group grp (the
// FMA design): input rows 2 t0 - 1 .. 2 t0 + 2 tt - 1, columns 2 f0 - 1 ..
// 2 f0 + 2 tf - 1, at (row pt, slot) of stride xs, zero outside the
// utterance, element by element
template <typename T>
__device__ void stage_x(const T* __restrict__ x, T* patch, const Plan& p, int b, int grp, int t0,
                        int f0) {
  const int w = p.width, pt_n = 2 * p.tt + 1, pf_n = 2 * p.tf + 1, chan = p.split * w;
  const int n = pt_n * pf_n * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int pos = i / w, c = i % w;
    const int pt = pos / pf_n, pf = pos % pf_n;
    const int t = 2 * t0 - 1 + pt, f = 2 * f0 - 1 + pf;
    const bool valid = t >= 0 && t < p.tlen && f >= 0 && f < p.flen;
    const long long src = (valid ? (static_cast<long long>(b) * p.tlen + t) * p.flen + f : 0) *
                              chan + grp * w + c;
    patch[(pt * pf_n + xslot(pf, p.tf)) * p.xs + c] = valid ? x[src] : vsv::from_f<T>(0.f);
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
__device__ void pool_fwd_item(const T* __restrict__ x, T* __restrict__ out, const Plan& p,
                              long long b, int ot, int of, int c) {
  const int chan = p.split * p.width, src = (p.split - 1) * p.width;
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
  store_v<T, V>(out + ((b * p.tout + ot) * p.fout + of) * chan + src + c, acc);
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
    const long long q = i / vecs, qf = q / p.flen, b = qf / p.tlen;
    const int c = static_cast<int>(i - q * vecs) * V;
    const int f = static_cast<int>(q - qf * p.flen), t = static_cast<int>(qf - b * p.tlen);
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


// The statistics' collapse by the last CTA to arrive: per (group, BN
// group, channel) the partials' sums in a fixed order (SUMS: s1, s2 of one
// (group, BN group, channel)), divided by the rows n of a BN group.
// FWD: mean, rstd = 1 / sqrt(var + eps), var = E[z^2] - mean^2 into stats
// (group, 3, G, w), then the running update unless run is null; else mean(d)
// and mean(d xhat) into bsums (group, 2, G, w).
template <bool FWD, typename SUMS>
__device__ void collapse(const SUMS& sums, const Plan& p, float* out, const Running* run,
                         float eps, float mom, float upd_mean, float upd_var) {
  const int w = p.width, gw = p.groups * w;
  const float n = static_cast<float>(static_cast<long long>(p.bpg) * p.npos);
  for (int idx = threadIdx.x; idx < p.ng * gw; idx += blockDim.x) {
    const int grp = idx / gw, g = idx / w % p.groups, c = idx % w;
    float s1 = 0.f, s2 = 0.f;
    sums(grp, g, c, &s1, &s2);
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

// Slab partials part[slab][2][w], slab = (group * B + sample) * per + run:
// a BN group's samples in order, each sample's runs in order
struct SlabSums {
  const float* part;
  int per;
  const Plan* p;
  __device__ void operator()(int grp, int g, int c, float* s1, float* s2) const {
    // a BN group's slabs are consecutive: (grp B + g bpg) per onwards
    const float* q = part + ((static_cast<long long>(grp) * p->batch + g * p->bpg) * per) * 2 *
                                p->width + c;
    const int n = p->bpg * per;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      *s1 += __ldcg(q + static_cast<long long>(i) * 2 * p->width);
      *s2 += __ldcg(q + static_cast<long long>(i) * 2 * p->width + p->width);
    }
  }
};

// The mma forward's run [e0, e1) of the group's B tiles items of CTA j of k
// (its slices alike), and the first BN group it touches
__host__ __device__ inline void fwd_run(const Plan& p, int j, long long* e0, long long* e1) {
  const long long items = static_cast<long long>(p.batch) * p.tiles;
  *e0 = items * j / p.k;
  *e1 = items * (j + 1) / p.k;
}

// The mma forward's partials part[(group * k + j) * 2 + h][2][w]: CTA j's
// sums over its tiles in the h-th BN group its run touches; a BN group's
// CTAs in order. runs (fill_runs): [0, k) the first BN group each CTA's run
// touches, [k, 2k) the last, [2k, 2k + G) and [2k + G, 2k + 2G) the first
// and one past the last CTA whose run touches each BN group
struct RunSums {
  const float* part;
  const Plan* p;
  const int* runs;
  __device__ void operator()(int grp, int g, int c, float* s1, float* s2) const {
    const int lo = runs[2 * p->k + g], hi = runs[2 * p->k + p->groups + g];
#pragma unroll 4
    for (int j = lo; j < hi; ++j) {
      const float* q = part + ((static_cast<long long>(grp) * p->k + j) * 2 + (g - runs[j])) *
                                  2 * p->width + c;
      *s1 += __ldcg(q);
      *s2 += __ldcg(q + p->width);
    }
  }
};

// RunSums' table (2 k + 2 G ints) in shared memory, then a barrier
__device__ void fill_runs(const Plan& p, int* runs) {
  for (int j = threadIdx.x; j < p.k; j += blockDim.x) {
    long long e0, e1;
    fwd_run(p, j, &e0, &e1);
    runs[j] = static_cast<int>(e0 / p.tiles) / p.bpg;
    runs[p.k + j] = static_cast<int>((e1 - 1) / p.tiles) / p.bpg;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < p.groups; g += blockDim.x) {
    int lo = p.k, hi = 0;
    for (int j = 0; j < p.k; ++j)
      if (runs[j] <= g && g <= runs[p.k + j]) {
        lo = imin(lo, j);
        hi = j + 1;
      }
    runs[2 * p.k + g] = lo;
    runs[2 * p.k + p.groups + g] = hi;
  }
  __syncthreads();
}

// A conv slab of the FMA design: (group, sample, tiles [first, end))
__device__ __forceinline__ void slab_of(const Plan& p, int slab, int* grp, int* b, int* first,
                                        int* end) {
  *grp = slab / (p.batch * p.k);
  *b = slab / p.k % p.batch;
  const int r = slab % p.k;
  *first = p.tiles * r / p.k;
  *end = p.tiles * (r + 1) / p.k;
}

// ---------------------------------------------------------------------------
// "fma": the forward conv, the dgrad and the weight gradient on CUDA cores
// ---------------------------------------------------------------------------

// dW of group grp, (tap, input channel) rows [chunk pc, (chunk + 1) pc) of
// the 9 w (p = tap w + c), over the split's tiles, CTA item = (group,
// chunk, split). A thread: 4 output channels (n-block j) by upt rows (its
// pair group's), accumulating x patch values times dz; partials by split,
// the last split to arrive adds them in split order and writes dW in the
// dtype (OIHW).
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
    tile_origin(p, tile % p.tiles, p.tt, &t0, &f0);
    __syncthreads();  // the previous tile's patches are free
    stage_x<T>(x, xp, p, b, grp, t0, f0);
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

// Tap `tap` of group grp's OIHW weight into ws as floats, ws[k][m]: the
// conv's (k the input channel, m the output channel) or, DGRAD, the
// dgrad's (k the conv's output channel, m its input channel)
template <typename T, bool DGRAD>
__device__ __forceinline__ void stage_tap_weights(float* ws, const T* __restrict__ weight,
                                                  int grp, int tap, int w) {
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int k = i / w, m = i % w;
    const long long row = static_cast<long long>(grp) * w + (DGRAD ? k : m);
    ws[i] = vsv::to_f(weight[(row * w + (DGRAD ? m : k)) * 9 + tap]);
  }
}

struct FwdArgs {
  float* part;
  unsigned int* ticket;
  float* stats;
  Running run;
  bool update;
  float eps, mom, upd_mean, upd_var;
};

template <typename T, int TN>
__global__ void __launch_bounds__(kFmaThreads) fwd_fma_kernel(const T* __restrict__ x,
                                                              const T* __restrict__ weight,
                                                              T* __restrict__ z,
                                                              T* __restrict__ out, Plan p,
                                                              FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
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
    tile_origin(p, tile, p.tt, &t0, &f0);
    __syncthreads();
    stage_x<T>(x, xp, p, b, grp, t0, f0);
    float acc[kFmaTm][TN];
#pragma unroll
    for (int i = 0; i < kFmaTm; ++i)
#pragma unroll
      for (int e = 0; e < TN; ++e) acc[i][e] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      __syncthreads();  // the previous tap's weights are consumed
      stage_tap_weights<T, false>(ws, weight, grp, tap, w);
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
    collapse<true>(SlabSums{a.part, p.k, &p}, p, a.stats, a.update ? &a.run : nullptr, a.eps,
                   a.mom, a.upd_mean, a.upd_var);
}

// dgrad on CUDA cores, slab (group, sample, tiles): for each tile the dz
// patch, then the four parity classes, each over its tap slots
template <typename T, int TN>
__device__ void dgrad_fma_slab(int slab, const T* __restrict__ dout, const T* __restrict__ z,
                               const float* __restrict__ stats, const float* __restrict__ bsums,
                               const T* __restrict__ weight, T* __restrict__ dx, const Plan& p,
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
    tile_origin(p, tile, p.tt, &t0, &f0);
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
        stage_tap_weights<T, true>(ws, weight, grp, slot_tap(slot), w);
        __syncthreads();
        fma_tap<T, TN>(acc, dp, ws, rowoff, dslot_off(slot, p.tf, p.xs), w, nb, tm);
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

template <typename T, int TN>
__global__ void __launch_bounds__(kFmaThreads) grad_fma_kernel(
    const T* __restrict__ x, const T* __restrict__ dout, const T* __restrict__ z,
    const T* __restrict__ weight, T* __restrict__ dx, T* __restrict__ dweight, Plan p,
    GradArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blk = blockIdx.x;
  if (blk < p.nwgrad) {
    wgrad_item<T>(blk, x, dout, z, a.stats, a.bsums, dweight, a.wpart, a.tickets, p, smem);
  } else {
    dgrad_fma_slab<T, TN>(blk - p.nwgrad, dout, z, a.stats, a.bsums, weight, dx, p, smem);
  }
}

// ---------------------------------------------------------------------------
// "mma": persistent CTAs on mma.sync (bfloat16)
// ---------------------------------------------------------------------------

// One k step (16 K columns, step ks of a tap's CW) of a warp's 32 rows by 8
// NT channels: A rows from the patch at the lane's row offset plus the
// tap's, B from a weight buffer of row stride ws at column col
template <int CW, int NT>
__device__ __forceinline__ void mma_kstep(float (&acc)[2][NT][4], uint32_t pbase,
                                          const int (&rowoff)[2], int toff, int ks,
                                          uint32_t wbase, int ws, int col, int lane) {
  constexpr int C8 = CW / 8;
  int cc = 16 * ks;
  // a tap's pad chunk (odd C8) reads the last real chunk again, times the
  // zero weights
  if (C8 % 2 != 0 && cc + (lane / 16) * 8 >= CW) cc -= 8;
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

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// Eight bf16 of the OIHW weight at element offset off (16-byte aligned)
__device__ __forceinline__ void load8(const bf16* __restrict__ weight, long long off, bf16* h) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(weight + off));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[2 * e] = h2[e].x;
    h[2 * e + 1] = h2[e].y;
  }
}

// The conv weights of output channels [n0, n0 + WSL) of group grp from the
// OIHW weight into wsm: row n, K = tap * tap_cols + input channel (rows of
// 9 tap_cols + 8), each tap's pad columns zero. Plain loads: the caller's
// barrier publishes them.
template <int W, int WSL>
__device__ void load_conv_weights(bf16* wsm, const bf16* __restrict__ weight, int grp, int n0) {
  constexpr int KT = tap_cols(W), WS = 9 * KT + 8, V9 = 9 * W / 8;
  for (int i = threadIdx.x; i < WSL * V9; i += blockDim.x) {
    const int n = i / V9, v = i % V9;
    bf16 h[8];
    load8(weight, (static_cast<long long>(grp) * W + n0 + n) * W * 9 + 8 * v, h);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = 8 * v + e;  // c * 9 + tap
      wsm[n * WS + (idx % 9) * KT + idx / 9] = h[e];
    }
  }
  if constexpr (KT > W)
    for (int i = threadIdx.x; i < WSL * 9 * (KT - W); i += blockDim.x)
      wsm[(i / (9 * (KT - W))) * WS + (i / (KT - W) % 9) * KT + W + i % (KT - W)] =
          vsv::from_f<bf16>(0.f);
}

// The dgrad weights of input channels [c0, c0 + DSW) of group grp from the
// OIHW weight into wsm: row c, K = slot * tap_cols + the conv's output
// channel n, the slots in class order, each slot's pad columns zero
template <int W, int DSW>
__device__ void load_dgrad_weights(bf16* wsm, const bf16* __restrict__ weight, int grp, int c0) {
  constexpr int KT = tap_cols(W), WS = 9 * KT + 8, V9 = 9 * DSW / 8;
  for (int i = threadIdx.x; i < W * V9; i += blockDim.x) {
    const int n = i / V9, v = i % V9;
    bf16 h[8];
    load8(weight, ((static_cast<long long>(grp) * W + n) * W + c0) * 9 + 8 * v, h);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = 8 * v + e;  // (c - c0) * 9 + tap
      wsm[(idx / 9) * WS + tap_slot(idx % 9) * KT + n] = h[e];
    }
  }
  if constexpr (KT > W)
    for (int i = threadIdx.x; i < DSW * 9 * (KT - W); i += blockDim.x)
      wsm[(i / (9 * (KT - W))) * WS + (i / (KT - W) % 9) * KT + W + i % (KT - W)] =
          vsv::from_f<bf16>(0.f);
}

template <int W>
struct FwdCfg {
  static constexpr int NSL = fwd_nsl(W), NKC = fwd_nkc(W), WSL = W / NSL, CW = W / NKC;
  static constexpr int WN = fwd_wn(W), NT = WSL / (8 * WN), KT = tap_cols(W), WS = 9 * KT + 8;
  static constexpr int HS = halo_stride(CW);
  static constexpr int KSC = (CW + 15) / 16;  // k steps of a tap in a stage
  static constexpr int ZS = halo_stride(WSL);  // a z row in shared memory
};

// The CTA's sums of z and z^2 over a run of tiles inside one BN group into
// dst (its partial at the slice's channels; dst[w + n] the squares): over
// the 8 row lanes g by a fixed shuffle tree, then over the warps in order
template <int NT, int WSL, int WN>
__device__ void flush_sums(float (&s1)[NT][2], float (&s2)[NT][2], float* red, float* dst,
                           int w) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wm_n = blockDim.x / 32 / WN;
  const int wm = warp / WN, wn = warp % WN;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o *= 2) {
        s1[nt][e] += __shfl_xor_sync(0xffffffffu, s1[nt][e], o);
        s2[nt][e] += __shfl_xor_sync(0xffffffffu, s2[nt][e], o);
      }
      if (lane < 4) {
        const int co = (wn * NT + nt) * 8 + 2 * lane + e;
        red[(wm * 2) * WSL + co] = s1[nt][e];
        red[(wm * 2 + 1) * WSL + co] = s2[nt][e];
      }
      s1[nt][e] = s2[nt][e] = 0.f;
    }
  __syncthreads();
  for (int n = threadIdx.x; n < WSL; n += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int m = 0; m < wm_n; ++m) {
      t1 += red[(2 * m) * WSL + n];
      t2 += red[(2 * m + 1) * WSL + n];
    }
    dst[n] = t1;
    dst[w + n] = t2;
  }
  __syncthreads();  // red is free again
}

// The x patch of a tt x tf output tile (t0, f0) of sample b, group grp,
// input channels [c0, c0 + CW), by 16-byte cp.async (the caller commits):
// rows of halo_stride(CW), as stage_x lays them out
template <int CW>
__device__ void stage_x_async(const bf16* __restrict__ x, bf16* patch, const Plan& p, int b,
                              int grp, int t0, int f0, int tt, int c0) {
  constexpr int PER = CW / 8, HS = halo_stride(CW);
  // a thread a column (pf, 16 bytes) of the patch, walking nrg rows apart
  const int pf_n = 2 * p.tf + 1, ncols = pf_n * PER, pt_n = 2 * tt + 1;
  const int chan = p.split * p.width;
  const int nrg = imax(1, static_cast<int>(blockDim.x) / ncols), row = p.flen * chan;
  const bf16* xb = x + static_cast<long long>(b) * p.tlen * row + grp * p.width + c0;
  for (int cl = threadIdx.x; cl < ncols * nrg; cl += blockDim.x) {
    const int rg = cl / ncols, col = cl - rg * ncols, pf = col / PER, c = (col % PER) * 8;
    const int f = 2 * f0 - 1 + pf;
    const bool fv = f >= 0 && f < p.flen;
    uint32_t dst = smem_u32(patch + (rg * pf_n + xslot(pf, p.tf)) * HS + c);
    for (int pt = rg; pt < pt_n; pt += nrg, dst += 2 * nrg * pf_n * HS) {
      const int t = 2 * t0 - 1 + pt;
      const bool v = fv && t >= 0 && t < p.tlen;
      cp_async16(dst, xb + (v ? t * row + f * chan + c : 0), v);
    }
  }
}

// The forward's conv CTA (group, slice sl, run j of k): the slice's weights
// resident; stage s of the run = (tile e0 + s / NKC, input chunk s % NKC)
// through two ring buffers, stage s + 1's copies in flight while stage s
// computes; a tile's z written after its last chunk; the z sums flushed to
// the run's partial at each BN group's last tile. A warp: 32 rows (two m16
// tiles) by 8 NT of the slice's channels (WN warps across the slice).
template <int W>
__global__ void __launch_bounds__(256) fwd_mma_kernel(const bf16* __restrict__ x,
                                                      const bf16* __restrict__ weight,
                                                      bf16* __restrict__ z,
                                                      bf16* __restrict__ out, Plan p,
                                                      FwdArgs a) {
  using C = FwdCfg<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  Prof pr;
  const int cta = blockIdx.x, grp = cta / (C::NSL * p.k), sl = cta / p.k % C::NSL, j = cta % p.k;
  const long long sbytes = fwd_stage_bytes(p);
  bf16* wsm = reinterpret_cast<bf16*>(smem);
  bf16* stg = reinterpret_cast<bf16*>(smem + fwd_wbytes(W));
  float* red = reinterpret_cast<float*>(smem + fwd_wbytes(W) + 2 * sbytes);
  const int selems = static_cast<int>(sbytes / 2);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int rows = p.tt * p.tf, pf_n = 2 * p.tf + 1;
  const FastDiv tfd(p.tf);
  int rowoff[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = imin(wm * 32 + mt * 16 + lane % 16, rows - 1);
    rowoff[mt] = (2 * (r / p.tf) * pf_n + r % p.tf) * C::HS + (lane / 16) * 8;
  }
  // this thread's accumulator rows (mt, h): their tile row and column, -1
  // past the tile
  int ru[2][2], rv[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + mt * 16 + g + 8 * h;
      ru[mt][h] = r < rows ? r / p.tf : -1;
      rv[mt][h] = r % p.tf;
    }
  long long e0l, e1l;
  fwd_run(p, j, &e0l, &e1l);
  const int e0 = static_cast<int>(e0l), e1 = static_cast<int>(e1l);
  const int nst = (e1 - e0) * C::NKC, g0 = e0 / p.tiles / p.bpg;
  auto issue = [&](int s) {
    const int e = e0 + s / C::NKC;
    int t0, f0;
    tile_origin(p, e % p.tiles, p.tt, &t0, &f0);
    stage_x_async<C::CW>(x, stg + (s & 1) * selems, p, e / p.tiles, grp, t0, f0, p.tt,
                         (s % C::NKC) * C::CW);
    cp_async_commit();
  };
  issue(0);
  load_conv_weights<W, C::WSL>(wsm, weight, grp, sl * C::WSL);
  const uint32_t wbase = smem_u32(wsm + wn * C::NT * 8 * C::WS);
  float s1[C::NT][2], s2[C::NT][2];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt) s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;
  float acc[2][C::NT][4];
  zero_acc(acc);
  pr.lap(kPhProduce);
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage s landed for every thread (and the weights, at s = 0)
    pr.lap(kPhStage);
    const int e = e0 + s / C::NKC, kc = s % C::NKC, b = e / p.tiles;
    if (wm * 32 < rows) {
      const uint32_t pbase = smem_u32(stg + (s & 1) * selems);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = xtap(tap, pf_n, p.tf, C::HS);
#pragma unroll
        for (int ks = 0; ks < C::KSC; ++ks)
          mma_kstep<C::CW, C::NT>(acc, pbase, rowoff, toff, ks, wbase, C::WS,
                                  tap * C::KT + kc * C::CW + 16 * ks, lane);
      }
    }
    pr.lap(kPhMma);
    if (kc == C::NKC - 1) {
      pr.count(kPhPatches);
      int t0, f0;
      tile_origin(p, e % p.tiles, p.tt, &t0, &f0);
      // epilogue: z rounded into the tile's z rows in shared memory (the
      // consumed stage's buffer, rows of ZS), the run's sums of z and z^2;
      // then the rows to z in 16-byte vectors
      bf16* zt = stg + (s & 1) * selems;
      __syncthreads();  // every warp is done reading the stage
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int co = (wn * C::NT + nt) * 8 + 2 * tg;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (ru[mt][h] < 0) continue;
            const int r = wm * 32 + mt * 16 + g + 8 * h;
            const float v0 = vsv::round_to<bf16>(acc[mt][nt][2 * h]);
            const float v1 = vsv::round_to<bf16>(acc[mt][nt][2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(zt + r * C::ZS + co) =
                __floats2bfloat162_rn(v0, v1);
            if (t0 + ru[mt][h] >= p.tout || f0 + rv[mt][h] >= p.fout) continue;
            s1[nt][0] += v0;
            s1[nt][1] += v1;
            s2[nt][0] += v0 * v0;
            s2[nt][1] += v1 * v1;
          }
      }
      zero_acc(acc);
      __syncthreads();
      bf16* zb = z + (static_cast<long long>(grp) * p.batch + b) * p.npos * W + sl * C::WSL;
      for (int i = tid; i < rows * (C::WSL / 8); i += blockDim.x) {
        const int r = i / (C::WSL / 8), c = i % (C::WSL / 8) * 8, u = tfd.div(r);
        const int ot = t0 + u, of = f0 + r - u * p.tf;
        if (ot < p.tout && of < p.fout)
          *reinterpret_cast<uint4*>(zb + (static_cast<long long>(ot) * p.fout + of) * W + c) =
              *reinterpret_cast<const uint4*>(zt + r * C::ZS + c);
      }
      pr.lap(kPhEpilogue);
      // the BN group's last tile of the run: its partial
      const int gb = b / p.bpg;
      if (e + 1 == e1 || (e + 1) / p.tiles / p.bpg != gb)
        flush_sums<C::NT, C::WSL, C::WN>(
            s1, s2, red,
            a.part + ((static_cast<long long>(grp) * p.k + j) * 2 + (gb - g0)) * 2 * W +
                sl * C::WSL,
            W);
      pr.lap(kPhSums);
    }
    __syncthreads();  // every warp is done with stage s's buffer
  }
  const bool last = last_to_arrive(a.ticket, p.nconv);
  pr.lap(kPhSums);
  if (last) {
    int* runs = reinterpret_cast<int*>(stg);  // the ring is free
    fill_runs(p, runs);
    collapse<true>(RunSums{a.part, &p, runs}, p, a.stats, a.update ? &a.run : nullptr, a.eps,
                   a.mom, a.upd_mean, a.upd_var);
  }
  pr.lap(kPhReduce);
  pr.flush(kRoleFwd);
}

// dout and z of a gtt x tf tile's (gtt + 1) x (tf + 1) output positions
// (one more row and column, for the dgrad), all w channels, by cp.async
// into raw: [0][pos][w] dout, [1][pos][w] z, zero outside T' x F'
// (a thread a column of dout or z, walking the rows as stage_x_async does)
template <int W>
__device__ void stage_raw(const bf16* __restrict__ dout, const bf16* __restrict__ z, bf16* raw,
                          const Plan& p, int b, int grp, int t0, int f0) {
  constexpr int VECS = W / 8;
  const int chan = p.split * W, nf = p.tf + 1, np = (p.gtt + 1) * nf, half = nf * VECS;
  const int ncols = 2 * half, nrg = imax(1, static_cast<int>(blockDim.x) / ncols);
  const bf16* db = dout + static_cast<long long>(b) * p.npos * chan + grp * W;
  const bf16* zb = z + (static_cast<long long>(grp) * p.batch + b) * p.npos * W;
  for (int cl = threadIdx.x; cl < ncols * nrg; cl += blockDim.x) {
    const int rg = cl / ncols, col = cl - rg * ncols, arr = col >= half;
    const int r = arr ? col - half : col, pf = r / VECS, c = (r % VECS) * 8, of = f0 + pf;
    const int stride = arr ? W : chan;
    const bf16* base = (arr ? zb : db) + c;
    uint32_t dst = smem_u32(raw + (arr * np + rg * nf + pf) * W + c);
    for (int du = rg; du <= p.gtt; du += nrg, dst += 2 * nrg * nf * W) {
      const int ot = t0 + du;
      const bool v = ot < p.tout && of < p.fout;
      cp_async16(dst, base + (v ? (ot * p.fout + of) * stride : 0), v);
    }
  }
}

// The tile's dz patch from its staged dout and z: dz_of at (group grp, the
// sample's BN group) with its mean, rstd, mean(d), mean(d xhat) in bn
// (4 rows of W), rounded to bf16, zero outside T' x F'; rows of stride
// halo_stride(W)
template <int W>
__device__ void make_dz(const bf16* raw, bf16* dzp, const Plan& p, const FastDiv& cd, int t0,
                        int f0, const float* bn) {
  constexpr int vecs = W / 8, HS = halo_stride(W);
  const int np = (p.gtt + 1) * cd.d;
  for (int i = threadIdx.x; i < np * vecs; i += blockDim.x) {
    const int pos = i / vecs, c = (i % vecs) * 8, du = cd.div(pos);
    const int ot = t0 + du, of = f0 + pos - du * cd.d;
    float o[8];
    if (ot < p.tout && of < p.fout) {
      float dv[8], zv[8];
      vsv::unpack16(*reinterpret_cast<const uint4*>(raw + pos * W + c), dv, raw);
      vsv::unpack16(*reinterpret_cast<const uint4*>(raw + (np + pos) * W + c), zv, raw);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = dz_of<bf16>(zv[e], dv[e], bn[c + e], bn[W + c + e], bn[2 * W + c + e],
                           bn[3 * W + c + e]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = 0.f;
    }
    vsv::store16(dzp + pos * HS + c, o);
  }
}

template <int W>
struct GradCfg {
  static constexpr int WARPS = grad_warps(W), NDS = grad_nds(W), DSW = W / NDS;
  static constexpr int WND = grad_wnd(W), WMD = WARPS / WND, NTD = DSW / (8 * WND);
  static constexpr int KT = tap_cols(W);
  static constexpr int WS = 9 * KT + 8, HS = halo_stride(W), KSPT = KT / 16;
  static constexpr int UPT = wg_upt(W), NCH = wg_nchunks(W), NTL = W / 8, CB = (W + 15) / 16;
  static constexpr int ZS = halo_stride(DSW);  // a dx row of the dgrad's tile in shared memory
  static constexpr int DUAL = NTD <= 2 && KSPT >= 2 ? 2 : 1;
};

// The grad launch's CTA (group, chunk, run j of nsplit of the group's B
// gtiles tiles): each tile's x patch and raw dout and z through two ring
// buffers (tile i + 1's copies in flight while tile i computes), dz made
// once into the dz patch, then (1) the chunk's dW m tiles, C[(tap, c)][n]
// += sum over the tile's positions r of x_patch(r, tap)[c] dz[r][n], K the
// positions in k steps of 16, both operands by ldmatrix.trans (positions
// past the tile read a zero dz row), accumulated across the run; (2) the
// dgrad where this chunk owns it (the tile's index mod nchunks, or its
// 16-channel slice of dx): four parity classes, each the k steps of its
// tap slots over the dz patch, class (pt, pf)'s rows the tile's input
// positions (2 (t0 + u) + pt, 2 (f0 + v) + pf). At the end the run's dW
// partial; the chunk's last CTA to arrive adds the partials in run order.
template <int W>
__global__ void __launch_bounds__(256) grad_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dout, const bf16* __restrict__ z,
    const bf16* __restrict__ weight, bf16* __restrict__ dx, bf16* __restrict__ dweight, Plan p,
    GradArgs a) {
  using C = GradCfg<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  Prof pr;
  const int blk = blockIdx.x;
  const int grp = blk / (C::NCH * p.nsplit), chunk = blk / p.nsplit % C::NCH, j = blk % p.nsplit;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int tf = p.tf, pf_n = 2 * tf + 1, chan = p.split * W;
  const int rows = p.gtt * tf, ksteps = gksteps(p), dpos = (p.gtt + 1) * (tf + 1);
  const FastDiv cd(tf + 1), ftd(2 * tf);
  unsigned char* q = smem;
  bf16* wsm = reinterpret_cast<bf16*>(q);
  q += grad_wbytes(W);
  bf16* xst = reinterpret_cast<bf16*>(q);
  q += 2 * gx_bytes(p);
  bf16* rst = reinterpret_cast<bf16*>(q);
  q += 2 * graw_bytes(p);
  bf16* dzp = reinterpret_cast<bf16*>(q);
  q += gdz_bytes(p);
  int* rows_x = reinterpret_cast<int*>(q);
  int* rows_d = rows_x + 16 * ksteps;
  q += 2 * 4 * 16 * ksteps;
  float* bn = reinterpret_cast<float*>(q);  // the current BN group's 4 rows of W
  int bn_g = -1;
  const int xel = static_cast<int>(gx_bytes(p) / 2), rel = static_cast<int>(graw_bytes(p) / 2);
  const bool dg_cta = C::NDS == 1 || chunk < C::NDS;
  const int dsl = C::NDS == 1 ? 0 : chunk;
  const long long ntl = static_cast<long long>(p.batch) * p.gtiles;
  const int e0 = static_cast<int>(ntl * j / p.nsplit);
  const int n_items = static_cast<int>(ntl * (j + 1) / p.nsplit) - e0;
  auto issue = [&](int i) {
    const int e = e0 + i, b = e / p.gtiles;
    int t0, f0;
    tile_origin(p, e % p.gtiles, p.gtt, &t0, &f0);
    stage_x_async<W>(x, xst + (i & 1) * xel, p, b, grp, t0, f0, p.gtt, 0);
    stage_raw<W>(dout, z, rst + (i & 1) * rel, p, b, grp, t0, f0);
    cp_async_commit();
  };
  if (n_items > 0) issue(0);
  if (dg_cta) load_dgrad_weights<W, C::DSW>(wsm, weight, grp, dsl * C::DSW);
  const int dzero = dpos * C::HS;
  for (int i = tid; i < 16 * ksteps; i += blockDim.x) {
    rows_x[i] = i < rows ? (2 * (i / tf) * pf_n + i % tf) * C::HS : 0;
    rows_d[i] = i < rows ? ((i / tf) * (tf + 1) + i % tf) * C::HS : dzero;
  }
  for (int i = tid; i < C::HS; i += blockDim.x) dzp[dzero + i] = vsv::from_f<bf16>(0.f);
  // this warp's dW m tiles: (tap, channel block) and their x patch offsets
  int xo[C::UPT];
  bool mv[C::UPT];
#pragma unroll
  for (int mi = 0; mi < C::UPT; ++mi) {
    const int mt = (warp * C::UPT + mi) * C::NCH + chunk;
    mv[mi] = mt < wg_mtiles(W);
    int cc = (mt % C::CB) * 16 + ((lane >> 3) & 1) * 8;
    if (cc >= W) cc -= 8;  // w = 8: the pad rows read the real channels again (discarded)
    xo[mi] = mv[mi] ? xtap(mt / C::CB, pf_n, tf, C::HS) + cc : 0;
  }
  float acc[C::UPT][C::NTL][4];
#pragma unroll
  for (int mi = 0; mi < C::UPT; ++mi)
#pragma unroll
    for (int nt = 0; nt < C::NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
  // the dgrad's warps: WND across the slice, WMD = nstr strips of 32 rows
  // times cgroups groups of the parity classes (cgroups = WMD / nstr, at
  // most 4: a tile of few rows spreads its classes over the warps)
  const int wmd = warp / C::WND, wnd = warp % C::WND, nstr = cdiv(rows, 32);
  const int cgroups = imin(4, imax(1, C::WMD / nstr));
  const int strip = wmd % nstr, cgroup = wmd / nstr;
  const bool dwarp = wmd < nstr * cgroups;
  int drow[2], dpx[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = imin(strip * 32 + mt * 16 + lane % 16, rows - 1);
    drow[mt] = ((r / tf) * (tf + 1) + r % tf) * C::HS + (lane / 16) * 8;
    // this thread's accumulator rows (mt, h): the (even, even) input
    // position of each in the dgrad's 2 gtt x 2 tf tile, -1 past the tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = strip * 32 + mt * 16 + g + 8 * h;
      dpx[mt][h] = rr < rows ? 2 * (rr / tf) * (2 * tf) + 2 * (rr % tf) : -1;
    }
  }
  const uint32_t dzb = smem_u32(dzp), wbase = smem_u32(wsm + wnd * C::NTD * 8 * C::WS);
  pr.lap(kPhProduce);
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i landed (and the weights and tables, at i = 0)
    pr.lap(kPhStage);
    pr.count(kPhPatches);
    const int e = e0 + i, b = e / p.gtiles;
    int t0, f0;
    tile_origin(p, e % p.gtiles, p.gtt, &t0, &f0);
    if (b / p.bpg != bn_g) {  // a BN group's parameters, once a run
      bn_g = b / p.bpg;
      const int gw = p.groups * W;
      for (int k = tid; k < 4 * W; k += blockDim.x)
        bn[k] = k < 2 * W ? a.stats[(static_cast<long long>(grp) * 3 + k / W) * gw + bn_g * W +
                                    k % W]
                          : a.bsums[(static_cast<long long>(grp) * 2 + k / W - 2) * gw +
                                    bn_g * W + k % W];
      __syncthreads();
    }
    make_dz<W>(rst + (i & 1) * rel, dzp, p, cd, t0, f0, bn);
    __syncthreads();
    pr.lap(kPhProduce);
    // (1) the weight gradient's chunk
    const uint32_t xb = smem_u32(xst + (i & 1) * xel);
    for (int ks = 0; ks < ksteps; ++ks) {
      const int rb = 16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int ra = 16 * ks + (lane >> 4) * 8 + (lane & 7);
      uint32_t bq[(C::NTL + 1) / 2][4];
      if constexpr (C::NTL == 1) {
        ldmatrix_x2_trans(bq[0], dzb + 2 * rows_d[rb]);
      } else {
#pragma unroll
        for (int np = 0; np < C::NTL / 2; ++np)
          ldmatrix_x4_trans(bq[np], dzb + 2 * (rows_d[rb] + 16 * np + (lane >> 4) * 8));
      }
      const int xr = rows_x[ra];
#pragma unroll
      for (int mi = 0; mi < C::UPT; ++mi) {
        if (!mv[mi]) continue;
        uint32_t af[4];
        ldmatrix_x4_trans(af, xb + 2 * (xr + xo[mi]));
        if constexpr (C::NTL == 1) {
          mma_bf16_16816(acc[mi][0], af, bq[0]);
        } else {
#pragma unroll
          for (int np = 0; np < C::NTL / 2; ++np) {
            mma_bf16_16816(acc[mi][2 * np], af, bq[np]);
            mma_bf16_16816(acc[mi][2 * np + 1], af, bq[np] + 2);
          }
        }
      }
    }
    pr.lap(kPhMma);
    // (2) the dgrad: the tile's 2 gtt x 2 tf input positions of dx's slice
    // into the consumed x stage (rows of ZS), then to dx in 16-byte vectors
    if (dg_cta && (C::NDS > 1 || e % C::NCH == chunk)) {
      bf16* dxt = xst + (i & 1) * xel;
      __syncthreads();  // every warp is done reading the x stage
      for (int cls = 0; cls < 4 && dwarp; ++cls) {
        // cgroups 2: classes {0, 3} and {1, 2} (5 and 4 tap slots)
        if ((cgroups == 4 && cls != cgroup) ||
            (cgroups == 2 && (cls == 0 || cls == 3) != (cgroup == 0)))
          continue;
        const int pt = cls / 2, pf = cls % 2;
        // two accumulator sets by k step parity where a tap has several
        // (more MMAs in flight), added in that order
        float dacc[C::DUAL][2][C::NTD][4];
#pragma unroll
        for (int d = 0; d < C::DUAL; ++d) zero_acc(dacc[d]);
        const int s0 = cls == 0 ? 0 : 2 * cls - 1, s1 = cls == 3 ? 9 : 2 * cls + 1;
#pragma unroll 1
        for (int slot = s0; slot < s1; ++slot) {
          const int toff = dslot_off(slot, tf, C::HS);
#pragma unroll
          for (int ks = 0; ks < C::KSPT; ++ks)
            mma_kstep<W, C::NTD>(dacc[ks % C::DUAL], dzb, drow, toff, ks, wbase, C::WS,
                                 slot * C::KT + 16 * ks, lane);
        }
        if constexpr (C::DUAL == 2) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < C::NTD; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) dacc[0][mt][nt][e] += dacc[1][mt][nt][e];
        }
#pragma unroll
        for (int nt = 0; nt < C::NTD; ++nt) {
          const int co = (wnd * C::NTD + nt) * 8 + 2 * tg;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (dpx[mt][h] < 0) continue;
              const int pos = dpx[mt][h] + pt * (2 * tf) + pf;
              *reinterpret_cast<__nv_bfloat162*>(dxt + pos * C::ZS + co) =
                  __floats2bfloat162_rn(dacc[0][mt][nt][2 * h], dacc[0][mt][nt][2 * h + 1]);
            }
        }
      }
      __syncthreads();
      for (int k = tid; k < 4 * rows * (C::DSW / 8); k += blockDim.x) {
        const int pos = k / (C::DSW / 8), c = k % (C::DSW / 8) * 8, u = ftd.div(pos);
        const int t = 2 * t0 + u, f = 2 * f0 + pos - u * (2 * tf);
        if (t < p.tlen && f < p.flen)
          *reinterpret_cast<uint4*>(dx + ((static_cast<long long>(b) * p.tlen + t) * p.flen + f) *
                                             chan + grp * W + dsl * C::DSW + c) =
              *reinterpret_cast<const uint4*>(dxt + pos * C::ZS + c);
      }
    }
    pr.lap(kPhDgrad);
    __syncthreads();  // every warp is done with tile i's buffers and the dz patch
  }
  const long long pcw = static_cast<long long>(p.pc) * W;
  const long long cbase = static_cast<long long>(grp * C::NCH + chunk) * p.nsplit;
  float* mine = a.wpart + (cbase + j) * pcw;
#pragma unroll
  for (int mi = 0; mi < C::UPT; ++mi) {
    if (!mv[mi]) continue;
#pragma unroll
    for (int nt = 0; nt < C::NTL; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pl = (warp * C::UPT + mi) * 16 + g + 8 * h, n = nt * 8 + 2 * tg;
        *reinterpret_cast<float2*>(mine + pl * W + n) =
            make_float2(acc[mi][nt][2 * h], acc[mi][nt][2 * h + 1]);
      }
  }
  const bool last = last_to_arrive(a.tickets + grp * C::NCH + chunk, p.nsplit);
  pr.lap(kPhSums);
  if (last) {  // four (row, n .. n + 3) a thread at a time, the runs in order
    for (int idx = 4 * threadIdx.x; idx < pcw; idx += 4 * blockDim.x) {
      const int pl = idx / W, n = idx % W;
      const int mt = (pl / 16) * C::NCH + chunk, c = (mt % C::CB) * 16 + pl % 16;
      if (mt >= wg_mtiles(W) || c >= W) continue;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int sp = 0; sp < p.nsplit; ++sp) {
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(a.wpart + (cbase + sp) * pcw + idx));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      bf16* dw = dweight + ((static_cast<long long>(grp) * W + n) * W + c) * 9 + mt / C::CB;
      dw[0] = vsv::from_f<bf16>(s.x);
      dw[W * 9] = vsv::from_f<bf16>(s.y);
      dw[2 * W * 9] = vsv::from_f<bf16>(s.z);
      dw[3 * W * 9] = vsv::from_f<bf16>(s.w);
    }
  }
  pr.lap(kPhReduce);
  pr.flush(kRoleGrad);
}

// ---------------------------------------------------------------------------
// finish and bwd_stats: element-wise over z, V channels a thread; the
// average pool and its backward beside them (no shared memory held while
// they run)
// ---------------------------------------------------------------------------

// the s-1 groups' y from z, a position's groups together (its output row's
// first (s-1) w channels), then the last group's average pool from x
template <typename T, int V>
__global__ void __launch_bounds__(kStatThreads) finish_kernel(const T* __restrict__ x,
                                                              const T* __restrict__ z,
                                                              const float* __restrict__ stats,
                                                              T* __restrict__ out, Plan p) {
  const int w = p.width, vecs = w / V, gv = p.ng * vecs, chan = p.split * w, gw = p.groups * w;
  const long long n = static_cast<long long>(p.batch) * p.npos * gv;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = first; i < n; i += stride) {
    const long long q = i / gv, b = q / p.npos;  // q: the position b npos + pos
    const int gc = static_cast<int>(i - q * gv), grp = gc / vecs, c = (gc - grp * vecs) * V;
    const float* st =
        stats + static_cast<long long>(grp) * 3 * gw + (static_cast<int>(b) / p.bpg) * w + c;
    float v[V];
    load_v<T, V>(z + (static_cast<long long>(grp) * p.batch * p.npos + q) * w + c, v);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = fmaxf(bn_v(v[e], st[e], st[gw + e]), 0.f);
    store_v<T, V>(out + q * chan + grp * w + c, v);
  }
  const long long np = static_cast<long long>(p.batch) * p.npos * vecs;
  for (long long i = first; i < np; i += stride) {
    const long long q = i / vecs, b = q / p.npos, pos = q - b * p.npos, ot = pos / p.fout;
    pool_fwd_item<T, V>(x, out, p, b, static_cast<int>(ot), static_cast<int>(pos - ot * p.fout),
                        static_cast<int>(i - q * vecs) * V);
  }
}

// pool_ctas CTAs of the pool's backward (the tail's dx), then nstat slabs
// of the sums
template <typename T, int V>
__global__ void __launch_bounds__(kStatThreads) bwd_stats_kernel(
    const T* __restrict__ dout, const T* __restrict__ z, const float* __restrict__ stats,
    float* __restrict__ bsums, float* __restrict__ part, unsigned int* ticket, T* __restrict__ dx,
    Plan p) {
  __shared__ float red[kStatThreads * 2 * V];
  if (static_cast<int>(blockIdx.x) < p.pool_ctas) {  // first: they take the longest
    Prof pr;
    pool_bwd_items<T, V>(dout, dx, p, blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x,
                         static_cast<long long>(p.pool_ctas) * blockDim.x);
    pr.lap(kPhEpilogue);
    pr.flush(kRolePoolBwd);
    return;
  }
  const int w = p.width, vecs = w / V, chan = p.split * w, gw = p.groups * w;
  // sample-major: the groups of a sample together (their dout slices share
  // lines); the partial at (group, sample, run)
  const int blk = blockIdx.x - p.pool_ctas, b = blk / (p.ng * p.kstat);
  const int grp = blk / p.kstat % p.ng, r = blk % p.kstat;
  const int slab = (grp * p.batch + b) * p.kstat + r;
  const long long first = p.npos * r / p.kstat, end = p.npos * (r + 1) / p.kstat;
  const int tid = threadIdx.x, vec = tid % vecs, p0 = tid / vecs, pstride = blockDim.x / vecs;
  const bool active = p0 < pstride;
  const int c = vec * V;
  const float* st = stats + static_cast<long long>(grp) * 3 * gw + (b / p.bpg) * w + c;
  Prof pr;
  float m[V], rs[V], sd[V], sx[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = st[e];
    rs[e] = st[gw + e];
    sd[e] = sx[e] = 0.f;
  }
  if (active) {
#pragma unroll 4
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
  pr.lap(kPhStage);
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
  const bool last = last_to_arrive(ticket, p.nstat);
  pr.lap(kPhSums);
  if (last) collapse<false>(SlabSums{part, p.kstat, &p}, p, bsums, nullptr, 0.f, 0.f, 0.f, 0.f);
  pr.lap(kPhReduce);
  pr.flush(kRoleStats);
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
// float32, 1 = bfloat16. plan: 20 host ints (models/res2net.py:
// stride2_train_plan, _stride2_train_ints). x (B, T, F, s w) channels-last;
// weight ((s-1) w, w, 3, 3) OIHW in the dtype, as the module holds it. z
// (s-1, B, T', F', w) written; stats (s-1, 3, G, w) float32 written (mean,
// rstd, var); running: a host array of 2 (s-1) device pointers (each
// group's running mean, then variance), or null for no update; out (B, T',
// F', s w) channels-last (written by _finish); part: the plan's part_floats,
// ticket one int (zero, left zero).
// smem: the plan's shared memory (refused where it differs from the
// layout's: vsv::kPlanMismatch).
extern "C" int split_stride2_train_fwd(int dtype, const int* plan, const void* x,
                                       const void* weight, void* z, float* stats,
                                       const void* const* running, void* out, float* part,
                                       unsigned int* ticket, float eps, float momentum,
                                       float upd_mean, float upd_var, long long smem,
                                       void* stream) {
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
  const unsigned grid = static_cast<unsigned>(p.nconv);
  const int w = p.width;
  int err = 0;
#define VSV_LAUNCH(KERNEL, T)                                                                  \
  do {                                                                                         \
    err = set_smem(KERNEL, smem);                                                              \
    if (err) return err;                                                                       \
    KERNEL<<<grid, p.threads, smem, s>>>(static_cast<const T*>(x),                             \
                                         static_cast<const T*>(weight), static_cast<T*>(z),    \
                                         static_cast<T*>(out), p, a);                          \
  } while (0)
  if (p.design == 1) {
    if (!aligned16(x) || !aligned16(weight) || !aligned16(z) || !aligned16(out))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (w) {
      case 8: VSV_LAUNCH(fwd_mma_kernel<8>, bf16); break;
      case 16: VSV_LAUNCH(fwd_mma_kernel<16>, bf16); break;
      case 32: VSV_LAUNCH(fwd_mma_kernel<32>, bf16); break;
      case 48: VSV_LAUNCH(fwd_mma_kernel<48>, bf16); break;
      case 64: VSV_LAUNCH(fwd_mma_kernel<64>, bf16); break;
      case 96: VSV_LAUNCH(fwd_mma_kernel<96>, bf16); break;
      case 192: VSV_LAUNCH(fwd_mma_kernel<192>, bf16); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    if (w % 4 == 0) VSV_LAUNCH((fwd_fma_kernel<float, 4>), float);
    else VSV_LAUNCH((fwd_fma_kernel<float, 1>), float);
  } else {
    if (w % 4 == 0) VSV_LAUNCH((fwd_fma_kernel<bf16, 4>), bf16);
    else VSV_LAUNCH((fwd_fma_kernel<bf16, 1>), bf16);
  }
#undef VSV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// K11, the forward's second launch: y_i = relu((z_i - mean) * rstd) into the
// output's s-1 group slices, and the average pool of x's last group into
// its slice. x, z, stats and out as split_stride2_train_fwd's.
extern "C" int split_stride2_train_finish(int dtype, const int* plan, const void* x,
                                          const void* z, const float* stats, void* out,
                                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(plan, &p) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = p.width;
  const bool vec =
      aligned16(x) && aligned16(z) && aligned16(out) && w % (dtype == 1 ? 8 : 4) == 0;
  const long long n = static_cast<long long>(p.ng) * p.batch * p.npos * w;
#define VSV_LAUNCH(T, V)                                                                       \
  finish_kernel<T, V><<<elementwise_grid(n / V), kStatThreads, 0, s>>>(                       \
      static_cast<const T*>(x), static_cast<const T*>(z), stats, static_cast<T*>(out), p)
  if (dtype == 1 && vec) VSV_LAUNCH(bf16, 8);
  else if (dtype == 1) VSV_LAUNCH(bf16, 1);
  else if (vec) VSV_LAUNCH(float, 4);
  else VSV_LAUNCH(float, 1);
#undef VSV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// K11b, the backward's first launch: mean(d) and mean(d xhat) per (group,
// BN group, channel) into bsums (s-1, 2, G, w), and the pool's backward
// into dx's last group slice. dout (B, T', F', s w) channels-last; z, stats
// as the forward's; part: nstat * 2 w floats, ticket one int (zero, left
// zero); dx (B, T, F, s w) channels-last.
extern "C" int split_stride2_train_bwd_stats(int dtype, const int* plan, const void* dout,
                                             const void* z, const float* stats, float* bsums,
                                             float* part, unsigned int* ticket, void* dx,
                                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(plan, &p) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = p.width;
  const bool vec =
      aligned16(z) && aligned16(dout) && aligned16(dx) && w % (dtype == 1 ? 8 : 4) == 0;
  const unsigned grid = static_cast<unsigned>(p.nstat + p.pool_ctas);
#define VSV_LAUNCH(T, V)                                                                       \
  bwd_stats_kernel<T, V><<<grid, kStatThreads, 0, s>>>(static_cast<const T*>(dout),           \
                                                       static_cast<const T*>(z), stats, bsums, \
                                                       part, ticket, static_cast<T*>(dx), p)
  if (dtype == 1 && vec) VSV_LAUNCH(bf16, 8);
  else if (dtype == 1) VSV_LAUNCH(bf16, 1);
  else if (vec) VSV_LAUNCH(float, 4);
  else VSV_LAUNCH(float, 1);
#undef VSV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// K11b, the backward's second launch: dx's s-1 group slices (B, T, F, s w)
// channels-last, whole, and dweight (s-1) w x w x 3 x 3 (OIHW) in the
// dtype. x,
// dout, z, stats, bsums as above; weight the forward's (OIHW); wpart: the
// plan's wpart_floats; tickets: (s-1) nchunks ints (zero, left zero).
extern "C" int split_stride2_train_bwd_grad(int dtype, const int* plan, const void* x,
                                            const void* dout, const void* z, const float* stats,
                                            const float* bsums, const void* weight, void* dx,
                                            void* dweight, float* wpart, unsigned int* tickets,
                                            long long smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(plan, &p) || (dtype != 0 && dtype != 1) || (p.design == 1 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int item = dtype == 1 ? 2 : 4;
  if (smem != grad_smem(p, item)) return vsv::kPlanMismatch;
  GradArgs a{stats, bsums, wpart, tickets};
  const unsigned grid = static_cast<unsigned>(p.nwgrad + (p.design == 0 ? p.nconv : 0));
  const int w = p.width;
  int err = 0;
#define VSV_LAUNCH(KERNEL, T)                                                                  \
  do {                                                                                         \
    err = set_smem(KERNEL, smem);                                                              \
    if (err) return err;                                                                       \
    KERNEL<<<grid, p.gthreads, smem, s>>>(                                                     \
        static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const T*>(z),       \
        static_cast<const T*>(weight), static_cast<T*>(dx), static_cast<T*>(dweight), p, a);   \
  } while (0)
  if (p.design == 1) {
    if (!aligned16(x) || !aligned16(dout) || !aligned16(z) || !aligned16(weight) ||
        !aligned16(dx))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (w) {
      case 8: VSV_LAUNCH(grad_mma_kernel<8>, bf16); break;
      case 16: VSV_LAUNCH(grad_mma_kernel<16>, bf16); break;
      case 32: VSV_LAUNCH(grad_mma_kernel<32>, bf16); break;
      case 48: VSV_LAUNCH(grad_mma_kernel<48>, bf16); break;
      case 64: VSV_LAUNCH(grad_mma_kernel<64>, bf16); break;
      case 96: VSV_LAUNCH(grad_mma_kernel<96>, bf16); break;
      case 192: VSV_LAUNCH(grad_mma_kernel<192>, bf16); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    if (w % 4 == 0) VSV_LAUNCH((grad_fma_kernel<float, 4>), float);
    else VSV_LAUNCH((grad_fma_kernel<float, 1>), float);
  } else {
    if (w % 4 == 0) VSV_LAUNCH((grad_fma_kernel<bf16, 4>), bf16);
    else VSV_LAUNCH((grad_fma_kernel<bf16, 1>), bf16);
  }
#undef VSV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

#ifdef VSV_K11_PROF
// The phase profile's counters ((roles, slots) unsigned 64-bit) into host,
// zeroed after when reset is non-zero: present only in the profile build.
extern "C" int split_stride2_train_prof(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_k11_prof, sizeof(g_k11_prof));
  if (e == cudaSuccess && reset) {
    static unsigned long long zeros[kProfRoles * kProfSlots];
    e = cudaMemcpyToSymbol(g_k11_prof, zeros, sizeof(zeros));
  }
  return static_cast<int>(e);
}
#endif
