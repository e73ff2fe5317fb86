// K9 / K9b: the stride-1 Res2Net split chain in training, forward and
// backward.
//
// Replaces: voxsrc2020_speaker_verification_tpu/models/res2net.py
// Res2NetSplitConv, stride-1 branch (lines 82-107) in training, and its
// autodiff. Per group i < s-1 of width w, BN statistics per BN group (a
// run of B / G samples):
//   in_i = x_i + mask * y_{i-1}                 (i > 0; rounded to the dtype)
//   z_i  = conv3x3_same(in_i, W_i)              (rounded to the dtype)
//   y_i  = relu((z_i - mean_g) * rstd_g)        (rounded to the dtype)
// mean_g and var_g = E[z^2] - mean_g^2 over the group's positions, rstd_g =
// rsqrt(var_g + eps), and y_{s-1} = x_{s-1}. XLA ran it as s-1 convs, s-1
// grouped BNs, s-2 adds, the split and the concat; the port's earlier
// training route ran the same as cuDNN convs, K5, PyTorch adds and a cat,
// and autograd their gradients.
//
// Forward (K9), s launches a chain: split_train_fwd for i = 0 .. s-2, then
// split_train_finish. Launch i stages the halo patch of in_i, recomputing
// y_{i-1} from the saved z_{i-1} and group i-1's published statistics, and
// writes y_{i-1} into the output's channel slice i-1 at its own positions
// (launch 0 copies the pass-through x_{s-1} instead); runs the conv;
// rounds z_i to the dtype, writes it (saved for the backward) and sums z_i
// and z_i^2 per channel over its slab; the last CTA to arrive (an integer
// ticket, no float atomics) adds the slabs' partials in slab order per
// (BN group, channel), publishes mean, rstd and var, and applies the
// running update (momentum, Bessel n/(n-1)) unless its pointers are null.
// split_train_finish normalizes z_{s-2} into slice s-2.
//
// Backward (K9b), s launches a chain: split_train_bwd_stats for group s-2,
// then split_train_bwd_grad for i = s-2 .. 0.
//   split_train_bwd_stats: d_{s-2} = dout_{s-2} times [y_{s-2} > 0] (y
//       recomputed from z by the forward's own expression, so the relu
//       decision agrees bit for bit), written to a scratch, its sums d and
//       d * xhat per (BN group, channel) by slab partials and a ticket, as
//       the forward's; and dx_{s-1} = dout_{s-1}.
//   split_train_bwd_grad, group i: dz_i = rstd (d - mean(d) - xhat mean(d
//       xhat)), rounded to the dtype, staged on the fly; dIn_i, the 3x3
//       transposed conv of dz_i (the conv with flipped weights), into dx's
//       slice i; for i > 0, group i-1's statistics folded in where dIn_i is
//       at hand: d_{i-1} = (dout_{i-1} + mask * dIn_i) rounded, times
//       [y_{i-1} > 0] (fold_d), into the other half of the double-buffered
//       scratch, with its sums by slab partials and the dgrad CTAs' ticket;
//       and, on CTAs of their own, dW_i = sum over positions of in_i
//       (recomputed from x_i and z_{i-1}) times dz_i, by split partials
//       added in split order (two levels: runs of 32 splits, then the runs;
//       tickets), written in the dtype into the gradient's OIHW rows.
//
// Three variants (the plan, models/res2net.py:split_train_plan, names the
// variant; each C entry checks it):
//
// * The Hopper design ("wgmma": bf16 at w = 32, 48, 64, 96, 192).
//   The conv launches run persistent warp-specialized CTAs (wg_conv), one
//   an SM: a producer warpgroup whose thread 0 lands the group's weights
//   by bulk copies (at w <= 64 all of them once, resident; wider, through
//   a ring every patch, as csrc/split_conv.cu's split_group_wgmma) and
//   whose warps 1-3 stage the next patch's operand
//   (in_i or dz_i, each thread always the same 8 channels with their BN
//   parameters in registers) into the other of two stages while two
//   consumer warpgroups run this one's wgmma m64nWk16 (A by ldmatrix from
//   the stage, B from the ring); the consumers' epilogue rounds the result
//   into the stage and writes it out in 16-byte rows, each thread keeping
//   its 8 channels' slab sums (z and z^2; or the folded d and d xhat) in
//   registers. The weight gradient (wg_wgrad, three warpgroups a CTA, one
//   wave of CTAs) takes 64-row m tiles of (tap, input channel) rows by all
//   w output channels, A by ldmatrix.trans, B (dz) by an MN-major
//   descriptor; every thread copies the next patch's raw rows by cp.async
//   while the MMAs run, then converts them into the operands in shared
//   memory.
// * The mma variant ("mma": bf16 at w = 8, 16, 24): CTAs of four warps,
//   patches of at most 128 (t, f) positions with a one-position halo. The
//   conv launches run persistent CTAs (as many as fit an SM, at most one a
//   slab) walking slabs; every thread copies the next patch's rows by
//   cp.async (with its BN group's parameters and mask rows) while this
//   patch's MMAs and epilogue run, then converts them into the halo in
//   shared memory (mma_conv_role);
//   the mma.sync m16n8k16 conv has all w output channels in one pass, B
//   fragments from the group's weights staged in shared memory. The weight
//   gradient takes tiles of up to 8 m tiles (two (8-channel group, tap)
//   chunks an m tile) by all w output channels, both operands transposed
//   by ldmatrix, its rows copied one patch ahead the same way.
// * The float variant ("fma": float32, and bf16 at the other widths; FMA
//   on CUDA cores: float32 stays off the tensor cores, TF32 would drop 13
//   mantissa bits): one CTA a slab, its patches staged as floats one at a
//   time; the weight gradient's threads each own up to five (tap, input
//   channel) pairs by 8 output channels.
//
// A slab is a run of patches (or, for the statistics launch, of positions)
// of one sample, so it never crosses a BN group; its partials are summed in
// slab order whichever CTA took it.
//
// Bound on the card: bytes. Forward, x read and the output written (2
// activations of 2 B); backward, x and dout read and dx written (3): 5
// activations a chain, 14.1 ms a bench training step at 3.35 TB/s. The
// group convs are 18 w^2 flops a position, three times over (forward,
// dgrad, wgrad): 4.7 GFLOP a group at every stage of the bench step, 0.1
// ms a microbatch's chains at 989 TFLOP/s. What bounds them (PERF.md, PR
// 16, from the phase profile, scripts/profile_k9.py): at w = 32-96 the
// producer warps' staging (three warps a CTA, each item's math and load
// latency; the consumers wait on it), at w = 192 the MMAs and the weight
// ring (each patch streams the group's 648 KB of weights from L2), and in
// the grad launch the weight gradient's copies and conversions (its tiles
// each re-stage dz: 9 tiles at w = 192); at w = 8-24 the mma variant's
// staging of small patches, its conversion and barriers (the Hopper design
// staged them slower: its 96 producer threads against eight 128-thread
// CTAs an SM).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps
constexpr int kMaxPairs = 5;   // (tap, input channel) pairs a thread of the wgrad role
constexpr int kCoTile = 8;     // output channels of a float weight-gradient tile
constexpr int kSmemMax = 232448;
constexpr int kSplitChunk = 32;  // weight-gradient splits a first-level sum adds
constexpr int kWgMTiles = 8;     // m tiles (16 rows: two (tap, 8-channel) chunks) of an mma weight tile
constexpr int kMmaNt = 3;        // the mma variant's n tiles of 8 channels, at most (w <= 24)

struct Plan {
  // from the caller: batch, T, F, s, w, BN groups, the variant (0 fma, 1
  // mma, 2 wgmma), NT (mma: w / 8; wgmma: the weight ring's slices), patch (tt, tf),
  // slabs a sample, input channels a float weight tile (wgmma: the weight
  // gradient's patch height wtt, its patches wtt x tf), splits a weight
  // tile
  int batch, tlen, flen, split, width, groups, mma, nt, tt, tf, k, ci_tile, nsplit;
  // the wgmma variant (mma is then 1 too), its ring, its weight tiles' m
  // tiles a consumer warpgroup
  int wg, ring, wmt;
  // derived
  int ft, tiles_t, pps, nslabs, bpg, hw, hpos, hs;
  // the weight gradient's tiles: float, co_tiles x ci_tiles tiles of 8
  // output by ci_tile input channels (all taps); mma, wtiles tiles of wm m
  // tiles (chunks q = 8-channel group * 9 + tap, two a m tile, nq of them)
  // by all w output channels; went floats a tile's partial, his the staged
  // halo rows' stride, nchunks first-level sums a tile
  int co_tiles, ci_tiles, wtiles, went, his;
  int nq, mtiles, wm, nchunks;
  float inv_n;
};

__host__ __device__ inline int align16(int v) { return (v + 15) / 16 * 16; }

// bf16 row stride of a staged position (as csrc/split_conv.cu:halo_stride):
// an odd multiple of 16 bytes, so the 8 rows of an mma fragment load fall
// in 8 distinct 4-bank groups
__host__ __device__ constexpr int halo_stride(int width) {
  return width + 2 * ((4 - (width / 2) % 8 + 8) % 8);
}

// bf16 row stride of the staged weights (as csrc/split_conv.cu:
// weight_stride): 8 rows of a B fragment's 32-bit loads fall in distinct
// banks
__host__ __device__ inline int weight_stride(int width) { return (9 * width + 15) / 16 * 16 + 8; }

// The Hopper design's layout (bf16, w one of 32, 48, 64, 96, 192; the
// kernels below).
constexpr int kWgThreads = 384;    // a producer warpgroup and two consumer warpgroups
constexpr int kWgStagers = 96;     // producer warps 1-3 stage the operands
constexpr int kWgConsumers = 256;
constexpr int kWgBatch = 4;        // staging items a producer thread has in flight
constexpr int kWgDrain = 4;        // write-out rows a consumer thread has in flight
constexpr unsigned long long kWaitTimeoutNs = 10000000000ull;

__host__ __device__ constexpr int cmin(int x, int y) { return x < y ? x : y; }
__host__ __device__ constexpr bool wg_width(int w) {
  return w == 32 || w == 48 || w == 64 || w == 96 || w == 192;
}
// the conv: MT 64-row m tiles a consumer warpgroup (N = w accumulators: two
// where they fit 96 registers a thread), KPS k steps of 16 a weight slice,
// wg_ksteps k steps a patch (K = 9 w)
__host__ __device__ constexpr int wg_mt(int w) { return w <= 96 ? 2 : 1; }
__host__ __device__ constexpr int wg_rows(int w) { return 128 * wg_mt(w); }
__host__ __device__ constexpr int wg_kps(int w) {
  return (wg_mt(w) == 2 && (9 * w / 16) % 2 == 0) ? 2 : 3;
}
__host__ __device__ constexpr int wg_ksteps(int w) { return 9 * w / 16; }
__host__ __device__ constexpr int wg_slice_bytes(int w) { return wg_kps(w) * 16 * w * 2; }
// the weights' slices; at w <= 64 all of them stay resident (the ring has
// one slot a slice, each filled once: 18, 41 and 72 KB), wider groups
// stream them through a ring of fewer slots every patch
__host__ __device__ constexpr int wg_slices(int w) { return wg_ksteps(w) / wg_kps(w); }
__host__ __device__ constexpr bool wg_resident(int w) { return w <= 64; }
// the weight gradient: 64-row m tiles of (chunk q = 8-channel group * 9 +
// tap, input channel) rows by N = w output channels, WMT a warpgroup, three
// warpgroups a tile (as many as 96 accumulator registers a thread hold, and
// no more than the 9 w rows need); a tile's chunks span at most NC8
// 8-channel groups of in_i
__host__ __device__ constexpr int wg_mtiles(int w) { return (9 * w / 8 + 7) / 8; }
__host__ __device__ constexpr int wg_wmt(int w) { return cmin(192 / w, (wg_mtiles(w) + 2) / 3); }
__host__ __device__ constexpr int wg_nc8(int w) { return cmin(w / 8, (24 * wg_wmt(w) - 1) / 9 + 2); }
__host__ __device__ constexpr int wg_pr(int rows) { return (rows + 15) / 16 * 16; }

// Shared memory of the conv launches: the weight ring, two halo stages, the
// consumers' slab-sum buffer (16 floats a thread), the mbarriers.
__host__ __device__ inline int wg_conv_smem(int w, int hpos, int ring) {
  return ring * wg_slice_bytes(w) + 2 * align16(hpos * halo_stride(w) * 2) +
         kWgConsumers * 16 * 4 + (4 + 2 * ring) * 8;
}

// The mma variant's raw buffer (MmaRaw) for `items` staging items: two
// 16-byte rows each, the BN parameters (6, w) and the mask rows (tt + 2).
__host__ __device__ inline int mma_raw_bytes(const Plan& g, int items) {
  return 32 * items + 4 * (6 * g.width + g.tt + 2);
}

// Shared memory of the conv launches: the halo patch (bf16 at the padded
// stride, or float at an odd stride), the float variant's weight chunk (9 w
// rows of 8 output channels), the warps' sums (2, 4, w), the slab's sums
// (2, w); the mma variant's staged (w, 9 w) weights (at most 11 KB) and its
// raw buffer (hpos w / 8 items).
__host__ __device__ inline int conv_weights_offset(const Plan& g) {
  const int halo = g.mma ? align16(g.hpos * g.hs * 2) : align16(g.hpos * g.hs * 4);
  const int wchunk = g.mma ? 0 : 9 * g.width * kCoTile * 4;
  return align16(halo + wchunk + 4 * 10 * g.width);
}
__host__ __device__ inline int mma_raw_offset(const Plan& g) {
  return conv_weights_offset(g) + 2 * g.width * weight_stride(g.width);
}
inline int conv_smem(const Plan& g) {
  return g.mma ? mma_raw_offset(g) + mma_raw_bytes(g, g.hpos * (g.width / 8))
               : conv_weights_offset(g);
}

// Shared memory of the weight-gradient role: dz at the patch's positions
// ((tt * tf, 8) floats; mma: 128 rows of all w output channels in bf16)
// and in_i's halo for the tile's input channels (hpos, his; mma: all w,
// then the raw buffer of 128 + hpos rows of w / 8 items).
__host__ __device__ inline int wgrad_raw_offset(const Plan& g) {
  return align16(2 * kThreads * g.hs) + align16(2 * g.hpos * g.his);
}
inline int wgrad_smem(const Plan& g) {
  if (g.mma) return wgrad_raw_offset(g) + mma_raw_bytes(g, (kThreads + g.hpos) * (g.width / 8));
  return 4 * (g.tt * g.tf * kCoTile + g.hpos * g.his);
}

// the statistics launch's reduction buffers: two channel slots of a thread
// (the scalar kernel), or 8 channels (bf16 at w % 8 == 0), by two sums
constexpr int kStatsSmem = 4 * 2 * 2 * kThreads;
constexpr int kStatsVecSmem = 4 * 2 * 8 * kThreads;

bool make_plan(const int* p, Plan* g) {
  g->batch = p[0]; g->tlen = p[1]; g->flen = p[2]; g->split = p[3]; g->width = p[4];
  g->groups = p[5]; g->wg = p[6] == 2; g->mma = p[6] != 0; g->nt = p[7]; g->tt = p[8];
  g->tf = p[9]; g->k = p[10]; g->ci_tile = p[11]; g->nsplit = p[12];
  const int w = g->width;
  if (p[6] < 0 || p[6] > 2 || g->batch <= 0 || g->tlen <= 0 || g->flen <= 0 || g->split < 2 ||
      w <= 0 || w > 256 || g->groups <= 0 || g->batch % g->groups || g->tt <= 0 || g->tf <= 0 ||
      g->tf > g->flen || g->k <= 0 || g->nsplit <= 0)
    return false;
  if (g->wg) {
    if (!wg_width(w) || g->tt * g->tf > wg_rows(w) ||
        (wg_resident(w) ? g->nt != wg_slices(w) : g->nt < 2 || g->nt >= wg_slices(w)) ||
        g->ci_tile < 1 || g->ci_tile > g->tlen || g->ci_tile * g->tf > 256)
      return false;
    g->ring = g->nt;
    g->wmt = wg_wmt(w);
  } else if (g->tt * g->tf > kThreads || g->ci_tile <= 0 || g->ci_tile > 64 ||
             9 * g->ci_tile > kMaxPairs * kThreads) {
    return false;
  }
  if (g->mma && !g->wg && (w % 8 || w > 8 * kMmaNt || g->nt != w / 8)) return false;
  g->ft = (g->flen + g->tf - 1) / g->tf;
  g->tiles_t = (g->tlen + g->tt - 1) / g->tt;
  g->pps = g->tiles_t * g->ft;
  if (g->k > g->pps) return false;
  g->nslabs = g->batch * g->k;
  g->bpg = g->batch / g->groups;
  g->hw = g->tf + 2;
  g->hpos = (g->tt + 2) * g->hw;
  g->hs = g->mma ? halo_stride(w) : (w | 1);
  if (g->wg) {
    g->nq = 9 * (w / 8);
    g->mtiles = wg_mtiles(w);
    g->wtiles = (g->mtiles + 3 * g->wmt - 1) / (3 * g->wmt);
    g->went = 192 * g->wmt * w;
  } else if (g->mma) {
    g->nq = 9 * (w / 8);
    g->mtiles = (g->nq + 1) / 2;
    g->wtiles = (g->mtiles + kWgMTiles - 1) / kWgMTiles;
    g->wm = (g->mtiles + g->wtiles - 1) / g->wtiles;
    g->went = g->wm * 16 * w;
    g->his = g->hs;
  } else {
    g->co_tiles = (w + kCoTile - 1) / kCoTile;
    g->ci_tiles = (w + g->ci_tile - 1) / g->ci_tile;
    g->wtiles = g->co_tiles * g->ci_tiles;
    g->went = 9 * g->ci_tile * kCoTile;
    g->his = g->ci_tile | 1;
  }
  g->nchunks = (g->nsplit + kSplitChunk - 1) / kSplitChunk;
  g->inv_n = 1.f / static_cast<float>(static_cast<long long>(g->bpg) * g->tlen * g->flen);
  return true;
}

template <typename T>
struct Args {
  Plan g;
  int i;
  float eps, mom, upd_mean, upd_var;
  const T* x;            // (B, T, F, s w)
  const T* zprev;        // z_{i-1} (B, T, F, w); null at i = 0
  const float* sprev;    // group i-1's (mean, rstd, var), (3, G, w); null at i = 0
  const float* mask;     // (B, T) 0/1, or null
  const T* wk;           // the group's weights, (w, 9 w): [out][tap][in] (flipped for dgrad)
  T* z;                  // z_i: written by the forward, read by the backward
  float* stats;          // group i's (mean, rstd, var), (3, G, w)
  float* run_mean;       // group i's running statistics, or null (no update)
  float* run_var;
  T* out;                // (B, T, F, s w)
  float* part;           // the slabs' partials, (nslabs, 2, w)
  int* ticket;           // zero before a launch, left zero
  const T* dout;         // (B, T, F, s w)
  T* dx;                 // (B, T, F, s w)
  T* dy;                 // the masked upstream gradient d_i, (B, T, F, w)
  float* bsums;          // mean(d), mean(d xhat) per (BN group, channel), (2, G, w)
  T* dy_prev;            // K9b's grad launch i > 0: d_{i-1}, written (the other buffer)
  float* bsums_prev;     // and its sums, written by the launch's last dgrad CTA
  int ndg;               // the grad launch's dgrad CTAs (the rest: weight gradient)
  T* dweight;            // (w (s-1), w, 3, 3), OIHW
  float* wpart;          // (wtiles, nsplit, went)
  int* wtickets;         // wtiles ints, zero before a launch, left zero
};

// The phase profile (a build with -DVSV_K9_PROF, scripts/profile_k9.py):
// one thread of each role laps clock64 into its phases and adds them, once
// at its end, to g_k9_prof[role][slot]. Roles: forward, statistics, dgrad,
// weight gradient; slots: kProfSlots. Without the flag every call is empty.
enum { kRoleFwd, kRoleStats, kRoleDgrad, kRoleWgrad, kProfRoles };
enum { kPhStage, kPhMma, kPhEpilogue, kPhSums, kPhReduce, kPhWeights, kPhProduce,
       kPhProduceWait, kPhPatches, kPhCtas, kProfSlots };
#ifdef VSV_K9_PROF
__device__ unsigned long long g_k9_prof[kProfRoles * kProfSlots];
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
  __device__ void flush(int role, bool cta = true) {
    if (!on) return;
    v[kPhCtas] = cta ? 1 : 0;
    for (int i = 0; i < kProfSlots; ++i) atomicAdd(&g_k9_prof[role * kProfSlots + i], v[i]);
  }
};
#else
struct Prof {
  __device__ explicit Prof(bool) {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void count(int) {}
  __device__ __forceinline__ void flush(int, bool = true) {}
};
#endif

__device__ __forceinline__ long long pos_index(const Plan& g, int b, int t, int f) {
  return (static_cast<long long>(b) * g.tlen + t) * g.flen + f;
}

// y at one element: relu of the normalized value rounded to T. The forward
// (y_{i-1} in the staging, y_{s-2} in the finishing launch) and the
// backward's relu decision all use this expression.
template <typename T>
__device__ __forceinline__ float bn_relu(float z, float mu, float rs) {
  return fmaxf(vsv::round_to<T>((z - mu) * rs), 0.f);
}

__device__ __forceinline__ void unpack8(const uint4 q, float* v) {
  const unsigned int u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  unsigned int u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    u[j] = *reinterpret_cast<unsigned int*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// in_i at one element of a valid position p of sample b (time t), and
// y_{i-1} there (unmasked; i > 0)
template <typename T>
__device__ __forceinline__ float in_value(const Args<T>& a, int b, int t, long long p, int c,
                                          float* y) {
  const Plan& g = a.g;
  const int w = g.width;
  float v = vsv::to_f(a.x[p * (g.split * w) + a.i * w + c]);
  if (a.i > 0) {
    const int gi = (b / g.bpg) * w + c, gw = g.groups * w;
    *y = bn_relu<T>(vsv::to_f(a.zprev[p * w + c]), a.sprev[gi], a.sprev[gw + gi]);
    const float mk = a.mask != nullptr ? a.mask[static_cast<long long>(b) * g.tlen + t] : 1.f;
    v = vsv::round_to<T>(v + *y * mk);
  }
  return v;
}

// K9b's folded statistics: d_{i-1} at one element, from dout_{i-1}, dIn_i
// (as written to dx, rounded) and z_{i-1}: (dout + mask dIn) rounded to T,
// times the forward's own relu decision of y_{i-1} (bn_relu); xh the
// normalized z_{i-1} for the sum of d xhat.
template <typename T>
__device__ __forceinline__ float fold_d(float dout, float din, float mk, float z, float mu,
                                        float rs, float* xh) {
  const float d = vsv::round_to<T>(dout + mk * din);
  *xh = (z - mu) * rs;
  return bn_relu<T>(z, mu, rs) > 0.f ? d : 0.f;
}

// dz_i at one element of a valid position p of sample b, rounded to T
template <typename T>
__device__ __forceinline__ float dz_value(const Args<T>& a, int b, long long p, int c) {
  const Plan& g = a.g;
  const int w = g.width, gi = (b / g.bpg) * w + c, gw = g.groups * w;
  const float mu = a.stats[gi], rs = a.stats[gw + gi];
  const float xh = (vsv::to_f(a.z[p * w + c]) - mu) * rs;
  const float d = vsv::to_f(a.dy[p * w + c]);
  return vsv::round_to<T>(rs * __fmaf_rn(-xh, a.bsums[gw + gi], d - a.bsums[gi]));
}

constexpr int kBatch = 2;  // staging items a thread loads together

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four (two) 8 x 8 bf16 matrices of shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// 16 (4) bytes from global into shared memory by cp.async; an invalid
// 16-byte copy fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The mma variant's staging (w = 8, 16, 24). Every thread copies its
// items' rows of the next patch by cp.async while the current patch's MMAs
// and epilogue run: two 16-byte rows an item (x_i and z_{i-1} behind 8
// channels of in_i, or z_i and d_i behind 8 channels of dz_i; none outside
// the grid), with the BN parameters of the patch's BN group and its mask
// rows; after a barrier the same threads convert them into the operand in
// shared memory. The raw buffer: the items' first rows, their second rows,
// the parameters (6, w): group i-1's mean and rstd (in_i), group i's mean,
// rstd, mean(d) and mean(d xhat) (dz_i), and the mask at rows t0 - 1 .. t0
// + tt.
struct MmaRaw {
  uint4* a;
  uint4* b;
  float* par;
  float* msk;
};

__device__ __forceinline__ MmaRaw mma_raw(unsigned char* p, const Plan& g, int items) {
  MmaRaw r;
  r.a = reinterpret_cast<uint4*>(p);
  r.b = r.a + items;
  r.par = reinterpret_cast<float*>(r.b + items);
  r.msk = r.par + 6 * g.width;
  return r;
}

// the parameters of sample b's BN group: in_i's with the mask rows of the
// patch at t0 (IN), dz_i's (DZ)
template <bool IN, bool DZ>
__device__ void par_copy(const Args<bf16>& a, const MmaRaw& r, int b, int t0) {
  const Plan& g = a.g;
  const int w = g.width, gw = g.groups * w, gb = (b / g.bpg) * w;
  if (IN && a.i > 0) {
    for (int e = threadIdx.x; e < 2 * w; e += kThreads)
      cp_async4(r.par + e, a.sprev + (e / w) * gw + gb + e % w);
    if (a.mask != nullptr) {
      for (int e = threadIdx.x; e < g.tt + 2; e += kThreads) {
        const int t = min(max(t0 - 1 + e, 0), g.tlen - 1);  // rows outside the grid: unused
        cp_async4(r.msk + e, a.mask + static_cast<long long>(b) * g.tlen + t);
      }
    }
  }
  if (DZ) {
    for (int e = threadIdx.x; e < 4 * w; e += kThreads) {
      const int k = e / w;
      cp_async4(r.par + 2 * w + e,
                (k < 2 ? a.stats + k * gw : a.bsums + (k - 2) * gw) + gb + e % w);
    }
  }
}

// item e's rows at position p, channels [c0, c0 + 8): in_i's, dz_i's
__device__ __forceinline__ void in_copy(const Args<bf16>& a, const MmaRaw& r, int e, long long p,
                                        int c0) {
  const int w = a.g.width;
  cp_async16(r.a + e, a.x + p * (a.g.split * w) + a.i * w + c0, true);
  if (a.i > 0) cp_async16(r.b + e, a.zprev + p * w + c0, true);
}
__device__ __forceinline__ void dz_copy(const Args<bf16>& a, const MmaRaw& r, int e, long long p,
                                        int c0) {
  const int w = a.g.width;
  cp_async16(r.a + e, a.z + p * w + c0, true);
  cp_async16(r.b + e, a.dy + p * w + c0, true);
}

// in_i at item e (8 channels from c0 of a valid position, its mask value
// mk), and y_{i-1} there into y (i > 0)
__device__ __forceinline__ void in_convert(const Args<bf16>& a, const MmaRaw& r, int e, int c0,
                                           float mk, float* v, float* y) {
  const int w = a.g.width;
  unpack8(r.a[e], v);
  if (a.i > 0) {
    float zv[8];
    unpack8(r.b[e], zv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[j] = bn_relu<bf16>(zv[j], r.par[c0 + j], r.par[w + c0 + j]);
      v[j] = vsv::round_to<bf16>(v[j] + y[j] * mk);
    }
  }
}

// dz_i at item e (8 channels from c0 of a valid position), rounded to bf16
__device__ __forceinline__ void dz_convert(const Args<bf16>& a, const MmaRaw& r, int e, int c0,
                                           float* v) {
  const int w = a.g.width;
  const float* p = r.par + 2 * w + c0;
  float zv[8], d[8];
  unpack8(r.a[e], zv);
  unpack8(r.b[e], d);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float mu = p[j], rs = p[w + j];
    const float xh = (zv[j] - mu) * rs;
    v[j] = vsv::round_to<bf16>(rs * __fmaf_rn(-xh, p[3 * w + j], d[j] - p[2 * w + j]));
  }
}

// The conv's halo patch at (t0, f0) of sample b: halo_copy issues its rows
// (one commit group); halo_convert, once they landed, writes the halo at
// the stride hs: in_i (DZ false; y_{i-1} also goes to the output's slice
// i-1 at the patch's own positions) or dz_i (DZ true), zero outside the
// grid.
template <bool DZ>
__device__ void halo_copy(const Args<bf16>& a, const MmaRaw& r, int b, int t0, int f0) {
  const Plan& g = a.g;
  const int c8 = g.width / 8, n = g.hpos * c8, hw = g.hw;
  par_copy<!DZ, DZ>(a, r, b, t0);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int q = e / c8, c0 = (e % c8) * 8, t = t0 - 1 + q / hw, f = f0 - 1 + q % hw;
    if (t >= 0 && t < g.tlen && f >= 0 && f < g.flen) {
      if constexpr (DZ) dz_copy(a, r, e, pos_index(g, b, t, f), c0);
      else in_copy(a, r, e, pos_index(g, b, t, f), c0);
    }
  }
  cp_async_commit();
}

template <bool DZ>
__device__ void halo_convert(const Args<bf16>& a, const MmaRaw& r, bf16* halo, int b, int t0,
                             int f0) {
  const Plan& g = a.g;
  const int w = g.width, c8 = w / 8, n = g.hpos * c8, hw = g.hw, C = g.split * w;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int q = e / c8, c0 = (e % c8) * 8, qt = q / hw, qf = q % hw;
    const int t = t0 - 1 + qt, f = f0 - 1 + qf;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t >= 0 && t < g.tlen && f >= 0 && f < g.flen) {
      if constexpr (DZ) {
        dz_convert(a, r, e, c0, v);
      } else {
        float y[8];
        in_convert(a, r, e, c0, a.mask != nullptr ? r.msk[qt] : 1.f, v, y);
        if (a.i > 0 && qt >= 1 && qt <= g.tt && qf >= 1 && qf <= g.tf)
          *reinterpret_cast<uint4*>(a.out + pos_index(g, b, t, f) * C + (a.i - 1) * w + c0) =
              pack8(y);
      }
    }
    *reinterpret_cast<uint4*>(halo + q * g.hs + c0) = pack8(v);
  }
}

// The float variant's halo patch at (t0, f0) of sample b, staged as floats
// at an odd stride: in_i (DZ false; y_{i-1} then goes to the output's slice
// i-1 at the patch's own positions) or dz_i (DZ true); zero outside the
// grid.
template <typename T, bool DZ>
__device__ void stage_halo(const Args<T>& a, unsigned char* smem, int b, int t0, int f0) {
  const Plan& g = a.g;
  const int w = g.width, C = g.split * w, hw = g.hw;
  float* halo = reinterpret_cast<float*>(smem);
  for (int idx = threadIdx.x; idx < g.hpos * w; idx += kThreads) {
    const int q = idx / w, c = idx % w, qt = q / hw, qf = q % hw;
    const int t = t0 - 1 + qt, f = f0 - 1 + qf;
    float v = 0.f;
    if (t >= 0 && t < g.tlen && f >= 0 && f < g.flen) {
      const long long p = pos_index(g, b, t, f);
      if constexpr (DZ) {
        v = dz_value(a, b, p, c);
      } else {
        float y = 0.f;
        v = in_value(a, b, t, p, c, &y);
        if (a.i > 0 && qt >= 1 && qt <= g.tt && qf >= 1 && qf <= g.tf)
          a.out[p * C + (a.i - 1) * w + c] = vsv::from_f<T>(y);
      }
    }
    halo[q * g.hs + c] = v;
  }
}

// The conv of the staged patch at (t0, f0) of sample b with the (w, 9 w)
// weight rows staged in shared memory, all w = 8 NT output channels. EPI 0
// (forward): z_i rounded to bf16 into a.z, and its sum and sum of squares
// per channel over the patch's valid positions added to the slab's sums
// (fixed order: lanes by a shuffle tree, then warps in order); EPI 1
// (dgrad): dIn_i rounded to bf16 into dx's slice i and, for i > 0, the
// folded statistics of group i-1: d_{i-1} (fold_d) into a.dy_prev, its sum
// and sum of d xhat added to the slab's sums as EPI 0's.
template <int NT, int EPI>
__device__ void conv_mma(const Args<bf16>& a, unsigned char* smem, float* red, float* sums, int b,
                         int t0, int f0, Prof& pf) {
  const Plan& g = a.g;
  const bf16* halo = reinterpret_cast<const bf16*>(smem);
  const bf16* wk = reinterpret_cast<const bf16*>(smem + conv_weights_offset(g));
  const int wrow = weight_stride(g.width);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tg = lane % 4;
  const int w = g.width, hs = g.hs, hw = g.hw, c8 = w / 8, chunks = 9 * c8;
  const int rows = g.tt * g.tf, C = g.split * w;
  const bool fold = EPI == 1 && a.i > 0;
  const int gb = (b / g.bpg) * w, gw = g.groups * w;
  int qrow[2][2];
  long long prow[2][2];
  bool valid[2][2];
  float mrow[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 32 + mt * 16 + gq + 8 * h;
      const int rr = min(r, rows - 1);
      qrow[mt][h] = (rr / g.tf + 1) * hw + rr % g.tf + 1;
      const int t = t0 + r / g.tf, f = f0 + r % g.tf;
      valid[mt][h] = r < rows && t < g.tlen && f < g.flen;
      prow[mt][h] = valid[mt][h] ? pos_index(g, b, t, f) : 0;
      mrow[mt][h] = (fold && valid[mt][h] && a.mask != nullptr)
                        ? a.mask[static_cast<long long>(b) * g.tlen + t] : 1.f;
    }
  // the folded statistics' inputs at this thread's outputs (dout_{i-1} and
  // z_{i-1}, two channels each), loaded before the MMAs hide their latency
  uint32_t dpre[2][2][NT], zpre[2][2][NT];
  if (fold) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int co = nt * 8 + 2 * tg;
          const long long pp = prow[mt][h];
          dpre[mt][h][nt] = valid[mt][h] ? *reinterpret_cast<const uint32_t*>(
              reinterpret_cast<const bf16*>(a.dout) + pp * C + (a.i - 1) * w + co) : 0u;
          zpre[mt][h][nt] = valid[mt][h] ? *reinterpret_cast<const uint32_t*>(
              reinterpret_cast<const bf16*>(a.zprev) + pp * w + co) : 0u;
        }
  }
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  const bf16* wrows = wk + gq * wrow + 2 * tg;
  for (int ks = 0; 2 * ks < chunks; ++ks) {
    int off[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = 2 * ks + h;
      live[h] = ch < chunks;
      const int tap = ch / c8;
      off[h] = ((tap / 3 - 1) * hw + tap % 3 - 1) * hs + (ch % c8) * 8 + 2 * tg;
    }
    uint32_t bfr[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* row = wrows + nt * 8 * wrow + 16 * ks;
      bfr[nt][0] = *reinterpret_cast<const uint32_t*>(row);
      bfr[nt][1] = live[1] ? *reinterpret_cast<const uint32_t*>(row + 8) : 0u;
    }
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const bf16* r0 = halo + qrow[mt][0] * hs;
      const bf16* r1 = halo + qrow[mt][1] * hs;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(r0 + off[0]);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(r1 + off[0]);
      af[mt][2] = live[1] ? *reinterpret_cast<const uint32_t*>(r0 + off[1]) : 0u;
      af[mt][3] = live[1] ? *reinterpret_cast<const uint32_t*>(r1 + off[1]) : 0u;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_bf16_16816(acc[0][nt], af[0], bfr[nt]);
      mma_bf16_16816(acc[1][nt], af[1], bfr[nt]);
    }
  }
  pf.lap(kPhMma);
  float s[NT][2], q[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = q[nt][0] = q[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[mt][h]) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = nt * 8 + 2 * tg;
        const float v0 = vsv::round_to<bf16>(acc[mt][nt][2 * h]);
        const float v1 = vsv::round_to<bf16>(acc[mt][nt][2 * h + 1]);
        if constexpr (EPI == 0) {
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(a.z) + prow[mt][h] * w + co) =
              __floats2bfloat162_rn(v0, v1);
          s[nt][0] += v0;
          s[nt][1] += v1;
          q[nt][0] += v0 * v0;
          q[nt][1] += v1 * v1;
        } else {
          const long long pp = prow[mt][h];
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(a.dx) + pp * C + a.i * w +
                                             co) = __floats2bfloat162_rn(v0, v1);
          if (fold) {
            const float2 dv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&dpre[mt][h][nt]));
            const float2 zv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&zpre[mt][h][nt]));
            float x0, x1;
            const float d0 = fold_d<bf16>(dv.x, v0, mrow[mt][h], zv.x, a.sprev[gb + co],
                                          a.sprev[gw + gb + co], &x0);
            const float d1 = fold_d<bf16>(dv.y, v1, mrow[mt][h], zv.y, a.sprev[gb + co + 1],
                                          a.sprev[gw + gb + co + 1], &x1);
            *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(a.dy_prev) + pp * w +
                                               co) = __floats2bfloat162_rn(d0, d1);
            s[nt][0] += d0;
            s[nt][1] += d1;
            q[nt][0] += d0 * x0;
            q[nt][1] += d1 * x1;
          }
        }
      }
    }
  if (EPI == 0 || fold) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o *= 2) {
          s[nt][e] += __shfl_xor_sync(0xffffffffu, s[nt][e], o);
          q[nt][e] += __shfl_xor_sync(0xffffffffu, q[nt][e], o);
        }
    if (gq == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = nt * 8 + 2 * tg + e;
          red[warp * w + co] = s[nt][e];
          red[(4 + warp) * w + co] = q[nt][e];
        }
    }
    __syncthreads();
    if (tid < w) {
      sums[tid] += ((red[tid] + red[w + tid]) + red[2 * w + tid]) + red[3 * w + tid];
      sums[w + tid] += ((red[4 * w + tid] + red[5 * w + tid]) + red[6 * w + tid]) +
                       red[7 * w + tid];
    }
    __syncthreads();
  }
  pf.lap(kPhEpilogue);
}

// The float variant of conv_mma: one thread a position, 8 output channels
// a pass, the pass's weights staged in shared memory as (9 w, 8) floats.
template <int EPI, typename T>
__device__ void conv_fma(const Args<T>& a, unsigned char* smem, float* wsm, float* red,
                         float* sums, int b, int t0, int f0, Prof& pf) {
  const Plan& g = a.g;
  const float* halo = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int w = g.width, hs = g.hs, hw = g.hw, rows = g.tt * g.tf, C = g.split * w;
  const int r = tid, rr = min(r, rows - 1);
  const int qr = (rr / g.tf + 1) * hw + rr % g.tf + 1;
  const int t = t0 + r / g.tf, f = f0 + r % g.tf;
  const bool valid = r < rows && t < g.tlen && f < g.flen;
  const long long p = valid ? pos_index(g, b, t, f) : 0;
  const bool fold = EPI == 1 && a.i > 0;
  const int gb = (b / g.bpg) * w, gw = g.groups * w;
  const float mk = (fold && valid && a.mask != nullptr)
                       ? a.mask[static_cast<long long>(b) * g.tlen + t] : 1.f;
  for (int n0 = 0; n0 < w; n0 += kCoTile) {
    __syncthreads();  // the previous pass is done with wsm
    for (int e = tid; e < 9 * w * kCoTile; e += kThreads) {
      const int kk = e / kCoTile, co = n0 + e % kCoTile;
      wsm[e] = co < w ? vsv::to_f(a.wk[static_cast<long long>(co) * 9 * w + kk]) : 0.f;
    }
    __syncthreads();
    float acc[kCoTile];
#pragma unroll
    for (int j = 0; j < kCoTile; ++j) acc[j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* hrow = halo + (qr + (tap / 3 - 1) * hw + tap % 3 - 1) * hs;
      const float* wrow = wsm + tap * w * kCoTile;
      for (int ci = 0; ci < w; ++ci) {
        const float av = hrow[ci];
        const float4 w0 = *reinterpret_cast<const float4*>(wrow + ci * kCoTile);
        const float4 w1 = *reinterpret_cast<const float4*>(wrow + ci * kCoTile + 4);
        acc[0] = fmaf(av, w0.x, acc[0]);
        acc[1] = fmaf(av, w0.y, acc[1]);
        acc[2] = fmaf(av, w0.z, acc[2]);
        acc[3] = fmaf(av, w0.w, acc[3]);
        acc[4] = fmaf(av, w1.x, acc[4]);
        acc[5] = fmaf(av, w1.y, acc[5]);
        acc[6] = fmaf(av, w1.z, acc[6]);
        acc[7] = fmaf(av, w1.w, acc[7]);
      }
    }
    pf.lap(kPhMma);
    float s[kCoTile], q[kCoTile];
#pragma unroll
    for (int j = 0; j < kCoTile; ++j) {
      const int co = n0 + j;
      const float v = vsv::round_to<T>(acc[j]);
      const bool live = valid && co < w;
      s[j] = live ? v : 0.f;
      q[j] = live ? v * v : 0.f;
      if (live) {
        if constexpr (EPI == 0) {
          a.z[p * w + co] = vsv::from_f<T>(v);
        } else {
          a.dx[p * C + a.i * w + co] = vsv::from_f<T>(v);
          if (fold) {
            float xh;
            const float dd = fold_d<T>(vsv::to_f(a.dout[p * C + (a.i - 1) * w + co]), v, mk,
                                       vsv::to_f(a.zprev[p * w + co]), a.sprev[gb + co],
                                       a.sprev[gw + gb + co], &xh);
            a.dy_prev[p * w + co] = vsv::from_f<T>(dd);
            s[j] = dd;
            q[j] = dd * xh;
          }
        }
      }
    }
    if (EPI == 0 || fold) {
#pragma unroll
      for (int j = 0; j < kCoTile; ++j)
#pragma unroll
        for (int o = 1; o < 32; o *= 2) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
          q[j] += __shfl_xor_sync(0xffffffffu, q[j], o);
        }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kCoTile; ++j) {
          if (n0 + j < w) {
            red[warp * w + n0 + j] = s[j];
            red[(4 + warp) * w + n0 + j] = q[j];
          }
        }
      }
      __syncthreads();
      if (tid < kCoTile && n0 + tid < w) {
        const int co = n0 + tid;
        sums[co] += ((red[co] + red[w + co]) + red[2 * w + co]) + red[3 * w + co];
        sums[w + co] += ((red[4 * w + co] + red[5 * w + co]) + red[6 * w + co]) + red[7 * w + co];
      }
    }
    pf.lap(kPhEpilogue);
  }
}

// After every CTA of a statistics launch wrote its slab's (2, w) partials:
// the last CTA to arrive (an integer ticket with fences) adds them per (BN
// group, sum, channel) in slab order. Up to 32 lanes (a power of two) share
// one sum, each taking every sub-th slab in order, joined by a fixed
// shuffle tree. FWD: publishes mean, rstd and var, then the running update
// in group order; else mean(d) and mean(d xhat) into a.bsums.
// NTH threads a CTA, `arrivals` CTAs take a ticket; mean(d) and mean(d
// xhat) go to bout.
template <bool FWD, int NTH, typename T>
__device__ void collapse(const Args<T>& a, int arrivals, float* bout) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1) == arrivals - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const Plan& g = a.g;
  const int w = g.width, gw = g.groups * w, nsg = g.bpg * g.k, pairs = g.groups * w;
  int sub = 1;
  while (sub < 32 && pairs * sub * 2 <= NTH) sub *= 2;
  const int q = threadIdx.x % sub, per = NTH / sub;
  for (int base = 0; base < pairs; base += per) {
    const int e = base + threadIdx.x / sub;
    const bool in = e < pairs;
    const int gg = in ? e / w : 0, c = e % w;
    const float* p = a.part + static_cast<long long>(gg) * nsg * 2 * w + c;
    float s1 = 0.f, s2 = 0.f;
    if (in) {
#pragma unroll 8
      for (int j = q; j < nsg; j += sub) {
        s1 += __ldcg(p + static_cast<long long>(j) * 2 * w);
        s2 += __ldcg(p + static_cast<long long>(j) * 2 * w + w);
      }
    }
    for (int o = sub / 2; o > 0; o /= 2) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (in && q == 0) {
      if constexpr (FWD) {
        const float mu = s1 * g.inv_n;
        const float var = s2 * g.inv_n - mu * mu;
        a.stats[gg * w + c] = mu;
        a.stats[gw + gg * w + c] = rsqrtf(var + a.eps);
        a.stats[2 * gw + gg * w + c] = var;
      } else {
        bout[gg * w + c] = s1 * g.inv_n;
        bout[gw + gg * w + c] = s2 * g.inv_n;
      }
    }
  }
  if constexpr (FWD) {
    if (a.run_mean != nullptr) {
      __syncthreads();
      const float inv_g = 1.f / static_cast<float>(g.groups);
      for (int c = threadIdx.x; c < w; c += NTH) {
        float msum = 0.f, vsum = 0.f;
        for (int gg = 0; gg < g.groups; ++gg) {
          msum += a.stats[gg * w + c];
          vsum += a.stats[2 * gw + gg * w + c];
        }
        a.run_mean[c] = a.mom * a.run_mean[c] + a.upd_mean * (msum * inv_g);
        a.run_var[c] = a.mom * a.run_var[c] + a.upd_var * (vsum * inv_g);
      }
    }
  }
  if (threadIdx.x == 0) atomicExch(a.ticket, 0);
}

// Copy the group's (w, 9 w) weight rows into shared memory (the mma variant).
__device__ void stage_weights(const Args<bf16>& a, unsigned char* smem) {
  const Plan& g = a.g;
  const int w = g.width, vr = 9 * w / 8, ws = weight_stride(w);
  bf16* dst = reinterpret_cast<bf16*>(smem + conv_weights_offset(g));
  for (int e = threadIdx.x; e < w * vr; e += kThreads) {
    const int co = e / vr, v = e % vr;
    *reinterpret_cast<uint4*>(dst + co * ws + 8 * v) =
        *reinterpret_cast<const uint4*>(a.wk + static_cast<long long>(co) * 9 * w + 8 * v);
  }
}

// the patch range [p0, p1) of slab sl (sample sl / k)
__device__ __forceinline__ void slab_patches(const Plan& g, int sl, int& p0, int& p1) {
  const int j = sl % g.k;
  p0 = static_cast<int>(static_cast<long long>(g.pps) * j / g.k);
  p1 = static_cast<int>(static_cast<long long>(g.pps) * (j + 1) / g.k);
}

__device__ __forceinline__ void patch_origin(const Plan& g, int pi, int& t0, int& f0) {
  t0 = (pi / g.ft) * g.tt;
  f0 = (pi % g.ft) * g.tf;
}

// The mma variant's conv role (w = 8 NT, bf16): K9's forward (EPI 0) or
// K9b's input gradient (EPI 1). Persistent CTAs [0, nctas) walk the slabs
// sl = blockIdx.x, blockIdx.x + nctas, ...; the next patch's rows are in
// flight (halo_copy) while this patch's MMAs and epilogue run. At a slab's
// end its sums go to a.part[slab] (EPI 0; EPI 1 at i > 0, the folded
// statistics).
template <int NT, int EPI>
__device__ void mma_conv_role(const Args<bf16>& a, unsigned char* smem, int nctas, Prof& pf) {
  const Plan& g = a.g;
  constexpr bool DZ = EPI == 1;
  const int w = g.width, tid = threadIdx.x, C = g.split * w;
  const bool sums_on = EPI == 0 || a.i > 0;
  bf16* halo = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(g.hpos * g.hs * 2));
  float* sums = red + 8 * w;
  const MmaRaw raw = mma_raw(smem + mma_raw_offset(g), g, g.hpos * NT);
  int sl = blockIdx.x, pi, p1, t0, f0;
  slab_patches(g, sl, pi, p1);
  patch_origin(g, pi, t0, f0);
  halo_copy<DZ>(a, raw, sl / g.k, t0, f0);
  for (int c = tid; c < 2 * w; c += kThreads) sums[c] = 0.f;
  stage_weights(a, smem);
  pf.lap(kPhWeights);
  for (;;) {
    const int b = sl / g.k;
    int nsl = sl, npi = pi + 1, np1 = p1, nt0 = 0, nf0 = 0;
    if (npi == p1) {
      nsl += nctas;
      if (nsl < g.nslabs) slab_patches(g, nsl, npi, np1);
    }
    const bool more = nsl < g.nslabs;
    cp_async_wait_all();
    __syncthreads();  // the rows landed; the previous patch's MMAs are done with the halo
    halo_convert<DZ>(a, raw, halo, b, t0, f0);
    __syncthreads();  // the halo is staged; the raw buffer is free
    if (more) {
      patch_origin(g, npi, nt0, nf0);
      halo_copy<DZ>(a, raw, nsl / g.k, nt0, nf0);
    }
    if (EPI == 0 && a.i == 0) {  // the pass-through last group, at the patch's positions
      for (int e = tid; e < g.tt * g.tf * NT; e += kThreads) {
        const int r = e / NT, t = t0 + r / g.tf, f = f0 + r % g.tf;
        if (t < g.tlen && f < g.flen) {
          const long long p = pos_index(g, b, t, f) * C + (g.split - 1) * w + 8 * (e % NT);
          *reinterpret_cast<uint4*>(a.out + p) = *reinterpret_cast<const uint4*>(a.x + p);
        }
      }
    }
    pf.lap(kPhStage);
    pf.count(kPhPatches);
    conv_mma<NT, EPI>(a, smem, red, sums, b, t0, f0, pf);
    if (sums_on && nsl != sl) {  // the slab's sums, ordered by conv_mma's last barrier
      float* part = a.part + static_cast<long long>(sl) * 2 * w;
      for (int c = tid; c < 2 * w; c += kThreads) {
        part[c] = sums[c];
        sums[c] = 0.f;
      }
    }
    if (!more) break;
    sl = nsl;
    pi = npi;
    p1 = np1;
    t0 = nt0;
    f0 = nf0;
  }
}

// K9, group i < s-1, the mma variant: persistent CTAs (mma_conv_role). At
// NT = 1 (w = 8: little work a patch, latency-bound) the registers are
// capped for eight CTAs an SM (faster on an H100; the wider instances lost
// time under the same cap: PERF.md).
template <int NT>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 8 : 1)
    k9_mma_fwd_kernel(const __grid_constant__ Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Prof pf(threadIdx.x == 0);
  mma_conv_role<NT, 0>(a, smem, gridDim.x, pf);
  pf.lap(kPhEpilogue);
  collapse<true, kThreads>(a, gridDim.x, nullptr);
  pf.lap(kPhSums);
  pf.flush(kRoleFwd);
}

// K9, group i < s-1, the float variant: one CTA a slab.
template <typename T>
__global__ void __launch_bounds__(kThreads) k9_fwd_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& g = a.g;
  const int w = g.width, tid = threadIdx.x, C = g.split * w;
  float* wsm = reinterpret_cast<float*>(smem + align16(g.hpos * g.hs * 4));
  float* red = wsm + 9 * w * kCoTile;
  float* sums = red + 8 * w;
  Prof pf(tid == 0);
  for (int c = tid; c < 2 * w; c += kThreads) sums[c] = 0.f;
  const int sl = blockIdx.x, b = sl / g.k;
  int p0, p1;
  slab_patches(g, sl, p0, p1);
  for (int pi = p0; pi < p1; ++pi) {
    int t0, f0;
    patch_origin(g, pi, t0, f0);
    __syncthreads();  // the previous patch's halo is consumed
    stage_halo<T, false>(a, smem, b, t0, f0);
    if (a.i == 0) {  // the pass-through last group, at the patch's positions
      for (int e = tid; e < g.tt * g.tf * w; e += kThreads) {
        const int r = e / w, t = t0 + r / g.tf, f = f0 + r % g.tf;
        if (t < g.tlen && f < g.flen) {
          const long long p = pos_index(g, b, t, f) * C + (g.split - 1) * w + e % w;
          a.out[p] = a.x[p];
        }
      }
    }
    __syncthreads();
    pf.lap(kPhStage);
    pf.count(kPhPatches);
    conv_fma<0>(a, smem, wsm, red, sums, b, t0, f0, pf);
  }
  __syncthreads();
  float* part = a.part + static_cast<long long>(sl) * 2 * w;
  for (int c = tid; c < 2 * w; c += kThreads) part[c] = sums[c];
  pf.lap(kPhEpilogue);
  collapse<true, kThreads>(a, gridDim.x, nullptr);
  pf.lap(kPhSums);
  pf.flush(kRoleFwd);
}

// K9's finishing launch: y_{s-2} = relu(BN(z_{s-2})) into slice s-2, V
// channels a thread (8: bf16 at w % 8 == 0, 16-byte accesses).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) k9_finish_kernel(const __grid_constant__ Args<T> a) {
  const Plan& g = a.g;
  const int w = g.width, C = g.split * w, gw = g.groups * w;
  const long long per_sample = static_cast<long long>(g.tlen) * g.flen * w;
  const long long total = per_sample * g.batch;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * V;
  for (long long e = (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x) * V;
       e < total; e += stride) {
    const long long p = e / w;
    const int c = static_cast<int>(e % w);
    const int gi = static_cast<int>(e / per_sample) / g.bpg * w + c;
    T* o = a.out + p * C + (g.split - 2) * w + c;
    if constexpr (V == 8) {
      float v[8];
      load8(a.z + e, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = bn_relu<T>(v[j], a.stats[gi + j], a.stats[gw + gi + j]);
      *reinterpret_cast<uint4*>(o) = pack8(v);
    } else {
      *o = vsv::from_f<T>(bn_relu<T>(vsv::to_f(a.z[e]), a.stats[gi], a.stats[gw + gi]));
    }
  }
}

// K9b (a), group i: one CTA a slab of positions; threads (rows, cols) with
// cols = min(w, 128) channels, each thread one or two channels.
template <typename T>
__global__ void __launch_bounds__(kThreads) k9b_stats_kernel(const __grid_constant__ Args<T> a) {
  __shared__ float red[2 * 2 * kThreads];
  const Plan& g = a.g;
  const int w = g.width, C = g.split * w, gw = g.groups * w, tid = threadIdx.x;
  const int cols = min(w, kThreads), rows = kThreads / cols;
  const int r = tid / cols, c = tid % cols;
  const bool active = r < rows;
  const int sl = blockIdx.x, b = sl / g.k, j = sl % g.k;
  const long long tf = static_cast<long long>(g.tlen) * g.flen;
  const long long q0 = tf * j / g.k, q1 = tf * (j + 1) / g.k;
  const int gb = (b / g.bpg) * w;
  const bool chained = a.i < g.split - 2;
  Prof pf(tid == 0);
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  if (active) {
    for (long long qq = q0 + r; qq < q1; qq += rows) {
      const int t = static_cast<int>(qq / g.flen);
      const long long p = static_cast<long long>(b) * tf + qq;
      const float mk = a.mask != nullptr ? a.mask[static_cast<long long>(b) * g.tlen + t] : 1.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = c + u * cols;
        if (cc < w) {
          float d = vsv::to_f(a.dout[p * C + a.i * w + cc]);
          if (chained) d = vsv::round_to<T>(d + mk * vsv::to_f(a.dx[p * C + (a.i + 1) * w + cc]));
          const float mu = a.stats[gb + cc], rs = a.stats[gw + gb + cc];
          const float zz = vsv::to_f(a.z[p * w + cc]);
          const float xh = (zz - mu) * rs;
          const float dd = bn_relu<T>(zz, mu, rs) > 0.f ? d : 0.f;
          a.dy[p * w + cc] = vsv::from_f<T>(dd);
          s1[u] += dd;
          s2[u] += dd * xh;
          if (!chained) {  // group s-2: dx_{s-1} = dout_{s-1}
            const long long o = p * C + (g.split - 1) * w + cc;
            a.dx[o] = a.dout[o];
          }
        }
      }
    }
  }
  pf.lap(kPhStage);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    red[(2 * u) * kThreads + tid] = s1[u];
    red[(2 * u + 1) * kThreads + tid] = s2[u];
  }
  __syncthreads();
  if (r == 0) {
    float* part = a.part + static_cast<long long>(sl) * 2 * w;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int cc = c + u * cols;
      if (cc < w) {
        float t1 = 0.f, t2 = 0.f;
        for (int rr = 0; rr < rows; ++rr) {
          t1 += red[(2 * u) * kThreads + rr * cols + c];
          t2 += red[(2 * u + 1) * kThreads + rr * cols + c];
        }
        part[cc] = t1;
        part[w + cc] = t2;
      }
    }
  }
  collapse<false, kThreads>(a, gridDim.x, a.bsums);
  pf.lap(kPhSums);
  pf.flush(kRoleStats);
}

// K9b (a) in bf16 at w % 8 == 0: threads (rows, w / 8) of 8-channel
// vectors, 16-byte loads and stores.
__global__ void __launch_bounds__(kThreads) k9b_stats_vec_kernel(
    const __grid_constant__ Args<bf16> a) {
  __shared__ float red[2 * 8 * kThreads];
  const Plan& g = a.g;
  const int w = g.width, C = g.split * w, gw = g.groups * w, tid = threadIdx.x;
  const int cols = w / 8, rows = kThreads / cols;
  const int r = tid / cols, c0 = (tid % cols) * 8;
  const int sl = blockIdx.x, b = sl / g.k, j = sl % g.k;
  const long long tf = static_cast<long long>(g.tlen) * g.flen;
  const long long q0 = tf * j / g.k, q1 = tf * (j + 1) / g.k;
  const int gb = (b / g.bpg) * w + c0;
  const bool chained = a.i < g.split - 2;
  Prof pf(tid == 0);
  float s1[8], s2[8], mu[8], rs[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s1[e] = s2[e] = 0.f;
    mu[e] = a.stats[gb + e];
    rs[e] = a.stats[gw + gb + e];
  }
  if (r < rows) {
    for (long long q = q0 + r; q < q1; q += kBatch * rows) {
      // a batch of positions' rows in flight together
      uint4 rd[kBatch], rz[kBatch], rn[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long qq = q + u * rows, p = static_cast<long long>(b) * tf + qq;
        rd[u] = rz[u] = rn[u] = make_uint4(0, 0, 0, 0);
        if (qq < q1) {
          rd[u] = *reinterpret_cast<const uint4*>(a.dout + p * C + a.i * w + c0);
          rz[u] = *reinterpret_cast<const uint4*>(a.z + p * w + c0);
          if (chained) rn[u] = *reinterpret_cast<const uint4*>(a.dx + p * C + (a.i + 1) * w + c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long qq = q + u * rows, p = static_cast<long long>(b) * tf + qq;
        if (qq >= q1) continue;
        const int t = static_cast<int>(qq / g.flen);
        float d[8], zv[8], dd[8];
        unpack8(rd[u], d);
        unpack8(rz[u], zv);
        if (chained) {
          const float mk =
              a.mask != nullptr ? a.mask[static_cast<long long>(b) * g.tlen + t] : 1.f;
          float dn[8];
          unpack8(rn[u], dn);
#pragma unroll
          for (int e = 0; e < 8; ++e) d[e] = vsv::round_to<bf16>(d[e] + mk * dn[e]);
        } else {  // group s-2: dx_{s-1} = dout_{s-1}
          const long long o = p * C + (g.split - 1) * w + c0;
          *reinterpret_cast<uint4*>(a.dx + o) = *reinterpret_cast<const uint4*>(a.dout + o);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = (zv[e] - mu[e]) * rs[e];
          dd[e] = bn_relu<bf16>(zv[e], mu[e], rs[e]) > 0.f ? d[e] : 0.f;
          s1[e] += dd[e];
          s2[e] += dd[e] * xh;
        }
        *reinterpret_cast<uint4*>(a.dy + p * w + c0) = pack8(dd);
      }
    }
  }
  pf.lap(kPhStage);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[e * kThreads + tid] = s1[e];
    red[(8 + e) * kThreads + tid] = s2[e];
  }
  __syncthreads();
  // a thread a (sum, channel): the rows in order
  float* part = a.part + static_cast<long long>(sl) * 2 * w;
  for (int e = tid; e < 2 * w; e += kThreads) {
    const int k = e / w, c = e % w, cv = c / 8, j8 = c % 8;
    const float* src = red + (8 * k + j8) * kThreads + cv;
    float t1 = 0.f;
    for (int rr = 0; rr < rows; ++rr) t1 += src[rr * cols];
    part[e] = t1;
  }
  collapse<false, kThreads>(a, gridDim.x, a.bsums);
  pf.lap(kPhSums);
  pf.flush(kRoleStats);
}

// The weight gradient, dW[co][tap][ci] = sum over positions p of dz[p][co]
// in[p + tap][ci], on the CTAs after the dgrad role's: tile wt, split sp
// (positions of patches [npat sp / nsplit, npat (sp + 1) / nsplit) of all
// patches, sample-major). Each writes its partial sums of the tile, went
// floats, into a.wpart; wgrad_reduce adds them.

// float: a thread owns up to five (tap, input channel) pairs by 8 output
// channels, dz and in_i staged as floats
template <typename T>
__device__ void wgrad_fma(const Args<T>& a, unsigned char* smem, int wt, int sp, Prof& pf) {
  const Plan& g = a.g;
  const int w = g.width, tid = threadIdx.x;
  const int co0 = (wt / g.ci_tiles) * kCoTile, ci0 = (wt % g.ci_tiles) * g.ci_tile;
  const int ck = min(g.ci_tile, w - ci0), hw = g.hw, his = g.his, rows = g.tt * g.tf;
  float* dzs = reinterpret_cast<float*>(smem);   // (rows, 8)
  float* ins = dzs + rows * kCoTile;               // (hpos, his)
  int poff[kMaxPairs];
  bool pin[kMaxPairs];
#pragma unroll
  for (int u = 0; u < kMaxPairs; ++u) {
    const int jj = tid + u * kThreads, tap = jj / g.ci_tile, cl = jj % g.ci_tile;
    pin[u] = tap < 9 && cl < ck;
    poff[u] = pin[u] ? ((tap / 3 - 1) * hw + tap % 3 - 1) * his + cl : 0;
  }
  float acc[kMaxPairs][kCoTile];
#pragma unroll
  for (int u = 0; u < kMaxPairs; ++u)
#pragma unroll
    for (int j = 0; j < kCoTile; ++j) acc[u][j] = 0.f;
  const long long npat = static_cast<long long>(g.batch) * g.pps;
  const long long a0 = npat * sp / g.nsplit, a1 = npat * (sp + 1) / g.nsplit;
  for (long long gp = a0; gp < a1; ++gp) {
    const int b = static_cast<int>(gp / g.pps), pi = static_cast<int>(gp % g.pps);
    int t0, f0;
    patch_origin(g, pi, t0, f0);
    __syncthreads();
    for (int e = tid; e < rows * kCoTile; e += kThreads) {
      const int r = e / kCoTile, co = co0 + e % kCoTile;
      const int t = t0 + r / g.tf, f = f0 + r % g.tf;
      dzs[e] = (t < g.tlen && f < g.flen && co < w) ? dz_value(a, b, pos_index(g, b, t, f), co)
                                                      : 0.f;
    }
    for (int e = tid; e < g.hpos * ck; e += kThreads) {
      const int q = e / ck, cl = e % ck;
      const int t = t0 - 1 + q / hw, f = f0 - 1 + q % hw;
      float v = 0.f;
      if (t >= 0 && t < g.tlen && f >= 0 && f < g.flen) {
        float y;
        v = in_value(a, b, t, pos_index(g, b, t, f), ci0 + cl, &y);
      }
      ins[q * his + cl] = v;
    }
    __syncthreads();
    pf.lap(kPhStage);
    pf.count(kPhPatches);
    for (int r = 0; r < rows; ++r) {
      const float4 d0 = *reinterpret_cast<const float4*>(dzs + r * kCoTile);
      const float4 d1 = *reinterpret_cast<const float4*>(dzs + r * kCoTile + 4);
      const float* hb = ins + ((r / g.tf + 1) * hw + r % g.tf + 1) * his;
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        if (!pin[u]) continue;
        const float av = hb[poff[u]];
        acc[u][0] = fmaf(av, d0.x, acc[u][0]);
        acc[u][1] = fmaf(av, d0.y, acc[u][1]);
        acc[u][2] = fmaf(av, d0.z, acc[u][2]);
        acc[u][3] = fmaf(av, d0.w, acc[u][3]);
        acc[u][4] = fmaf(av, d1.x, acc[u][4]);
        acc[u][5] = fmaf(av, d1.y, acc[u][5]);
        acc[u][6] = fmaf(av, d1.z, acc[u][6]);
        acc[u][7] = fmaf(av, d1.w, acc[u][7]);
      }
    }
    pf.lap(kPhMma);
  }
  float* mine = a.wpart + (static_cast<long long>(wt) * g.nsplit + sp) * g.went;
#pragma unroll
  for (int u = 0; u < kMaxPairs; ++u) {
    const int jj = tid + u * kThreads;
    if (jj < 9 * g.ci_tile) {
      *reinterpret_cast<float4*>(mine + jj * kCoTile) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      *reinterpret_cast<float4*>(mine + jj * kCoTile + 4) =
          make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
    }
  }
}

// bf16 at w = 8 NT, on mma.sync: D (chunk rows x output channels) += A
// (chunk rows x positions) B (positions x output channels), K = 16
// positions a step; A is in_i's halo rows shifted by the chunk's tap, B the
// staged dz rows, both taken transposed by ldmatrix. Warp j owns m tiles j
// and j + 4 of the tile, by all NT n tiles. The next patch's rows are in
// flight (cp.async, the raw buffer as the conv's) while this patch's MMAs
// run.
template <int NT>
__device__ void wgrad_mma(const Args<bf16>& a, unsigned char* smem, int wt, int sp, Prof& pf) {
  const Plan& g = a.g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mlo = wt * g.wm, mhi = min(mlo + g.wm, g.mtiles);
  const int c8lo = (2 * mlo) / 9, c8hi = (min(2 * mhi, g.nq) - 1) / 9;
  const int nc8 = c8hi - c8lo + 1;
  const int hw = g.hw, his = g.his, hsb = g.hs, rows = g.tt * g.tf;
  bf16* dzs = reinterpret_cast<bf16*>(smem);                                  // (128, hsb)
  bf16* ins = reinterpret_cast<bf16*>(smem + align16(2 * kThreads * hsb));    // (hpos, his)
  // the items: dz rows [0, 128 NT) (8 output channels each), then the
  // halo's (8 of the tile's input channels each)
  const int nd = kThreads * NT, items = nd + g.hpos * nc8;
  const MmaRaw raw = mma_raw(smem + wgrad_raw_offset(g), g, nd + g.hpos * NT);
  float acc[2][NT][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[u][n][r] = 0.f;
  // this lane's A row offsets: chunk (m tile's first or second) and its tap
  int achunk[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int m = mlo + warp + 4 * u;
    const int qa = 2 * m, qb = 2 * m + 1 < g.nq ? 2 * m + 1 : 2 * m;
    achunk[u][0] = qa;
    achunk[u][1] = qb;
  }
  const long long npat = static_cast<long long>(g.batch) * g.pps;
  const long long a0 = npat * sp / g.nsplit, a1 = npat * (sp + 1) / g.nsplit;
  // issue the rows of patch gp (sample-major)
  auto copy = [&](long long gp) {
    const int b = static_cast<int>(gp / g.pps);
    int t0, f0;
    patch_origin(g, static_cast<int>(gp % g.pps), t0, f0);
    par_copy<true, true>(a, raw, b, t0);
    for (int e = tid; e < items; e += kThreads) {
      if (e < nd) {
        const int r = e / NT, t = t0 + r / g.tf, f = f0 + r % g.tf;
        if (r < rows && t < g.tlen && f < g.flen)
          dz_copy(a, raw, e, pos_index(g, b, t, f), 8 * (e % NT));
      } else {
        const int q = (e - nd) / nc8, t = t0 - 1 + q / hw, f = f0 - 1 + q % hw;
        if (t >= 0 && t < g.tlen && f >= 0 && f < g.flen)
          in_copy(a, raw, e, pos_index(g, b, t, f), 8 * (c8lo + (e - nd) % nc8));
      }
    }
    cp_async_commit();
  };
  if (a0 < a1) copy(a0);
  for (long long gp = a0; gp < a1; ++gp) {
    int t0, f0;
    patch_origin(g, static_cast<int>(gp % g.pps), t0, f0);
    cp_async_wait_all();
    __syncthreads();  // the rows landed; the previous patch's MMAs are done with dzs and ins
    // dz at the patch's positions, zero rows past the patch or the grid;
    // in_i's halo of the tile's input channels, zero outside the grid
    for (int e = tid; e < items; e += kThreads) {
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (e < nd) {
        const int r = e / NT, nn = e % NT, t = t0 + r / g.tf, f = f0 + r % g.tf;
        if (r < rows && t < g.tlen && f < g.flen) dz_convert(a, raw, e, 8 * nn, v);
        *reinterpret_cast<uint4*>(dzs + r * hsb + 8 * nn) = pack8(v);
      } else {
        const int q = (e - nd) / nc8, c = (e - nd) % nc8, qt = q / hw;
        const int t = t0 - 1 + qt, f = f0 - 1 + q % hw;
        if (t >= 0 && t < g.tlen && f >= 0 && f < g.flen) {
          float y[8];
          in_convert(a, raw, e, 8 * (c8lo + c), a.mask != nullptr ? raw.msk[qt] : 1.f, v, y);
        }
        *reinterpret_cast<uint4*>(ins + q * his + 8 * c) = pack8(v);
      }
    }
    __syncthreads();  // the operands are staged; the raw buffer is free
    if (gp + 1 < a1) copy(gp + 1);
    pf.lap(kPhStage);
    pf.count(kPhPatches);
    for (int ks = 0; 16 * ks < rows; ++ks) {
      uint32_t bfr[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        ldsm_x2_trans(bfr[n], dzs + (16 * ks + (lane & 15)) * hsb + 8 * n);
      // lane: matrix lane / 8 (its chunk: the m tile's first or second;
      // positions 0-7 or 8-15 of the step), row lane % 8
      const int mi = lane / 8, r = min(16 * ks + (mi / 2) * 8 + lane % 8, rows - 1);
      const int hrow = (r / g.tf + 1) * hw + r % g.tf + 1;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (mlo + warp + 4 * u >= mhi) continue;
        const int q = achunk[u][mi & 1], tap = q % 9;
        uint32_t af[4];
        ldsm_x4_trans(af, ins + (hrow + (tap / 3 - 1) * hw + tap % 3 - 1) * his +
                              8 * (q / 9 - c8lo));
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16_16816(acc[u][n], af, bfr[n]);
      }
    }
    pf.lap(kPhMma);
  }
  // the partial: entry ((m - mlo) * 16 + row) * w + n * 8 + col; zero for m
  // tiles past the tile
  const int gq = lane / 4, tg = lane % 4, stride = 8 * NT;
  float* mine = a.wpart + (static_cast<long long>(wt) * g.nsplit + sp) * g.went;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int ml = warp + 4 * u;
    if (ml >= g.wm) continue;
    const bool live = mlo + ml < mhi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(mine + (ml * 16 + gq + 8 * h) * stride + n * 8 + 2 * tg) =
            live ? make_float2(acc[u][n][2 * h], acc[u][n][2 * h + 1]) : make_float2(0.f, 0.f);
    }
  }
}

// After each weight-gradient CTA wrote its partial: the last of each run
// of kSplitChunk splits (an integer ticket with fences) adds the run's
// partials in split order into the run's first slot; the last run to
// finish adds the runs' sums in order and writes the tile's dW_i entries
// in the dtype. Tickets: nchunks + 1 a tile, left zero.
// MODE: 0 the float tiles, 1 the mma.sync tiles, 2 the wgmma tiles (rows
// (chunk q = 8-channel group * 9 + tap, channel) by w output channels); NTH
// threads a CTA.
template <int MODE, int NTH, typename T>
__device__ void wgrad_reduce(const Args<T>& a, int wt, int sp) {
  __shared__ int last;
  const Plan& g = a.g;
  const int tid = threadIdx.x, went4 = g.went / 4;
  int* tk = a.wtickets + wt * (g.nchunks + 1);
  const int chunk = sp / kSplitChunk, c0 = chunk * kSplitChunk;
  const int c1 = min(c0 + kSplitChunk, g.nsplit);
  float4* base = reinterpret_cast<float4*>(a.wpart + static_cast<long long>(wt) * g.nsplit *
                                                         g.went);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tk + chunk, 1) == c1 - c0 - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e4 = tid; e4 < went4; e4 += NTH) {
    float4 s = __ldcg(base + static_cast<long long>(c0) * went4 + e4);
#pragma unroll 8
    for (int j = c0 + 1; j < c1; ++j) {
      const float4 v = __ldcg(base + static_cast<long long>(j) * went4 + e4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    base[static_cast<long long>(c0) * went4 + e4] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    atomicExch(tk + chunk, 0);
    last = atomicAdd(tk + g.nchunks, 1) == g.nchunks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int w = g.width;
  for (int e4 = tid; e4 < went4; e4 += NTH) {
    float4 s = __ldcg(base + e4);
    for (int c = 1; c < g.nchunks; ++c) {
      const float4 v = __ldcg(base + static_cast<long long>(c) * kSplitChunk * went4 + e4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float vals[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = 4 * e4 + m;
      int co, ci, tap;
      bool ok;
      if constexpr (MODE == 2) {
        const int row = e / w, q = wt * 24 * g.wmt + row / 8;
        co = e % w;
        ci = 8 * (q / 9) + row % 8;
        tap = q % 9;
        ok = q < g.nq;
      } else if constexpr (MODE == 1) {
        const int ml = e / (16 * w), row = (e / w) % 16, mt = wt * g.wm + ml;
        const int q = 2 * mt + row / 8;
        co = e % w;
        ci = 8 * (q / 9) + row % 8;
        tap = q % 9;
        ok = mt < g.mtiles && q < g.nq;
      } else {
        const int jj = e / kCoTile, cl = jj % g.ci_tile, ci0 = (wt % g.ci_tiles) * g.ci_tile;
        co = (wt / g.ci_tiles) * kCoTile + e % kCoTile;
        ci = ci0 + cl;
        tap = jj / g.ci_tile;
        ok = co < w && ci < w;
      }
      if (ok)
        a.dweight[(static_cast<long long>(a.i * w + co) * w + ci) * 9 + tap] =
            vsv::from_f<T>(vals[m]);
    }
  }
  if (tid == 0) atomicExch(tk + g.nchunks, 0);
}

// K9b (b), group i, the mma variant: CTAs [0, a.ndg) the dgrad role
// (persistent, mma_conv_role; for i > 0 with group i-1's statistics folded
// in: the slabs' partials, and the last of the ndg CTAs adds them into
// a.bsums_prev), the rest the weight gradient's (tile wt, split sp).
template <int NT>
__global__ void __launch_bounds__(kThreads)
    k9b_mma_grad_kernel(const __grid_constant__ Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Prof pf(threadIdx.x == 0);
  if (static_cast<int>(blockIdx.x) < a.ndg) {
    mma_conv_role<NT, 1>(a, smem, a.ndg, pf);
    if (a.i > 0) {
      collapse<false, kThreads>(a, a.ndg, a.bsums_prev);
      pf.lap(kPhSums);
    }
    pf.flush(kRoleDgrad);
    return;
  }
  const int wb = blockIdx.x - a.ndg, wt = wb / a.g.nsplit, sp = wb % a.g.nsplit;
  wgrad_mma<NT>(a, smem, wt, sp, pf);
  pf.lap(kPhEpilogue);
  wgrad_reduce<1, kThreads>(a, wt, sp);
  pf.lap(kPhReduce);
  pf.flush(kRoleWgrad);
}

// K9b (b), group i, the float variant: CTAs [0, nslabs) the dgrad role (one
// a slab; for i > 0 with group i-1's statistics folded in: the slab's
// partials, and the last of the nslabs CTAs adds them into a.bsums_prev),
// the rest the weight gradient's (tile wt, split sp).
template <typename T>
__global__ void __launch_bounds__(kThreads) k9b_grad_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& g = a.g;
  const int w = g.width, tid = threadIdx.x;
  Prof pf(tid == 0);
  if (static_cast<int>(blockIdx.x) < g.nslabs) {
    float* wsm = reinterpret_cast<float*>(smem + align16(g.hpos * g.hs * 4));
    float* red = wsm + 9 * w * kCoTile;
    float* sums = red + 8 * w;
    for (int c = tid; c < 2 * w; c += kThreads) sums[c] = 0.f;
    const int sl = blockIdx.x, b = sl / g.k;
    int p0, p1;
    slab_patches(g, sl, p0, p1);
    for (int pi = p0; pi < p1; ++pi) {
      int t0, f0;
      patch_origin(g, pi, t0, f0);
      __syncthreads();
      stage_halo<T, true>(a, smem, b, t0, f0);
      __syncthreads();
      pf.lap(kPhStage);
      pf.count(kPhPatches);
      conv_fma<1>(a, smem, wsm, red, sums, b, t0, f0, pf);
    }
    if (a.i > 0) {
      __syncthreads();
      float* part = a.part + static_cast<long long>(sl) * 2 * w;
      for (int c = tid; c < 2 * w; c += kThreads) part[c] = sums[c];
      collapse<false, kThreads>(a, g.nslabs, a.bsums_prev);
      pf.lap(kPhSums);
    }
    pf.flush(kRoleDgrad);
    return;
  }
  const int wb = blockIdx.x - g.nslabs, wt = wb / g.nsplit, sp = wb % g.nsplit;
  wgrad_fma(a, smem, wt, sp, pf);
  pf.lap(kPhEpilogue);
  wgrad_reduce<0, kThreads>(a, wt, sp);
  pf.lap(kPhReduce);
  pf.flush(kRoleWgrad);
}

template <typename T>
Args<T> make_args(const Plan& g, int i) {
  Args<T> a;
  memset(&a, 0, sizeof(a));
  a.g = g;
  a.i = i;
  return a;
}

int set_smem(const void* fn, int smem) {
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem));
}

// ---------------------------------------------------------------------------
// The Hopper design (bf16, w one of 32, 48, 64, 96, 192): warp-specialized
// persistent CTAs on wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// A wait that lasts 10 s means a role stopped feeding its stage: trap (a
// launch error) rather than hang the card.
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// One weight slice of a consumer warpgroup's patch (as csrc/split_conv.cu:
// wgmma_slice): KPS k steps of 16 input channels inside one tap, the A
// fragments by ldmatrix from the staged patch, then, once the slice has
// landed in the ring, its wgmmas; the ring stage is released when they are
// done. `n` counts the slices taken (the ring's position and phase).
template <int W>
__device__ __forceinline__ void wg_slice(float (&acc)[wg_mt(W)][W / 2],
                                         uint32_t (&af)[wg_kps(W)][wg_mt(W)][4], int sl, int& n,
                                         uint32_t xbase, const int (&arow)[wg_mt(W)], int hw,
                                         int ring, uint64_t* wfull, uint64_t* wempty,
                                         const unsigned char* wring) {
  constexpr int HS = halo_stride(W), MT = wg_mt(W), KPS = wg_kps(W);
  const int half = 8 * ((threadIdx.x % 32) / 16);
#pragma unroll
  for (int kk = 0; kk < KPS; ++kk) {
    // this lane's 8 K indices from k0 = tap * w + channel
    const int k0 = 16 * (sl * KPS + kk) + half, tap = k0 / W;
    const int off = ((tap / 3 - 1) * hw + tap % 3 - 1) * HS + k0 % W;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(af[kk][mt], xbase + 2 * (arow[mt] + off));
  }
  // resident weights: slot sl holds slice sl, landed once
  constexpr bool resident = wg_resident(W);
  const int st = resident ? sl : n % ring;
  mbar_wait_bounded(&wfull[st], resident ? 0 : (n / ring) & 1);
  const uint32_t wb = smem_u32(wring + st * wg_slice_bytes(W));
  uint64_t desc[KPS];
#pragma unroll
  for (int kk = 0; kk < KPS; ++kk) desc[kk] = vsv::wgmma_desc(wb + kk * 2 * 16 * W, 16 * W, 128);
#pragma unroll
  for (int kk = 0; kk < KPS; ++kk)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(af[kk][mt]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(acc[mt]);
  vsv::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KPS; ++kk)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      vsv::WgmmaRS<W>::mma(acc[mt], af[kk][mt], desc[kk], (sl > 0 || kk > 0) ? 1 : 0);
  vsv::wgmma_commit();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(acc[mt]);
  vsv::wgmma_wait<0>();
#pragma unroll
  for (int kk = 0; kk < KPS; ++kk)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) vsv::wgmma_fence_regs(af[kk][mt]);
  if (!resident) mbar_arrive(&wempty[st]);
  ++n;
}

// The conv's staging of the halo patch (t0, f0) of sample b by the
// kWgStagers producer threads (this one: pt): in_i (DZ false; y_{i-1} also
// goes to the output's slice i-1 at the patch's own positions) or dz_i (DZ
// true), zero outside the grid, at the stride halo_stride(W). Thread pt
// always takes the same 8 channels (kWgStagers is a multiple of w / 8), so
// its BN parameters stay in registers (pa .. pd: group i-1's mean and rstd,
// or group i's mean, rstd, mean(d) and mean(d xhat)), reloaded where the
// BN group changes (pgroup).
template <int W, bool DZ>
__device__ void wg_stage_conv(const Args<bf16>& a, bf16* halo, int b, int t0, int f0, int pt,
                              float (&pa)[8], float (&pb)[8], float (&pc)[8], float (&pd)[8],
                              int& pgroup) {
  const Plan& g = a.g;
  constexpr int C8 = W / 8, QS = kWgStagers / C8, HS = halo_stride(W);
  static_assert(kWgStagers % C8 == 0, "a stager's channels");
  const int c0 = (pt % C8) * 8, hw = g.hw, C = g.split * W, gw = g.groups * W;
  const int gb = b / g.bpg;
  if (gb != pgroup) {
    pgroup = gb;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = gb * W + c0 + j;
      if constexpr (DZ) {
        pa[j] = a.stats[e];
        pb[j] = a.stats[gw + e];
        pc[j] = a.bsums[e];
        pd[j] = a.bsums[gw + e];
      } else if (a.i > 0) {
        pa[j] = a.sprev[e];
        pb[j] = a.sprev[gw + e];
      }
    }
  }
  for (int q0 = pt / C8; q0 < g.hpos; q0 += kWgBatch * QS) {
    uint4 ra[kWgBatch], rb[kWgBatch];
    long long pp[kWgBatch];
    bool live[kWgBatch];
    int tq[kWgBatch];
#pragma unroll
    for (int u = 0; u < kWgBatch; ++u) {
      const int q = q0 + u * QS, qt = q / hw, t = t0 - 1 + qt, f = f0 - 1 + (q - qt * hw);
      tq[u] = t;
      live[u] = q < g.hpos && t >= 0 && t < g.tlen && f >= 0 && f < g.flen;
      pp[u] = live[u] ? pos_index(g, b, t, f) : 0;
      if (live[u]) {
        if constexpr (DZ) {
          ra[u] = *reinterpret_cast<const uint4*>(a.z + pp[u] * W + c0);
          rb[u] = *reinterpret_cast<const uint4*>(a.dy + pp[u] * W + c0);
        } else {
          ra[u] = *reinterpret_cast<const uint4*>(a.x + pp[u] * C + a.i * W + c0);
          if (a.i > 0) rb[u] = *reinterpret_cast<const uint4*>(a.zprev + pp[u] * W + c0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kWgBatch; ++u) {
      const int q = q0 + u * QS;
      if (q >= g.hpos) continue;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (live[u]) {
        if constexpr (DZ) {
          float zv[8], d[8];
          unpack8(ra[u], zv);
          unpack8(rb[u], d);
#pragma unroll
          for (int j = 0; j < 8; ++j) {  // rounded to bf16 by pack8
            const float xh = (zv[j] - pa[j]) * pb[j];
            v[j] = pb[j] * __fmaf_rn(-xh, pd[j], d[j] - pc[j]);
          }
        } else {
          unpack8(ra[u], v);
          if (a.i > 0) {
            float zv[8], y[8];
            unpack8(rb[u], zv);
            const float mk =
                a.mask != nullptr ? a.mask[static_cast<long long>(b) * g.tlen + tq[u]] : 1.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {  // v rounded to bf16 by pack8
              y[j] = bn_relu<bf16>(zv[j], pa[j], pb[j]);
              v[j] += y[j] * mk;
            }
            const int qt = q / hw, qf = q - qt * hw;
            if (qt >= 1 && qt <= g.tt && qf >= 1 && qf <= g.tf)
              *reinterpret_cast<uint4*>(a.out + pp[u] * C + (a.i - 1) * W + c0) = pack8(y);
          }
        }
      }
      *reinterpret_cast<uint4*>(halo + q * HS + c0) = pack8(v);
    }
  }
}

// K9's forward (EPI 0) or K9b's input gradient (EPI 1) of group i: CTAs
// [0, nctas) walk the slabs sl = blockIdx.x, blockIdx.x + nctas, ...
// Producer warpgroup: thread 0 streams the group's weights (a.wk: (9 w / 8,
// w, 8), [k / 8][n][k % 8], k = tap * w + input channel) through the ring
// of g.ring slices, one bulk copy each, in the same order for every patch;
// warps 1-3 stage the next patch's operand, in_i (the masked add of y_{i-1},
// recomputed from z_{i-1}: EPI 0, which also writes y_{i-1} and, at i = 0,
// the pass-through slice at the patch's positions) or dz_i (EPI 1), into
// the other of two stages while the consumers compute this one. The two
// consumer warpgroups split the patch's rows (MT 64-row m tiles each) and
// run wgmma m64nWk16 with A from the stage by ldmatrix and B from the ring;
// then they round the result to bf16 into the stage and write it out in
// 16-byte rows: z_i (EPI 0) or dIn_i into dx's slice i (EPI 1), each thread
// always the same 8 channels, so that it keeps their slab sums in
// registers: z and z^2 (EPI 0), or (EPI 1, i > 0) group i-1's folded
// statistics d_{i-1} (fold_d, into a.dy_prev) and d xhat. At a slab's end
// the sums go to a.part[slab] in a fixed order; after every slab the last
// CTA collapses them (collapse).
template <int W, int EPI>
__device__ void wg_conv(const Args<bf16>& a, unsigned char* smem, int nctas) {
  const Plan& g = a.g;
  constexpr int MT = wg_mt(W), HS = halo_stride(W), C8 = W / 8, KPS = wg_kps(W);
  constexpr int SLICES = wg_ksteps(W) / KPS, SLICE = wg_slice_bytes(W);
  constexpr int RP = kWgConsumers / C8;  // rows of a write-out pass
  const int ring = g.ring, hw = g.hw, rows = g.tt * g.tf, C = g.split * W;
  const int hbuf = align16(g.hpos * HS * 2);
  const bool sums_on = EPI == 0 || a.i > 0;
  unsigned char* wring = smem;
  unsigned char* stage0 = smem + ring * SLICE;
  float* red = reinterpret_cast<float*>(stage0 + 2 * hbuf);
  uint64_t* pfull = reinterpret_cast<uint64_t*>(red + kWgConsumers * 16);
  uint64_t* pempty = pfull + 2;
  uint64_t* wfull = pfull + 4;
  uint64_t* wempty = wfull + ring;
  const int tid = threadIdx.x, wg = tid / 128;
  const int role = EPI == 0 ? kRoleFwd : kRoleDgrad;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&pfull[s], kWgStagers);
      mbar_init(&pempty[s], kWgConsumers);
    }
    for (int s = 0; s < ring; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], kWgConsumers);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (wg == 0) {
    if (tid == 0) {
      Prof pf(true);
      // slice s of the weights into ring slot st, one bulk copy
      auto issue = [&](int st, int s) {
        const uint32_t bar = smem_u32(&wfull[st]);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(SLICE)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
            "%2, [%3];\n" ::"r"(smem_u32(wring + st * SLICE)),
            "l"(reinterpret_cast<const unsigned char*>(a.wk) + static_cast<long long>(s) * SLICE),
            "r"(SLICE), "r"(bar)
            : "memory");
      };
      if constexpr (wg_resident(W)) {  // slice s into slot s, once
        for (int s = 0; s < SLICES; ++s) issue(s, s);
      } else {
        int n = 0;
        for (int sl = blockIdx.x; sl < g.nslabs; sl += nctas) {
          int p0, p1;
          slab_patches(g, sl, p0, p1);
          for (int pi = p0; pi < p1; ++pi)
            for (int s = 0; s < SLICES; ++s, ++n) {
              const int st = n % ring;
              mbar_wait_bounded(&wempty[st], ((n / ring) & 1) ^ 1);
              pf.lap(kPhWeights);
              issue(st, s);
            }
        }
      }
      pf.flush(role, false);
    } else if (tid >= 32) {
      const int pt = tid - 32;
      Prof pf(pt == 0);
      int it = 0, pgroup = -1;
      float pa[8], pb[8], pc[8], pd[8];
      for (int sl = blockIdx.x; sl < g.nslabs; sl += nctas) {
        const int b = sl / g.k;
        int p0, p1;
        slab_patches(g, sl, p0, p1);
        for (int pi = p0; pi < p1; ++pi, ++it) {
          const int ps = it & 1;
          int t0, f0;
          patch_origin(g, pi, t0, f0);
          pf.lap(kPhProduce);
          mbar_wait_bounded(&pempty[ps], ((it >> 1) & 1) ^ 1);
          pf.lap(kPhProduceWait);
          wg_stage_conv<W, EPI == 1>(a, reinterpret_cast<bf16*>(stage0 + ps * hbuf), b, t0, f0,
                                     pt, pa, pb, pc, pd, pgroup);
          if (EPI == 0 && a.i == 0) {  // the pass-through last group
            for (int e = pt; e < rows * C8; e += kWgStagers) {
              const int r = e / C8, c = (e % C8) * 8, t = t0 + r / g.tf, f = f0 + r % g.tf;
              if (t < g.tlen && f < g.flen) {
                const long long q = pos_index(g, b, t, f) * C + (g.split - 1) * W + c;
                *reinterpret_cast<uint4*>(a.out + q) = *reinterpret_cast<const uint4*>(a.x + q);
              }
            }
          }
          mbar_arrive(&pfull[ps]);
        }
      }
      pf.lap(kPhProduce);
      pf.flush(role, false);
    }
  } else {
    const int cw = wg - 1, wtid = tid % 128, wi = wtid / 32, lane = tid % 32;
    const int gq = lane / 4, tg = lane % 4, ct = tid - 128;
    const bool writer = ct < RP * C8;
    const int c0 = (ct % C8) * 8;
    Prof pf(ct == 0);
    int arow[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = min(cw * 64 * MT + mt * 64 + wi * 16 + lane % 16, rows - 1);
      arow[mt] = ((r / g.tf + 1) * hw + r % g.tf + 1) * HS;
    }
    const int gw = g.groups * W;
    float acc[MT][W / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[mt][i] = 0.f;
    float s1[8], s2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
    int n = 0, it = 0;
    for (int sl = blockIdx.x; sl < g.nslabs; sl += nctas) {
      const int b = sl / g.k, gb = (b / g.bpg) * W + c0;
      int p0, p1;
      slab_patches(g, sl, p0, p1);
      for (int pi = p0; pi < p1; ++pi, ++it) {
        const int ps = it & 1;
        int t0, f0;
        patch_origin(g, pi, t0, f0);
        pf.lap(kPhEpilogue);
        mbar_wait_bounded(&pfull[ps], (it >> 1) & 1);
        pf.lap(kPhStage);
        pf.count(kPhPatches);
        const uint32_t xbase = smem_u32(stage0 + ps * hbuf);
        uint32_t af[KPS][MT][4];
        for (int s = 0; s < SLICES; ++s)
          wg_slice<W>(acc, af, s, n, xbase, arow, hw, ring, wfull, wempty, wring);
        pf.lap(kPhMma);
        // the result rounded to bf16 into the stage (row r at r * HS), once
        // both warpgroups have read it
        consumers_sync();
        bf16* ob = reinterpret_cast<bf16*>(stage0 + ps * hbuf);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = cw * 64 * MT + mt * 64 + wi * 16 + gq + 8 * h;
            if (r >= rows) continue;
#pragma unroll
            for (int j = 0; j < W / 8; ++j)
              *reinterpret_cast<__nv_bfloat162*>(ob + r * HS + 8 * j + 2 * tg) =
                  __floats2bfloat162_rn(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
          }
        // the next patch's first wgmma ignores acc (scale_d 0): zeroing it
        // here ends its registers' life across the write-out
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < W / 2; ++i) acc[mt][i] = 0.f;
        consumers_sync();
        // write-out: rows r = ct / C8 + k RP, channels [c0, c0 + 8), kWgDrain
        // rows in flight
        if (writer) {
          for (int r0 = ct / C8; r0 < rows; r0 += kWgDrain * RP) {
            uint4 rd[kWgDrain], rz[kWgDrain];
            long long pp[kWgDrain];
            float mk[kWgDrain];
            bool live[kWgDrain];
#pragma unroll
            for (int u = 0; u < kWgDrain; ++u) {
              const int r = r0 + u * RP, t = t0 + r / g.tf, f = f0 + r % g.tf;
              live[u] = r < rows && t < g.tlen && f < g.flen;
              pp[u] = live[u] ? pos_index(g, b, t, f) : 0;
              mk[u] = 1.f;
              if (EPI == 1 && a.i > 0 && live[u]) {
                rd[u] = *reinterpret_cast<const uint4*>(a.dout + pp[u] * C + (a.i - 1) * W + c0);
                rz[u] = *reinterpret_cast<const uint4*>(a.zprev + pp[u] * W + c0);
                if (a.mask != nullptr) mk[u] = a.mask[static_cast<long long>(b) * g.tlen + t];
              }
            }
#pragma unroll
            for (int u = 0; u < kWgDrain; ++u) {
              if (!live[u]) continue;
              const uint4 v = *reinterpret_cast<const uint4*>(ob + (r0 + u * RP) * HS + c0);
              float vf[8];
              unpack8(v, vf);
              if constexpr (EPI == 0) {
                *reinterpret_cast<uint4*>(a.z + pp[u] * W + c0) = v;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  s1[j] += vf[j];
                  s2[j] += vf[j] * vf[j];
                }
              } else {
                *reinterpret_cast<uint4*>(a.dx + pp[u] * C + a.i * W + c0) = v;
                if (a.i > 0) {
                  float dv[8], zv[8], dd[8];
                  unpack8(rd[u], dv);
                  unpack8(rz[u], zv);
#pragma unroll
                  for (int j = 0; j < 8; ++j) {
                    float xh;
                    dd[j] = fold_d<bf16>(dv[j], vf[j], mk[u], zv[j], a.sprev[gb + j],
                                         a.sprev[gw + gb + j], &xh);
                    s1[j] += dd[j];
                    s2[j] += dd[j] * xh;
                  }
                  *reinterpret_cast<uint4*>(a.dy_prev + pp[u] * W + c0) = pack8(dd);
                }
              }
            }
          }
        }
        mbar_arrive(&pempty[ps]);  // the stage is free for the next patch
      }
      pf.lap(kPhEpilogue);
      if (sums_on) {  // the slab's partials: the threads of each 8 channels in row order
        if (writer) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            red[ct * 16 + j] = s1[j];
            red[ct * 16 + 8 + j] = s2[j];
            s1[j] = s2[j] = 0.f;
          }
        }
        consumers_sync();
        float* part = a.part + static_cast<long long>(sl) * 2 * W;
        for (int e = ct; e < 2 * W; e += kWgConsumers) {
          const int k = e / W, c = e % W;
          const float* src = red + (c / 8) * 16 + k * 8 + c % 8;
          float v = 0.f;
          for (int rp = 0; rp < RP; ++rp) v += src[rp * C8 * 16];
          part[e] = v;
        }
        consumers_sync();
      }
      pf.lap(kPhSums);
    }
    pf.flush(role);
  }
  __syncthreads();
  if (sums_on) {
    if constexpr (EPI == 0) collapse<true, kWgThreads>(a, nctas, nullptr);
    else collapse<false, kWgThreads>(a, nctas, a.bsums_prev);
  }
}

// The weight gradient's shared memory (wg_wgrad_layout): the operands (dz
// in 16-byte chunks [8-channel group][row], rows padded to 16; in_i's halo
// at the stride halo_stride(8 wg_nc8)), the raw rows the next patch's
// copies land in (z_i and d_i [row][w]; x_i's and z_{i-1}'s halo rows of
// the tile's groups [position][8 wg_nc8]), and the BN parameter table.
struct WgradLayout {
  int pr, hpos, dz, in, rz, rd, rx, rp, prm, total;
};
__host__ __device__ inline WgradLayout wg_wgrad_layout(int w, int wtt, int tf) {
  WgradLayout l;
  l.pr = wg_pr(wtt * tf);
  l.hpos = (wtt + 2) * (tf + 2);
  const int nc = 8 * wg_nc8(w);
  l.dz = 0;
  l.in = l.dz + align16(l.pr * w * 2);
  l.rz = l.in + align16(l.hpos * halo_stride(nc) * 2);
  l.rd = l.rz + align16(l.pr * w * 2);
  l.rx = l.rd + align16(l.pr * w * 2);
  l.rp = l.rx + align16(l.hpos * nc * 2);
  l.prm = l.rp + align16(l.hpos * nc * 2);
  l.total = l.prm + 6 * w * 4;
  return l;
}

// The raw copies of weight-gradient patch wp (sample b, rows of t0 .. t0 +
// wtt - 1, f0 .. f0 + tf - 1) by all kWgThreads threads, zero-filled
// outside the grid and past the patch.
template <int W>
__device__ void wg_wgrad_copy(const Args<bf16>& a, unsigned char* smem, const WgradLayout& l,
                              int b, int t0, int f0, int c8lo, int nc8) {
  const Plan& g = a.g;
  constexpr int C8 = W / 8, NC = 8 * wg_nc8(W);
  const int tid = threadIdx.x, rows = g.ci_tile * g.tf, hw = g.tf + 2, C = g.split * W;
  for (int e = tid; e < l.pr * C8; e += kWgThreads) {
    const int r = e / C8, c0 = (e % C8) * 8, t = t0 + r / g.tf, f = f0 + r % g.tf;
    const bool ok = r < rows && t < g.tlen && f < g.flen;
    const long long p = ok ? pos_index(g, b, t, f) : 0;
    cp_async16(smem + l.rz + (r * W + c0) * 2, a.z + p * W + c0, ok);
    cp_async16(smem + l.rd + (r * W + c0) * 2, a.dy + p * W + c0, ok);
  }
  for (int e = tid; e < l.hpos * nc8; e += kWgThreads) {
    const int q = e / nc8, c = e % nc8, t = t0 - 1 + q / hw, f = f0 - 1 + q % hw;
    const bool ok = t >= 0 && t < g.tlen && f >= 0 && f < g.flen;
    const long long p = ok ? pos_index(g, b, t, f) : 0;
    const int c0 = 8 * (c8lo + c);
    cp_async16(smem + l.rx + (q * NC + 8 * c) * 2, a.x + p * C + a.i * W + c0, ok);
    if (a.i > 0) cp_async16(smem + l.rp + (q * NC + 8 * c) * 2, a.zprev + p * W + c0, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The landed raw rows into the operands: dz_i = rstd (d - mean(d) - xhat
// mean(d xhat)) (thread t always the 8 channels t % C8, their parameters in
// registers), zero past the patch or the grid; in_i = x_i + mask
// relu(BN(z_{i-1})) on the halo, zero outside the grid. pack8 rounds to
// bf16.
template <int W>
__device__ void wg_wgrad_convert(const Args<bf16>& a, unsigned char* smem, const WgradLayout& l,
                                 int b, int t0, int f0, int c8lo, int nc8) {
  const Plan& g = a.g;
  constexpr int C8 = W / 8, RD = kWgThreads / C8, NC = 8 * wg_nc8(W), HIS = halo_stride(NC);
  const int tid = threadIdx.x, rows = g.ci_tile * g.tf, hw = g.tf + 2;
  const float* prm = reinterpret_cast<const float*>(smem + l.prm);
  auto param8 = [&](int kind, int c0, float* v) {
    const float4 lo = *reinterpret_cast<const float4*>(prm + kind * W + c0);
    const float4 hi = *reinterpret_cast<const float4*>(prm + kind * W + c0 + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  };
  {
    const int c0 = (tid % C8) * 8;
    float mu[8], rs[8], m1[8], m2[8];
    param8(0, c0, mu);
    param8(1, c0, rs);
    param8(2, c0, m1);
    param8(3, c0, m2);
    bf16* dzs = reinterpret_cast<bf16*>(smem + l.dz) + (c0 / 8) * l.pr * 8;
    for (int r = tid / C8; r < l.pr; r += RD) {
      const int t = t0 + r / g.tf, f = f0 + r % g.tf;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < rows && t < g.tlen && f < g.flen) {
        float zv[8], d[8];
        unpack8(*reinterpret_cast<const uint4*>(smem + l.rz + (r * W + c0) * 2), zv);
        unpack8(*reinterpret_cast<const uint4*>(smem + l.rd + (r * W + c0) * 2), d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (zv[j] - mu[j]) * rs[j];
          v[j] = rs[j] * __fmaf_rn(-xh, m2[j], d[j] - m1[j]);
        }
      }
      *reinterpret_cast<uint4*>(dzs + r * 8) = pack8(v);
    }
  }
  const int ri = kWgThreads / nc8;
  if (tid >= ri * nc8) return;
  const int c = tid % nc8, c0 = 8 * (c8lo + c);
  float mu[8], rs[8];
  if (a.i > 0) {
    param8(4, c0, mu);
    param8(5, c0, rs);
  }
  bf16* ins = reinterpret_cast<bf16*>(smem + l.in);
  for (int q = tid / nc8; q < l.hpos; q += ri) {
    const int qt = q / hw, t = t0 - 1 + qt, f = f0 - 1 + (q - qt * hw);
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t >= 0 && t < g.tlen && f >= 0 && f < g.flen) {
      unpack8(*reinterpret_cast<const uint4*>(smem + l.rx + (q * NC + 8 * c) * 2), v);
      if (a.i > 0) {
        float zv[8];
        unpack8(*reinterpret_cast<const uint4*>(smem + l.rp + (q * NC + 8 * c) * 2), zv);
        const float mk = a.mask != nullptr ? a.mask[static_cast<long long>(b) * g.tlen + t] : 1.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += bn_relu<bf16>(zv[j], mu[j], rs[j]) * mk;
      }
    }
    *reinterpret_cast<uint4*>(ins + q * HIS + 8 * c) = pack8(v);
  }
}

// The weight gradient of the Hopper design, tile wt (m tiles [3 WMT wt, 3
// WMT (wt + 1)), all w output channels) and split sp (the weight-gradient
// patches [npat sp / nsplit, npat (sp + 1) / nsplit) of all, wtt = g.ci_tile
// t-rows by tf a patch, sample-major). Every thread copies the next patch's
// raw rows by cp.async (wg_wgrad_copy) while the warpgroups run this one's
// MMAs: wgmma m64nWk16 over each warpgroup's WMT m tiles, K = 16 positions
// a step, A (the (tap, input channel) rows: in_i shifted by the row's tap,
// transposed) by ldmatrix.trans, B (dz_i) by an MN-major descriptor, two k
// steps in flight; then every thread converts the landed rows into the
// operands (wg_wgrad_convert). Each CTA writes its partial (3 WMT 64 rows by
// w floats) into a.wpart; wgrad_reduce adds them.
template <int W>
__device__ void wg_wgrad(const Args<bf16>& a, unsigned char* smem, int wt, int sp, Prof& pf) {
  const Plan& g = a.g;
  constexpr int C8 = W / 8, WMT = wg_wmt(W), HIS = halo_stride(8 * wg_nc8(W));
  const WgradLayout l = wg_wgrad_layout(W, g.ci_tile, g.tf);
  const int rows = g.ci_tile * g.tf, pr = l.pr, hw = g.tf + 2;
  float* prm = reinterpret_cast<float*>(smem + l.prm);
  const int tid = threadIdx.x, wg = tid / 128, wi = (tid % 128) / 32, lane = tid % 32;
  const int nq = 9 * C8, q0 = wt * 24 * WMT, q1 = min(q0 + 24 * WMT, nq);
  const int c8lo = q0 / 9, nc8 = (q1 - 1) / 9 - c8lo + 1;
  const int wtiles_t = (g.tlen + g.ci_tile - 1) / g.ci_tile, wpps = wtiles_t * g.ft;
  const long long npat = static_cast<long long>(g.batch) * wpps;
  const long long a0 = npat * sp / g.nsplit, a1 = npat * (sp + 1) / g.nsplit;
  auto origin = [&](long long gp, int& b, int& t0, int& f0) {
    b = static_cast<int>(gp / wpps);
    const int pi = static_cast<int>(gp % wpps);
    t0 = (pi / g.ft) * g.ci_tile;
    f0 = (pi % g.ft) * g.tf;
  };
  float acc[WMT][W / 2];
#pragma unroll
  for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[mt][i] = 0.f;
  // this warp's two chunks of each m tile (rows 16 wi .. 16 wi + 15);
  // chunks past the last are clamped (their rows are never written)
  int qa[WMT], qb[WMT];
#pragma unroll
  for (int mt = 0; mt < WMT; ++mt) {
    const int m = wt * 3 * WMT + wg * WMT + mt;
    qa[mt] = min(8 * m + 2 * wi, nq - 1);
    qb[mt] = min(8 * m + 2 * wi + 1, nq - 1);
  }
  const int mi = lane / 8;
  int pgroup = -1;  // the BN group whose parameters prm holds
  if (a0 < a1) {
    int b, t0, f0;
    origin(a0, b, t0, f0);
    wg_wgrad_copy<W>(a, smem, l, b, t0, f0, c8lo, nc8);
  }
  for (long long gp = a0; gp < a1; ++gp) {
    int b, t0, f0;
    origin(gp, b, t0, f0);
    // patch gp's rows have landed (each thread its own copies; the barrier
    // makes them every thread's); the operands are free (the MMAs of gp - 1
    // are done)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int gb = b / g.bpg;
    if (gb != pgroup) {  // the BN group's parameters: dz's, then in_i's (i > 0)
      const int gw = g.groups * W;
      for (int c = tid; c < W; c += kWgThreads) {
        prm[c] = a.stats[gb * W + c];
        prm[W + c] = a.stats[gw + gb * W + c];
        prm[2 * W + c] = a.bsums[gb * W + c];
        prm[3 * W + c] = a.bsums[gw + gb * W + c];
        if (a.i > 0) {
          prm[4 * W + c] = a.sprev[gb * W + c];
          prm[5 * W + c] = a.sprev[gw + gb * W + c];
        }
      }
      __syncthreads();
      pgroup = gb;
    }
    wg_wgrad_convert<W>(a, smem, l, b, t0, f0, c8lo, nc8);
    __syncthreads();  // the operands are staged, the raw rows free
    if (gp + 1 < a1) {
      int nb, nt0, nf0;
      origin(gp + 1, nb, nt0, nf0);
      wg_wgrad_copy<W>(a, smem, l, nb, nt0, nf0, c8lo, nc8);
    }
    pf.lap(kPhStage);
    pf.count(kPhPatches);
    // the MMAs: k steps in pairs, A of one step in f0 and of the next in f1,
    // so that a buffer is refilled only after the wgmma that reads it is
    // done (wait<1>, then the buffer is touched to keep it allocated)
    const bf16* ins = reinterpret_cast<const bf16*>(smem + l.in);
    const uint32_t dzbase = smem_u32(smem + l.dz);
    uint32_t fa[WMT][4], fb[WMT][4];
    auto step = [&](uint32_t(&f)[WMT][4], uint32_t(&other)[WMT][4], int ks) {
      const int r = min(16 * ks + (mi / 2) * 8 + lane % 8, rows - 1);
      const int hrow = (r / g.tf + 1) * hw + r % g.tf + 1;
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) {
        const int q = (mi & 1) ? qb[mt] : qa[mt], tap = q % 9;
        ldsm_x4_trans(f[mt], ins + (hrow + (tap / 3 - 1) * hw + tap % 3 - 1) * HIS +
                                 8 * (q / 9 - c8lo));
      }
      const uint64_t desc = vsv::wgmma_desc(dzbase + ks * 16 * 16, 128, pr * 16);
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) vsv::wgmma_fence_regs(f[mt]);
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) vsv::wgmma_fence_regs(acc[mt]);
      vsv::wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) vsv::WgmmaRS<W, 1>::mma(acc[mt], f[mt], desc, 1);
      vsv::wgmma_commit();
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) vsv::wgmma_fence_regs(acc[mt]);
      vsv::wgmma_wait<1>();
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) vsv::wgmma_fence_regs(other[mt]);
    };
    const int nks = pr / 16;
    for (int ks = 0; ks < nks; ks += 2) {
      step(fa, fb, ks);
      if (ks + 1 < nks) step(fb, fa, ks + 1);
    }
    vsv::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < WMT; ++mt) {
      vsv::wgmma_fence_regs(fa[mt]);
      vsv::wgmma_fence_regs(fb[mt]);
      vsv::wgmma_fence_regs(acc[mt]);
    }
    pf.lap(kPhMma);
  }
  // the partial: row (wg WMT + mt) 64 + 16 wi + lane / 4 (+ 8), w floats a row
  float* mine = a.wpart + (static_cast<long long>(wt) * g.nsplit + sp) * g.went;
  const int gq = lane / 4, tg = lane % 4;
#pragma unroll
  for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
    for (int i = 0; i < W / 2; i += 2) {
      const int row = (wg * WMT + mt) * 64 + 16 * wi + gq + 8 * ((i / 2) % 2);
      *reinterpret_cast<float2*>(mine + static_cast<long long>(row) * W + 8 * (i / 4) + 2 * tg) =
          make_float2(acc[mt][i], acc[mt][i + 1]);
    }
  pf.lap(kPhEpilogue);
  __syncthreads();
}

template <int W>
__global__ void __launch_bounds__(kWgThreads, 1) k9_wg_fwd_kernel(const __grid_constant__ Args<bf16> a) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  wg_conv<W, 0>(a, wg_smem, gridDim.x);
}

// K9b (b) of the Hopper design: CTAs [0, a.ndg) the input gradient
// (persistent, wg_conv<W, 1>), the rest the weight gradient's (tile, split).
template <int W>
__global__ void __launch_bounds__(kWgThreads, 1) k9b_wg_grad_kernel(const __grid_constant__ Args<bf16> a) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  if (static_cast<int>(blockIdx.x) < a.ndg) {
    wg_conv<W, 1>(a, wg_smem, a.ndg);
    return;
  }
  const Plan& g = a.g;
  Prof pf(threadIdx.x == 128);
  const int wb = blockIdx.x - a.ndg, wt = wb / g.nsplit, sp = wb % g.nsplit;
  wg_wgrad<W>(a, wg_smem, wt, sp, pf);
  wgrad_reduce<2, kWgThreads>(a, wt, sp);
  pf.lap(kPhReduce);
  pf.flush(kRoleWgrad);
}

// persistent CTAs: as many of `threads` as fit on the card at once, at most
// `work`
template <typename K>
int resident_ctas(K kernel, int threads, int smem, int work, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *out = std::min(work, per_sm * sms);
  return 0;
}

template <int W>
int launch_wg_fwd(const Args<bf16>& a, int smem, cudaStream_t stream) {
  auto kernel = k9_wg_fwd_kernel<W>;
  int code = set_smem(reinterpret_cast<const void*>(kernel), smem);
  int grid = 0;
  if (!code) code = resident_ctas(kernel, kWgThreads, smem, a.g.nslabs, &grid);
  if (code) return code;
  kernel<<<grid, kWgThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_wg_grad(Args<bf16> a, int smem, cudaStream_t stream) {
  auto kernel = k9b_wg_grad_kernel<W>;
  int code = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (!code) code = resident_ctas(kernel, kWgThreads, smem, a.g.nslabs, &a.ndg);
  if (code) return code;
  kernel<<<a.ndg + a.g.wtiles * a.g.nsplit, kWgThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_mma_fwd(const Args<bf16>& a, int smem, cudaStream_t stream) {
  auto kernel = k9_mma_fwd_kernel<NT>;
  int code = set_smem(reinterpret_cast<const void*>(kernel), smem);
  int grid = 0;
  if (!code) code = resident_ctas(kernel, kThreads, smem, a.g.nslabs, &grid);
  if (code) return code;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_mma_grad(Args<bf16> a, int smem, cudaStream_t stream) {
  auto kernel = k9b_mma_grad_kernel<NT>;
  int code = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (!code) code = resident_ctas(kernel, kThreads, smem, a.g.nslabs, &a.ndg);
  if (code) return code;
  kernel<<<a.ndg + a.g.wtiles * a.g.nsplit, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const Args<T>& a, int smem, cudaStream_t stream) {
  const int code = set_smem(reinterpret_cast<const void*>(k9_fwd_kernel<T>), smem);
  if (code) return code;
  k9_fwd_kernel<T><<<a.g.nslabs, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grad(const Args<T>& a, int smem, cudaStream_t stream) {
  const int code = set_smem(reinterpret_cast<const void*>(k9b_grad_kernel<T>), smem);
  if (code) return code;
  k9b_grad_kernel<T><<<a.g.nslabs + a.g.wtiles * a.g.nsplit, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the conv launches' variant: the Hopper kernels (bf16, by w), the mma
// kernels (bf16, by NT) or the float ones
#define VSV_TRAIN_DISPATCH(WG, MMA, FMA, T, a, smem, stream)           \
  do {                                                                 \
    if constexpr (std::is_same<T, bf16>::value) {                      \
      if ((a).g.wg) {                                                  \
        switch ((a).g.width) {                                         \
          case 32: return WG<32>((a), (smem), (stream));               \
          case 48: return WG<48>((a), (smem), (stream));               \
          case 64: return WG<64>((a), (smem), (stream));               \
          case 96: return WG<96>((a), (smem), (stream));               \
          case 192: return WG<192>((a), (smem), (stream));             \
          default: return vsv::kShapeUnsupported;                      \
        }                                                              \
      }                                                                \
      if ((a).g.mma) {                                                 \
        switch ((a).g.nt) {                                            \
          case 1: return MMA<1>((a), (smem), (stream));                \
          case 2: return MMA<2>((a), (smem), (stream));                \
          case 3: return MMA<3>((a), (smem), (stream));                \
          default: return vsv::kShapeUnsupported;                      \
        }                                                              \
      }                                                                \
    }                                                                  \
    if ((a).g.mma) return vsv::kShapeUnsupported;                      \
    return FMA<T>((a), (smem), (stream));                              \
  } while (0)

template <typename T>
int fwd_dispatch(const Args<T>& a, int smem, cudaStream_t stream) {
  VSV_TRAIN_DISPATCH(launch_wg_fwd, launch_mma_fwd, launch_fwd, T, a, smem, stream);
}

template <typename T>
int grad_dispatch(const Args<T>& a, int smem, cudaStream_t stream) {
  VSV_TRAIN_DISPATCH(launch_wg_grad, launch_mma_grad, launch_grad, T, a, smem, stream);
}

#undef VSV_TRAIN_DISPATCH

// the shared memory each conv launch's layout needs: the forward, and the
// grad launch (its input-gradient and weight-gradient roles)
int fwd_smem(const Plan& g) {
  return g.wg ? wg_conv_smem(g.width, g.hpos, g.ring) : conv_smem(g);
}
int grad_smem(const Plan& g) {
  return g.wg ? std::max(wg_conv_smem(g.width, g.hpos, g.ring),
                         wg_wgrad_layout(g.width, g.ci_tile, g.tf).total)
              : std::max(conv_smem(g), wgrad_smem(g));
}

template <typename T>
int fwd_entry(const Plan& g, int i, const void* x, const void* zprev, const float* sprev,
              const float* mask, const void* wk, void* z, float* stats, float* run_mean,
              float* run_var, void* out, float* part, int* ticket, float eps, float mom,
              float upd_mean, float upd_var, int smem, cudaStream_t stream) {
  Args<T> a = make_args<T>(g, i);
  a.x = static_cast<const T*>(x);
  a.zprev = static_cast<const T*>(zprev);
  a.sprev = sprev;
  a.mask = mask;
  a.wk = static_cast<const T*>(wk);
  a.z = static_cast<T*>(z);
  a.stats = stats;
  a.run_mean = run_mean;
  a.run_var = run_var;
  a.out = static_cast<T*>(out);
  a.part = part;
  a.ticket = ticket;
  a.eps = eps;
  a.mom = mom;
  a.upd_mean = upd_mean;
  a.upd_var = upd_var;
  return fwd_dispatch<T>(a, smem, stream);
}

template <typename T>
int stats_entry(const Plan& g, int i, const void* dout, void* dx, const void* z,
                const float* stats, const float* mask, void* dy, float* part, int* ticket,
                float* bsums, cudaStream_t stream) {
  Args<T> a = make_args<T>(g, i);
  a.dout = static_cast<const T*>(dout);
  a.dx = static_cast<T*>(dx);
  a.z = static_cast<T*>(const_cast<void*>(z));
  a.stats = const_cast<float*>(stats);
  a.mask = mask;
  a.dy = static_cast<T*>(dy);
  a.part = part;
  a.ticket = ticket;
  a.bsums = bsums;
  if constexpr (std::is_same<T, bf16>::value) {
    if (g.mma) {
      k9b_stats_vec_kernel<<<g.nslabs, kThreads, 0, stream>>>(a);
      return static_cast<int>(cudaGetLastError());
    }
  }
  k9b_stats_kernel<T><<<g.nslabs, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plan: the 13 ints of Plan (models/res2net.py:split_train_plan),
// from host memory. Every entry returns kPlanMismatch where the plan is not
// one it takes or its shared memory (or scratch) differs from the layout.

#ifdef VSV_K9_PROF
// The profile build's counters (kProfRoles x kProfSlots cycle sums) into
// host memory, then zeroed where reset is set.
extern "C" int split_train_prof(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_k9_prof, sizeof(g_k9_prof));
  if (e == cudaSuccess && reset) {
    static unsigned long long zeros[kProfRoles * kProfSlots];
    e = cudaMemcpyToSymbol(g_k9_prof, zeros, sizeof(zeros));
  }
  return static_cast<int>(e);
}
#endif

// K9, group i in [0, s-2]. dtype: 0 float32, 1 bfloat16.
extern "C" int split_train_fwd(int dtype, int i, const int* plan, const void* x,
                               const void* zprev, const float* sprev, const float* mask,
                               const void* wk, void* z, float* stats, float* run_mean,
                               float* run_var, void* out, float* part, int* ticket, float eps,
                               float mom, float upd_mean, float upd_var, int smem,
                               void* stream) {
  Plan g;
  if (!make_plan(plan, &g) || (g.mma && dtype != 1) || smem != fwd_smem(g)) return vsv::kPlanMismatch;
  if (i < 0 || i > g.split - 2 || (i > 0 && (zprev == nullptr || sprev == nullptr)))
    return vsv::kShapeUnsupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_entry<float>(g, i, x, zprev, sprev, mask, wk, z, stats, run_mean, run_var, out,
                            part, ticket, eps, mom, upd_mean, upd_var, smem, s);
  if (dtype == 1)
    return fwd_entry<bf16>(g, i, x, zprev, sprev, mask, wk, z, stats, run_mean, run_var, out,
                           part, ticket, eps, mom, upd_mean, upd_var, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9's finishing launch: y_{s-2} from z_{s-2} and its statistics.
extern "C" int split_train_finish(int dtype, const int* plan, const void* z, const float* stats,
                                  void* out, void* stream) {
  Plan g;
  if (!make_plan(plan, &g)) return vsv::kPlanMismatch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(g.batch) * g.tlen * g.flen * g.width;
  const int grid = static_cast<int>(std::min<long long>((total + 8 * kThreads - 1) / (8 * kThreads),
                                                        1 << 20));
  if (dtype == 0) {
    Args<float> a = make_args<float>(g, g.split - 1);
    a.z = static_cast<float*>(const_cast<void*>(z));
    a.stats = const_cast<float*>(stats);
    a.out = static_cast<float*>(out);
    k9_finish_kernel<float, 1><<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == 1) {
    Args<bf16> a = make_args<bf16>(g, g.split - 1);
    a.z = static_cast<bf16*>(const_cast<void*>(z));
    a.stats = const_cast<float*>(stats);
    a.out = static_cast<bf16*>(out);
    if (g.mma) k9_finish_kernel<bf16, 8><<<grid, kThreads, 0, s>>>(a);
    else k9_finish_kernel<bf16, 1><<<grid, kThreads, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9b (a), group i: d_i into dy, its sums into bsums (2, G, w).
extern "C" int split_train_bwd_stats(int dtype, int i, const int* plan, const void* dout,
                                     void* dx, const void* z, const float* stats,
                                     const float* mask, void* dy, float* part, int* ticket,
                                     float* bsums, int smem, void* stream) {
  Plan g;
  if (!make_plan(plan, &g) || (g.mma && dtype != 1) ||
      smem != (g.mma ? kStatsVecSmem : kStatsSmem))
    return vsv::kPlanMismatch;
  if (i < 0 || i > g.split - 2) return vsv::kShapeUnsupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stats_entry<float>(g, i, dout, dx, z, stats, mask, dy, part, ticket, bsums, s);
  if (dtype == 1)
    return stats_entry<bf16>(g, i, dout, dx, z, stats, mask, dy, part, ticket, bsums, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9b (b), group i: dIn_i into dx's slice i, dW_i into dweight's rows
// [i w, (i + 1) w), and for i > 0 group i-1's statistics: d_{i-1} from
// dout's slice i-1 into dy_prev, its sums (mean(d), mean(d xhat)) into
// bsums_prev by the slabs' partials (part) and a ticket. dy and bsums: group
// i's, read. wk: the group's flipped weights (w, 9 w), rows the input
// channels (wgmma: (9 w / 8, w, 8), [k / 8][row][k % 8]). wpart_floats: the
// scratch's size, at least wtiles * nsplit * went.
extern "C" int split_train_bwd_grad(int dtype, int i, const int* plan, const void* x,
                                    const void* zprev, const float* sprev, const float* mask,
                                    const void* z, const float* stats, const float* bsums,
                                    const void* dy, const void* wk, void* dx, void* dweight,
                                    float* wpart, int* wtickets, const void* dout, void* dy_prev,
                                    float* bsums_prev, float* part, int* ticket, int smem,
                                    long long wpart_floats, void* stream) {
  Plan g;
  if (!make_plan(plan, &g) || (g.mma && dtype != 1) || smem != grad_smem(g) ||
      wpart_floats < static_cast<long long>(g.wtiles) * g.nsplit * g.went)
    return vsv::kPlanMismatch;
  if (i < 0 || i > g.split - 2 || (i > 0 && (zprev == nullptr || sprev == nullptr ||
                                              dout == nullptr || dy_prev == nullptr ||
                                              bsums_prev == nullptr || part == nullptr ||
                                              ticket == nullptr)))
    return vsv::kShapeUnsupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VSV_GRAD_LAUNCH(T)                                                     \
  {                                                                            \
    Args<T> a = make_args<T>(g, i);                                            \
    a.x = static_cast<const T*>(x);                                            \
    a.zprev = static_cast<const T*>(zprev);                                    \
    a.sprev = sprev;                                                           \
    a.mask = mask;                                                             \
    a.z = static_cast<T*>(const_cast<void*>(z));                               \
    a.stats = const_cast<float*>(stats);                                       \
    a.bsums = const_cast<float*>(bsums);                                       \
    a.dy = static_cast<T*>(const_cast<void*>(dy));                             \
    a.wk = static_cast<const T*>(wk);                                          \
    a.dx = static_cast<T*>(dx);                                                \
    a.dweight = static_cast<T*>(dweight);                                      \
    a.wpart = wpart;                                                           \
    a.wtickets = wtickets;                                                     \
    a.dout = static_cast<const T*>(dout);                                      \
    a.dy_prev = static_cast<T*>(dy_prev);                                      \
    a.bsums_prev = bsums_prev;                                                 \
    a.part = part;                                                             \
    a.ticket = ticket;                                                         \
    return grad_dispatch<T>(a, smem, s);                                       \
  }
  if (dtype == 0) VSV_GRAD_LAUNCH(float)
  if (dtype == 1) VSV_GRAD_LAUNCH(bf16)
#undef VSV_GRAD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
