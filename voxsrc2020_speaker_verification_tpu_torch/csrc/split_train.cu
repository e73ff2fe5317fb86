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
// Backward (K9b), two launches a group, i = s-2 .. 0:
//   (a) split_train_bwd_stats: d_i = (dout_i + [i < s-2] mask * dIn_{i+1})
//       rounded to the dtype, times [y_i > 0] (y_i recomputed from z_i by
//       the forward's own expression, so the relu decision agrees bit for
//       bit), written to a scratch; its sums d and d * xhat per (BN group,
//       channel) by slab partials and a ticket, as the forward's;
//   (b) split_train_bwd_grad: dz_i = rstd (d - mean(d) - xhat mean(d
//       xhat)), rounded to the dtype, staged on the fly; dIn_i, the 3x3
//       transposed conv of dz_i (the conv with flipped weights), into dx's
//       slice i (it is dx_i, and group i-1's (a) reads it); and in the same
//       launch, on CTAs of their own, dW_i = sum over positions of in_i
//       (recomputed from x_i and z_{i-1}) times dz_i, by split partials
//       added in split order (below), written in the dtype into the
//       gradient's OIHW rows. (a) of group s-2 copies dout_{s-1} into
//       dx_{s-1}.
//
// The conv: an implicit GEMM over a patch of at most 128 (t, f) positions
// of one sample, staged with a one-position halo in shared memory (each
// thread's loads of two staging items in flight together); in bfloat16 at
// w % 8 == 0 on mma.sync m16n8k16 with fp32 accumulation (four warps of
// two 16-row m tiles, 8 * NT output channels a pass; B fragments from the
// group's weights staged in shared memory where one pass covers w (w <=
// 32), else from L2 one k step ahead), in float32 and at other widths as
// fp32 FMA on CUDA cores (float32 stays off the tensor cores: TF32 would
// drop 13 mantissa bits). The weight gradient in bf16 is mma.sync too: D
// (chunk rows, chunk = 8-channel group x tap) += in_i's halo rows shifted
// by the chunk's tap (A) times the staged dz rows (B), K = 16 positions a
// step, both taken transposed by ldmatrix; a CTA owns a tile of up to 8 m
// tiles by 4 n tiles and a split of the positions. Its partials are added
// in split order by the last CTA of each run of 32 splits, then the runs by
// the last run (tickets). In float32 it is FMA, a thread owning up to five
// (tap, input channel) pairs by 8 output channels.
//
// CTAs and slabs: a slab is a run of patches (or, for the statistics
// launch, of positions) of one sample, so it never crosses a BN group; a
// launch has one CTA a slab, k slabs a sample (the plan,
// models/res2net.py:split_train_plan, which each C entry checks).
//
// Bound on the card: bytes. Forward, x read and the output written (2
// activations of 2 B); backward, x and dout read and dx written (3): 5
// activations a chain, 14.1 ms a bench training step at 3.35 TB/s. The
// group convs are 18 w^2 flops a position, three times over (forward,
// dgrad, wgrad): 4.7 GFLOP a group at every stage of the bench step, 0.1
// ms a microbatch's chains at 989 TFLOP/s. What bounds this first design
// (PERF.md, PR 15): latency -- small CTAs walking patches with a few
// barriers each, the saved z_i written and read back (the bound counts
// none), the halo and the recomputed in_i staged by each role, the 16 of
// 96 bytes a position of the w = 8 slices; at w >= 48 the mma.sync convs
// (L2-fed weights, two m tiles a warp) and the weight gradient's re-staged
// tiles, where cuDNN's convs + K5 are faster.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps
constexpr int kMaxPairs = 5;   // (tap, input channel) pairs a thread of the wgrad role
constexpr int kCoTile = 8;     // output channels of a float weight-gradient tile
constexpr int kSmemMax = 232448;
constexpr int kSplitChunk = 32;  // weight-gradient splits a first-level sum adds
constexpr int kWgMTiles = 8;     // m tiles (16 rows: two (tap, 8-channel) chunks) of an mma weight tile
constexpr int kWgNTiles = 4;     // n tiles (8 output channels) of an mma weight tile

struct Plan {
  // from the caller: batch, T, F, s, w, BN groups, mma (0/1), NT, patch
  // (tt, tf), slabs a sample, input channels a float weight tile, splits a
  // weight tile
  int batch, tlen, flen, split, width, groups, mma, nt, tt, tf, k, ci_tile, nsplit;
  // derived (mma: passes of 8 NT output channels)
  int ft, tiles_t, pps, nslabs, bpg, hw, hpos, hs, passes;
  // the weight gradient's tiles: float, co_tiles x ci_tiles tiles of 8
  // output by ci_tile input channels (all taps); mma, mgroups x ngroups
  // tiles of wm m tiles (chunks q = 8-channel group * 9 + tap, two a m
  // tile, nq of them) by wn n tiles; went floats a tile's partial, his /
  // hsb the staged rows' strides, nchunks first-level sums a tile
  int co_tiles, ci_tiles, wtiles, went, his, hsb;
  int nq, mtiles, mgroups, ngroups, wm, wn, nchunks;
  float inv_n;
};

__host__ __device__ inline int align16(int v) { return (v + 15) / 16 * 16; }

// bf16 row stride of a staged position (as csrc/split_conv.cu:halo_stride):
// an odd multiple of 16 bytes, so the 8 rows of an mma fragment load fall
// in 8 distinct 4-bank groups
__host__ __device__ inline int halo_stride(int width) {
  return width + 2 * ((4 - (width / 2) % 8 + 8) % 8);
}

// bf16 row stride of the staged weights (as csrc/split_conv.cu:
// weight_stride): 8 rows of a B fragment's 32-bit loads fall in distinct
// banks
__host__ __device__ inline int weight_stride(int width) { return (9 * width + 15) / 16 * 16 + 8; }

// The mma convs keep the group's (w, 9 w) weights in shared memory where
// one pass covers w (w <= 32: at most 20 KB); wider groups read them from
// L2 (staging them a pass at a time, re-staging the halo for each pass, was
// slower at w = 96 and 192 on an H100: PERF.md, PR 15).
__host__ __device__ inline bool weights_staged(const Plan& g) { return g.mma && g.passes == 1; }

// Shared memory of the conv launches: the halo patch (bf16 at the padded
// stride, or float at an odd stride), the float variant's weight chunk (9 w
// rows of 8 output channels), the warps' sums (2, 4, w), the slab's sums
// (2, w), and the staged weights.
__host__ __device__ inline int conv_weights_offset(const Plan& g) {
  const int halo = g.mma ? align16(g.hpos * g.hs * 2) : align16(g.hpos * g.hs * 4);
  const int wchunk = g.mma ? 0 : 9 * g.width * kCoTile * 4;
  return align16(halo + wchunk + 4 * 10 * g.width);
}
inline int conv_smem(const Plan& g) {
  return conv_weights_offset(g) +
         (weights_staged(g) ? 2 * g.width * weight_stride(g.width) : 0);
}

// Shared memory of the weight-gradient role: dz at the patch's positions
// ((tt * tf, 8) floats; mma: 128 rows of the tile's output channels in
// bf16) and in_i's halo for the tile's input channels (hpos, his): the
// mma tile's chunks span at most three 8-channel groups.
inline int wgrad_smem(const Plan& g) {
  if (g.mma) return align16(2 * kThreads * g.hsb) + 2 * g.hpos * g.his;
  return 4 * (g.tt * g.tf * kCoTile + g.hpos * g.his);
}

// the statistics launch's reduction buffers: two channel slots of a thread
// (the scalar kernel), or 8 channels (bf16 at w % 8 == 0), by two sums
constexpr int kStatsSmem = 4 * 2 * 2 * kThreads;
constexpr int kStatsVecSmem = 4 * 2 * 8 * kThreads;

bool make_plan(const int* p, Plan* g) {
  g->batch = p[0]; g->tlen = p[1]; g->flen = p[2]; g->split = p[3]; g->width = p[4];
  g->groups = p[5]; g->mma = p[6]; g->nt = p[7]; g->tt = p[8]; g->tf = p[9]; g->k = p[10];
  g->ci_tile = p[11]; g->nsplit = p[12];
  const int w = g->width;
  if (g->batch <= 0 || g->tlen <= 0 || g->flen <= 0 || g->split < 2 || w <= 0 || w > 256 ||
      g->groups <= 0 || g->batch % g->groups || g->tt <= 0 || g->tf <= 0 ||
      g->tt * g->tf > kThreads || g->tf > g->flen || g->k <= 0 || g->nsplit <= 0 ||
      g->ci_tile <= 0 || g->ci_tile > 64 || 9 * g->ci_tile > kMaxPairs * kThreads)
    return false;
  if (g->mma && (w % 8 || g->nt < 1 || g->nt > 4 || (w / 8) % g->nt)) return false;
  g->ft = (g->flen + g->tf - 1) / g->tf;
  g->tiles_t = (g->tlen + g->tt - 1) / g->tt;
  g->pps = g->tiles_t * g->ft;
  if (g->k > g->pps) return false;
  g->nslabs = g->batch * g->k;
  g->bpg = g->batch / g->groups;
  g->hw = g->tf + 2;
  g->hpos = (g->tt + 2) * g->hw;
  g->hs = g->mma ? halo_stride(w) : (w | 1);
  g->passes = g->mma ? w / (8 * g->nt) : 1;
  if (g->mma) {
    g->nq = 9 * (w / 8);
    g->mtiles = (g->nq + 1) / 2;
    g->mgroups = (g->mtiles + kWgMTiles - 1) / kWgMTiles;
    g->wm = (g->mtiles + g->mgroups - 1) / g->mgroups;
    g->wn = std::min(kWgNTiles, w / 8);
    g->ngroups = (w / 8 + g->wn - 1) / g->wn;
    g->wtiles = g->mgroups * g->ngroups;
    g->went = g->wm * 16 * g->wn * 8;
    g->his = halo_stride(8 * std::min(3, w / 8));
    g->hsb = halo_stride(8 * g->wn);
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
  T* dweight;            // (w (s-1), w, 3, 3), OIHW
  float* wpart;          // (wtiles, nsplit, went)
  int* wtickets;         // wtiles ints, zero before a launch, left zero
};

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

// The two 16-byte rows behind 8 channels of in_i (x_i and z_{i-1}) or of
// dz_i (z_i and d_i) at a position: the staging loops load a batch of
// items' rows before they use any, so that a thread's loads are in flight
// together.
struct Raw8 {
  uint4 a, b;
};

__device__ __forceinline__ Raw8 in_load(const Args<bf16>& a, long long p, int c0) {
  const Plan& g = a.g;
  const int w = g.width;
  Raw8 r;
  r.a = *reinterpret_cast<const uint4*>(a.x + p * (g.split * w) + a.i * w + c0);
  r.b = a.i > 0 ? *reinterpret_cast<const uint4*>(a.zprev + p * w + c0) : make_uint4(0, 0, 0, 0);
  return r;
}

// in_i at 8 channels [c0, c0 + 8) of a valid position of sample b (time
// t), from its rows; y_{i-1} there into y (i > 0)
__device__ __forceinline__ void in_finish(const Args<bf16>& a, const Raw8& r, int b, int t,
                                          int c0, float* v, float* y) {
  const Plan& g = a.g;
  const int w = g.width;
  unpack8(r.a, v);
  if (a.i > 0) {
    float zv[8];
    unpack8(r.b, zv);
    const int gi = (b / g.bpg) * w + c0, gw = g.groups * w;
    const float mk = a.mask != nullptr ? a.mask[static_cast<long long>(b) * g.tlen + t] : 1.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[j] = bn_relu<bf16>(zv[j], a.sprev[gi + j], a.sprev[gw + gi + j]);
      v[j] = vsv::round_to<bf16>(v[j] + y[j] * mk);
    }
  }
}

__device__ __forceinline__ Raw8 dz_load(const Args<bf16>& a, long long p, int c0) {
  const int w = a.g.width;
  Raw8 r;
  r.a = *reinterpret_cast<const uint4*>(a.z + p * w + c0);
  r.b = *reinterpret_cast<const uint4*>(a.dy + p * w + c0);
  return r;
}

// dz_i at 8 channels [c0, c0 + 8) of a valid position of sample b, from its
// rows, rounded to bf16
__device__ __forceinline__ void dz_finish(const Args<bf16>& a, const Raw8& r, int b, int c0,
                                          float* v) {
  const Plan& g = a.g;
  const int w = g.width, gi = (b / g.bpg) * w + c0, gw = g.groups * w;
  float zv[8], d[8];
  unpack8(r.a, zv);
  unpack8(r.b, d);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float mu = a.stats[gi + j], rs = a.stats[gw + gi + j];
    const float xh = (zv[j] - mu) * rs;
    v[j] = vsv::round_to<bf16>(rs * __fmaf_rn(-xh, a.bsums[gw + gi + j], d[j] - a.bsums[gi + j]));
  }
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

// Stage the halo patch at (t0, f0) of sample b: in_i (DZ false; y_{i-1}
// then goes to the output's slice i-1 at the patch's own positions) or dz_i
// (DZ true); zero outside the grid.
template <typename T, bool MMA, bool DZ>
__device__ void stage_halo(const Args<T>& a, unsigned char* smem, int b, int t0, int f0) {
  const Plan& g = a.g;
  const int w = g.width, C = g.split * w, hw = g.hw;
  if constexpr (MMA) {
    bf16* halo = reinterpret_cast<bf16*>(smem);
    const int c8 = w / 8, n = g.hpos * c8;
    for (int base = threadIdx.x; base < n; base += kBatch * kThreads) {
      Raw8 raw[kBatch];
      long long pp[kBatch];
      bool live[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads, q = idx / c8, c0 = (idx % c8) * 8;
        const int t = t0 - 1 + q / hw, f = f0 - 1 + q % hw;
        live[u] = idx < n && t >= 0 && t < g.tlen && f >= 0 && f < g.flen;
        pp[u] = live[u] ? pos_index(g, b, t, f) : 0;
        raw[u].a = raw[u].b = make_uint4(0, 0, 0, 0);
        if (live[u]) raw[u] = DZ ? dz_load(a, pp[u], c0) : in_load(a, pp[u], c0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads;
        if (idx >= n) continue;
        const int q = idx / c8, c0 = (idx % c8) * 8, qt = q / hw, qf = q % hw;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (live[u]) {
          if constexpr (DZ) {
            dz_finish(a, raw[u], b, c0, v);
          } else {
            float y[8];
            in_finish(a, raw[u], b, t0 - 1 + qt, c0, v, y);
            if (a.i > 0 && qt >= 1 && qt <= g.tt && qf >= 1 && qf <= g.tf)
              *reinterpret_cast<uint4*>(a.out + pp[u] * C + (a.i - 1) * w + c0) = pack8(y);
          }
        }
        *reinterpret_cast<uint4*>(halo + q * g.hs + c0) = pack8(v);
      }
    }
  } else {
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
}

// The conv of the staged patch at (t0, f0) of sample b with the (w, 9 w)
// weight rows (staged in shared memory or a.wk), 8 NT output channels a
// pass. EPI 0 (forward): z_i rounded to T into a.z, and its sum and sum of
// squares per channel over the patch's valid positions added to the slab's
// sums (fixed order: lanes by a shuffle tree, then warps in order); EPI 1
// (dgrad): dIn_i rounded to T into dx's slice i.
template <int NT, int EPI, typename T>
__device__ void conv_mma(const Args<T>& a, unsigned char* smem, float* red, float* sums, int b,
                         int t0, int f0) {
  const Plan& g = a.g;
  const bf16* halo = reinterpret_cast<const bf16*>(smem);
  const bool staged = weights_staged(g);
  const bf16* wk = staged ? reinterpret_cast<const bf16*>(smem + conv_weights_offset(g))
                          : reinterpret_cast<const bf16*>(a.wk);
  const int wrow = staged ? weight_stride(g.width) : 9 * g.width;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tg = lane % 4;
  const int w = g.width, hs = g.hs, hw = g.hw, c8 = w / 8, kdim = 9 * w, chunks = 9 * c8;
  const int rows = g.tt * g.tf, C = g.split * w;
  int qrow[2][2];
  long long prow[2][2];
  bool valid[2][2];
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
    }
  for (int pass = 0; pass < g.passes; ++pass) {
    const int n0 = pass * 8 * NT;
    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    // B fragments one k step ahead: from L2 (weights not staged) their
    // latency is behind the current step's A loads and MMAs
    const bf16* wrows = wk + static_cast<long long>(n0 + gq) * wrow + 2 * tg;
    uint32_t bfr[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bfr[nt][0] = *reinterpret_cast<const uint32_t*>(wrows + nt * 8 * wrow);
      bfr[nt][1] = chunks > 1 ? *reinterpret_cast<const uint32_t*>(wrows + nt * 8 * wrow + 8) : 0u;
    }
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
      uint32_t bnext[NT][2];
      const int kn = 16 * (ks + 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* row = wrows + nt * 8 * wrow + kn;
        bnext[nt][0] = 2 * (ks + 1) < chunks ? *reinterpret_cast<const uint32_t*>(row) : 0u;
        bnext[nt][1] = 2 * (ks + 1) + 1 < chunks ? *reinterpret_cast<const uint32_t*>(row + 8) : 0u;
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
        bfr[nt][0] = bnext[nt][0];
        bfr[nt][1] = bnext[nt][1];
      }
    }
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
          const int co = n0 + nt * 8 + 2 * tg;
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
            *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(a.dx) + prow[mt][h] * C +
                                               a.i * w + co) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    if constexpr (EPI == 0) {
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
            const int co = n0 + nt * 8 + 2 * tg + e;
            red[warp * w + co] = s[nt][e];
            red[(4 + warp) * w + co] = q[nt][e];
          }
      }
      __syncthreads();
      if (tid < 8 * NT) {
        const int co = n0 + tid;
        sums[co] += ((red[co] + red[w + co]) + red[2 * w + co]) + red[3 * w + co];
        sums[w + co] += ((red[4 * w + co] + red[5 * w + co]) + red[6 * w + co]) + red[7 * w + co];
      }
      __syncthreads();
    }
  }
}

// The float variant of conv_mma: one thread a position, 8 output channels
// a pass, the pass's weights staged in shared memory as (9 w, 8) floats.
template <int EPI, typename T>
__device__ void conv_fma(const Args<T>& a, unsigned char* smem, float* wsm, float* red,
                         float* sums, int b, int t0, int f0) {
  const Plan& g = a.g;
  const float* halo = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int w = g.width, hs = g.hs, hw = g.hw, rows = g.tt * g.tf, C = g.split * w;
  const int r = tid, rr = min(r, rows - 1);
  const int qr = (rr / g.tf + 1) * hw + rr % g.tf + 1;
  const int t = t0 + r / g.tf, f = f0 + r % g.tf;
  const bool valid = r < rows && t < g.tlen && f < g.flen;
  const long long p = valid ? pos_index(g, b, t, f) : 0;
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
    float s[kCoTile], q[kCoTile];
#pragma unroll
    for (int j = 0; j < kCoTile; ++j) {
      const int co = n0 + j;
      const float v = vsv::round_to<T>(acc[j]);
      const bool live = valid && co < w;
      s[j] = live ? v : 0.f;
      q[j] = live ? v * v : 0.f;
      if (live) {
        if constexpr (EPI == 0) a.z[p * w + co] = vsv::from_f<T>(v);
        else a.dx[p * C + a.i * w + co] = vsv::from_f<T>(v);
      }
    }
    if constexpr (EPI == 0) {
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
  }
}

// After every CTA of a statistics launch wrote its slab's (2, w) partials:
// the last CTA to arrive (an integer ticket with fences) adds them per (BN
// group, sum, channel) in slab order. Up to 32 lanes (a power of two) share
// one sum, each taking every sub-th slab in order, joined by a fixed
// shuffle tree. FWD: publishes mean, rstd and var, then the running update
// in group order; else mean(d) and mean(d xhat) into a.bsums.
template <bool FWD, typename T>
__device__ void collapse(const Args<T>& a) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const Plan& g = a.g;
  const int w = g.width, gw = g.groups * w, nsg = g.bpg * g.k, pairs = g.groups * w;
  int sub = 1;
  while (sub < 32 && pairs * sub * 2 <= kThreads) sub *= 2;
  const int q = threadIdx.x % sub, per = kThreads / sub;
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
        a.bsums[gg * w + c] = s1 * g.inv_n;
        a.bsums[gw + gg * w + c] = s2 * g.inv_n;
      }
    }
  }
  if constexpr (FWD) {
    if (a.run_mean != nullptr) {
      __syncthreads();
      const float inv_g = 1.f / static_cast<float>(g.groups);
      for (int c = threadIdx.x; c < w; c += kThreads) {
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

// Copy the group's (w, 9 w) weight rows into shared memory (weights_staged).
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

// K9, group i < s-1: one CTA a slab. At NT = 1 (w = 8: little work a
// patch, latency-bound) the registers are capped for eight CTAs an SM, one
// wave of the plan's 1024 slabs (faster on an H100; the wider instances
// lost time under the same cap: PERF.md, PR 15).
template <typename T, bool MMA, int NT>
__global__ void __launch_bounds__(kThreads, (MMA && NT == 1) ? 8 : 1)
    k9_fwd_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& g = a.g;
  const int w = g.width, tid = threadIdx.x, C = g.split * w;
  const int halo_bytes = MMA ? align16(g.hpos * g.hs * 2) : align16(g.hpos * g.hs * 4);
  float* wsm = reinterpret_cast<float*>(smem + halo_bytes);
  float* red = wsm + (MMA ? 0 : 9 * w * kCoTile);
  float* sums = red + 8 * w;
  for (int c = tid; c < 2 * w; c += kThreads) sums[c] = 0.f;
  const int sl = blockIdx.x, b = sl / g.k;
  if constexpr (MMA) {
    if (weights_staged(g)) stage_weights(a, smem);
  }
  // the pass-through copy moves 16-byte vectors where the rows allow
  constexpr int V = MMA ? 8 : 1;
  int p0, p1;
  slab_patches(g, sl, p0, p1);
  for (int pi = p0; pi < p1; ++pi) {
    int t0, f0;
    patch_origin(g, pi, t0, f0);
    __syncthreads();  // the previous patch's halo is consumed
    stage_halo<T, MMA, false>(a, smem, b, t0, f0);
    if (a.i == 0) {  // the pass-through last group, at the patch's positions
      const int wv = w / V;
      for (int e = tid; e < g.tt * g.tf * wv; e += kThreads) {
        const int r = e / wv, c = (e % wv) * V, t = t0 + r / g.tf, f = f0 + r % g.tf;
        if (t < g.tlen && f < g.flen) {
          const long long p = pos_index(g, b, t, f) * C + (g.split - 1) * w + c;
          if constexpr (V == 8)
            *reinterpret_cast<uint4*>(a.out + p) = *reinterpret_cast<const uint4*>(a.x + p);
          else
            a.out[p] = a.x[p];
        }
      }
    }
    __syncthreads();
    if constexpr (MMA) conv_mma<NT, 0>(a, smem, red, sums, b, t0, f0);
    else conv_fma<0>(a, smem, wsm, red, sums, b, t0, f0);
  }
  __syncthreads();
  float* part = a.part + static_cast<long long>(sl) * 2 * w;
  for (int c = tid; c < 2 * w; c += kThreads) part[c] = sums[c];
  collapse<true>(a);
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
  collapse<false>(a);
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
  collapse<false>(a);
}

// The weight gradient, dW[co][tap][ci] = sum over positions p of dz[p][co]
// in[p + tap][ci], on the CTAs after the dgrad role's: tile wt, split sp
// (positions of patches [npat sp / nsplit, npat (sp + 1) / nsplit) of all
// patches, sample-major). Each writes its partial sums of the tile, went
// floats, into a.wpart; wgrad_reduce adds them.

// float: a thread owns up to five (tap, input channel) pairs by 8 output
// channels, dz and in_i staged as floats
template <typename T>
__device__ void wgrad_fma(const Args<T>& a, unsigned char* smem, int wt, int sp) {
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

// bf16 at w % 8 == 0, on mma.sync: D (chunk rows x output channels) += A
// (chunk rows x positions) B (positions x output channels), K = 16
// positions a step; A is in_i's halo rows shifted by the chunk's tap, B the
// staged dz rows, both taken transposed by ldmatrix. Warp j owns m tiles j
// and j + 4 of the tile, by its wn n tiles.
__device__ void wgrad_mma(const Args<bf16>& a, unsigned char* smem, int wt, int sp) {
  const Plan& g = a.g;
  const int w = g.width, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mg = wt / g.ngroups, ng = wt % g.ngroups;
  const int mlo = mg * g.wm, mhi = min(mlo + g.wm, g.mtiles);
  const int c8lo = (2 * mlo) / 9, c8hi = (min(2 * mhi, g.nq) - 1) / 9;
  const int nc8 = c8hi - c8lo + 1, co8 = ng * g.wn, wn = min(g.wn, w / 8 - co8);
  const int hw = g.hw, his = g.his, hsb = g.hsb, rows = g.tt * g.tf;
  bf16* dzs = reinterpret_cast<bf16*>(smem);                                  // (128, hsb)
  bf16* ins = reinterpret_cast<bf16*>(smem + align16(2 * kThreads * hsb));    // (hpos, his)
  float acc[2][kWgNTiles][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int n = 0; n < kWgNTiles; ++n)
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
  for (long long gp = a0; gp < a1; ++gp) {
    const int b = static_cast<int>(gp / g.pps), pi = static_cast<int>(gp % g.pps);
    int t0, f0;
    patch_origin(g, pi, t0, f0);
    __syncthreads();
    // dz at the patch's positions, the tile's output channels; zero rows
    // past the patch or the grid
    // the two loops' items: dz rows [0, 128 wn), then halo rows
    const int nd = kThreads * wn, n = nd + g.hpos * nc8;
    for (int base = tid; base < n; base += kBatch * kThreads) {
      Raw8 raw[kBatch];
      long long pp[kBatch];
      bool live[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads;
        int t, f, c0;
        bool in_grid;
        if (e < nd) {
          const int r = e / wn;
          t = t0 + r / g.tf;
          f = f0 + r % g.tf;
          c0 = 8 * (co8 + e % wn);
          in_grid = r < rows && t < g.tlen && f < g.flen;
        } else {
          const int q = (e - nd) / nc8;
          t = t0 - 1 + q / hw;
          f = f0 - 1 + q % hw;
          c0 = 8 * (c8lo + (e - nd) % nc8);
          in_grid = t >= 0 && t < g.tlen && f >= 0 && f < g.flen;
        }
        live[u] = e < n && in_grid;
        pp[u] = live[u] ? pos_index(g, b, t, f) : 0;
        raw[u].a = raw[u].b = make_uint4(0, 0, 0, 0);
        if (live[u]) raw[u] = e < nd ? dz_load(a, pp[u], c0) : in_load(a, pp[u], c0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads;
        if (e >= n) continue;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, y[8];
        if (e < nd) {
          const int r = e / wn, nn = e % wn;
          if (live[u]) dz_finish(a, raw[u], b, 8 * (co8 + nn), v);
          *reinterpret_cast<uint4*>(dzs + r * hsb + 8 * nn) = pack8(v);
        } else {
          const int q = (e - nd) / nc8, c = (e - nd) % nc8;
          if (live[u]) in_finish(a, raw[u], b, t0 - 1 + q / hw, 8 * (c8lo + c), v, y);
          *reinterpret_cast<uint4*>(ins + q * his + 8 * c) = pack8(v);
        }
      }
    }
    __syncthreads();
    for (int ks = 0; 16 * ks < rows; ++ks) {
      uint32_t bfr[kWgNTiles][2];
#pragma unroll
      for (int n = 0; n < kWgNTiles; ++n)
        if (n < wn) ldsm_x2_trans(bfr[n], dzs + (16 * ks + (lane & 15)) * hsb + 8 * n);
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
        for (int n = 0; n < kWgNTiles; ++n)
          if (n < wn) mma_bf16_16816(acc[u][n], af, bfr[n]);
      }
    }
  }
  // the partial: entry ((m - mlo) * 16 + row) * (wn_max * 8) + n * 8 + col;
  // zero for m tiles and n tiles past the tile
  const int gq = lane / 4, tg = lane % 4, stride = g.wn * 8;
  float* mine = a.wpart + (static_cast<long long>(wt) * g.nsplit + sp) * g.went;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int ml = warp + 4 * u;
    if (ml >= g.wm) continue;
    const bool live = mlo + ml < mhi;
#pragma unroll
    for (int n = 0; n < kWgNTiles; ++n) {
      if (n >= g.wn) continue;
      const bool ok = live && n < wn;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(mine + (ml * 16 + gq + 8 * h) * stride + n * 8 + 2 * tg) =
            ok ? make_float2(acc[u][n][2 * h], acc[u][n][2 * h + 1]) : make_float2(0.f, 0.f);
    }
  }
}

// After each weight-gradient CTA wrote its partial: the last of each run
// of kSplitChunk splits (an integer ticket with fences) adds the run's
// partials in split order into the run's first slot; the last run to
// finish adds the runs' sums in order and writes the tile's dW_i entries
// in the dtype. Tickets: nchunks + 1 a tile, left zero.
template <bool MMA, typename T>
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
  for (int e4 = tid; e4 < went4; e4 += kThreads) {
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
  for (int e4 = tid; e4 < went4; e4 += kThreads) {
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
      if constexpr (MMA) {
        const int stride = g.wn * 8, ml = e / (16 * stride), row = (e / stride) % 16;
        const int mg = wt / g.ngroups, ng = wt % g.ngroups, mt = mg * g.wm + ml;
        const int q = 2 * mt + row / 8;
        co = 8 * ng * g.wn + e % stride;
        ci = 8 * (q / 9) + row % 8;
        tap = q % 9;
        ok = mt < g.mtiles && q < g.nq && co < w;
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

// K9b (b), group i: CTAs [0, nslabs) the dgrad role (one a slab), the rest
// the weight gradient's (tile wt, split sp).
template <typename T, bool MMA, int NT>
__global__ void __launch_bounds__(kThreads) k9b_grad_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& g = a.g;
  const int w = g.width, tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < g.nslabs) {
    const int halo_bytes = MMA ? align16(g.hpos * g.hs * 2) : align16(g.hpos * g.hs * 4);
    float* wsm = reinterpret_cast<float*>(smem + halo_bytes);
    float* red = wsm + (MMA ? 0 : 9 * w * kCoTile);
    const int sl = blockIdx.x, b = sl / g.k;
    if constexpr (MMA) {
      if (weights_staged(g)) stage_weights(a, smem);
    }
    int p0, p1;
    slab_patches(g, sl, p0, p1);
    for (int pi = p0; pi < p1; ++pi) {
      int t0, f0;
      patch_origin(g, pi, t0, f0);
      __syncthreads();
      stage_halo<T, MMA, true>(a, smem, b, t0, f0);
      __syncthreads();
      if constexpr (MMA) conv_mma<NT, 1>(a, smem, red, nullptr, b, t0, f0);
      else conv_fma<1>(a, smem, wsm, red, nullptr, b, t0, f0);
    }
    return;
  }
  const int wb = blockIdx.x - g.nslabs, wt = wb / g.nsplit, sp = wb % g.nsplit;
  if constexpr (MMA) wgrad_mma(a, smem, wt, sp);
  else wgrad_fma(a, smem, wt, sp);
  wgrad_reduce<MMA>(a, wt, sp);
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

template <typename T, bool MMA, int NT>
int launch_fwd(const Args<T>& a, int smem, cudaStream_t stream) {
  const int code = set_smem(reinterpret_cast<const void*>(k9_fwd_kernel<T, MMA, NT>), smem);
  if (code) return code;
  k9_fwd_kernel<T, MMA, NT><<<a.g.nslabs, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool MMA, int NT>
int launch_grad(const Args<T>& a, int smem, cudaStream_t stream) {
  const int code = set_smem(reinterpret_cast<const void*>(k9b_grad_kernel<T, MMA, NT>), smem);
  if (code) return code;
  k9b_grad_kernel<T, MMA, NT>
      <<<a.g.nslabs + a.g.wtiles * a.g.nsplit, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the conv launches' variant: the mma kernels (bf16, by NT) or the float one
#define VSV_TRAIN_DISPATCH(LAUNCH, T, a, smem, stream)                         \
  do {                                                                         \
    if ((a).g.mma) {                                                           \
      if constexpr (std::is_same<T, bf16>::value) {                            \
        switch ((a).g.nt) {                                                    \
          case 1: return LAUNCH<T, true, 1>((a), (smem), (stream));            \
          case 2: return LAUNCH<T, true, 2>((a), (smem), (stream));            \
          case 3: return LAUNCH<T, true, 3>((a), (smem), (stream));            \
          case 4: return LAUNCH<T, true, 4>((a), (smem), (stream));            \
          default: return vsv::kShapeUnsupported;                              \
        }                                                                      \
      }                                                                        \
      return vsv::kShapeUnsupported;                                           \
    }                                                                          \
    return LAUNCH<T, false, 1>((a), (smem), (stream));                         \
  } while (0)

template <typename T>
int fwd_dispatch(const Args<T>& a, int smem, cudaStream_t stream) {
  VSV_TRAIN_DISPATCH(launch_fwd, T, a, smem, stream);
}

template <typename T>
int grad_dispatch(const Args<T>& a, int smem, cudaStream_t stream) {
  VSV_TRAIN_DISPATCH(launch_grad, T, a, smem, stream);
}

#undef VSV_TRAIN_DISPATCH

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

// K9, group i in [0, s-2]. dtype: 0 float32, 1 bfloat16.
extern "C" int split_train_fwd(int dtype, int i, const int* plan, const void* x,
                               const void* zprev, const float* sprev, const float* mask,
                               const void* wk, void* z, float* stats, float* run_mean,
                               float* run_var, void* out, float* part, int* ticket, float eps,
                               float mom, float upd_mean, float upd_var, int smem,
                               void* stream) {
  Plan g;
  if (!make_plan(plan, &g) || (g.mma && dtype != 1) || smem != conv_smem(g)) return vsv::kPlanMismatch;
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
// [i w, (i + 1) w). wk: the group's flipped weights (w, 9 w), rows the input
// channels. wpart_floats: the scratch's size, at least wtiles * nsplit *
// went.
extern "C" int split_train_bwd_grad(int dtype, int i, const int* plan, const void* x,
                                    const void* zprev, const float* sprev, const float* mask,
                                    const void* z, const float* stats, const float* bsums,
                                    const void* dy, const void* wk, void* dx, void* dweight,
                                    float* wpart, int* wtickets, int smem,
                                    long long wpart_floats, void* stream) {
  Plan g;
  if (!make_plan(plan, &g) || (g.mma && dtype != 1) ||
      smem != std::max(conv_smem(g), wgrad_smem(g)) ||
      wpart_floats < static_cast<long long>(g.wtiles) * g.nsplit * g.went)
    return vsv::kPlanMismatch;
  if (i < 0 || i > g.split - 2 || (i > 0 && (zprev == nullptr || sprev == nullptr)))
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
    return grad_dispatch<T>(a, smem, s);                                       \
  }
  if (dtype == 0) VSV_GRAD_LAUNCH(float)
  if (dtype == 1) VSV_GRAD_LAUNCH(bf16)
#undef VSV_GRAD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
