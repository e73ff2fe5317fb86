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
// 1.0f / 9.0f), so the tail is that function's bits.
//
// Bound on the card: bytes. A stage reads x once and writes a quarter of it
// (10 s w bytes an output position in bf16) for 18 w^2 (s-1) flops: 259
// flop/B at w = 192, s = 4, below Hopper's ridge (~295), less at the
// narrower widths. The three stride-2 stages of a res2net50_w24_s4_c32
// serving forward (B = 128, 1000 frames) move 8.60 GB (2.57 ms at 3.35 TB/s)
// for 0.96 TFLOP (0.97 ms at 989 TFLOP/s). One launch a stage; its work is
// the output tiles of each group: the conv of groups < s-1, the average
// pool of group s-1.
//
// * "mma" (bfloat16 at the registered Res2Nets' stride-2 widths, 16-192,
//   and the thin variants' 8): persistent CTAs, as many as fit the card,
//   walk the stage's work items, group-major: an item is a tt x tf tile of
//   one utterance's output positions (128 rows, 64 at w = 64) and one
//   group. It stages the group's input patch, (2tt+1) x (2tf+1) positions,
//   straight from x at channel offset i*w by cp.async, zero-filled outside
//   the utterance; the even and the odd columns of a patch row are stored
//   apart, so the rows of an mma fragment (consecutive f', two columns
//   apart in x) are consecutive in shared memory and the row stride, an
//   odd number of 16-byte units, keeps ldmatrix free of bank conflicts. At
//   w = 96 and 192 the patch is staged in two passes of w / 2 channels, so
//   a 128-row tile fits beside the weights. The weights (all w output
//   channels, K tap-major per pass) stay resident in shared memory where
//   they fit (w <= 96, reloaded where a CTA's group changes), else go
//   through a ring of two slices, the next loading while this one
//   computes. mma.sync m16n8k16 with fp32 accumulation, a warp 32 rows by 8
//   nt output channels; K is walked tap by tap with no division in the
//   loop. The epilogue rounds, applies the eval BN and relu, stages the
//   tile in the patch's place and stores 16-byte rows into the output's
//   channel slice; the pool items add the nine taps out of their patch.
//   What bounds it: at w = 48 the patch loads, exposed between items (a
//   second patch buffer, the next item's landing during this one's
//   compute, costs occupancy and lost at every width); at w = 192 the
//   weight stream from L2 (648 KB a group, once a 128-row tile).
//   models/res2net.py:stride2_candidates lists the plans, in the order
//   timed on the card.
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

namespace {

constexpr int kSmemMax = 232448;  // 227 KB, the most a block can take
constexpr int kMaxThreads = 256;
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

// K columns of a tap in the mma design's weights: the W input channels
// padded to whole k steps of 16 (models/res2net.py:_stride2_tap_cols)
__host__ __device__ constexpr int tap_cols(int width) { return (width + 15) / 16 * 16; }

// Shared memory of the mma design: the patch of width / passes channels,
// wstages weight slices, an mbarrier each (models/res2net.py:_stride2_smem)
__host__ __device__ constexpr long long mma_smem(int width, int tt_n, int tf_n, int ksl,
                                                 int wstages, int passes) {
  return 2LL * ((2LL * tt_n + 1) * (2 * tf_n + 1) * halo_stride(width / passes) +
                static_cast<long long>(wstages) * width * (ksl + 8)) +
         8LL * (1 + wstages);
}

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

// Persistent CTAs walk the stage's work items, group-major: item = group *
// tiles + tile, a tile tt x tf output positions of one utterance. Every item
// stages its group's input patch by cp.async, a row of the patch a warp at
// a time, in P passes of W / P channels (P = 2 halves the patch, so a
// 128-row tile fits beside the weight ring at w = 192 and each weight
// slice feeds twice the rows); a conv item (group < s-1) runs the implicit
// GEMM over its weights, an average-pool item (group s-1) adds the nine
// taps out of the same patch. Weights: all slices resident (wstages >=
// slices; reloaded where a CTA's group changes), or a ring of wstages
// slices, wstages - 1 in flight. Each buffer completes on its own mbarrier.
// K runs pass by pass, then tap by tap, each tap's W / P channels padded to
// whole k steps of 16 (tap_cols), so a k step never straddles two taps: its
// A rows are the lane's row offset plus the tap's offset plus the chunk's,
// with no division in the loop. B fragments come two n tiles to an
// ldmatrix.x4.
template <int W, int NT, int P>
__global__ void __launch_bounds__(kMaxThreads) stride2_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wk,
    const GroupStats stats, __nv_bfloat16* __restrict__ out, int batch, int tlen, int flen,
    int tout, int fout, int split, int tt_n, int tf_n, int ksl, int wstages, float eps) {
  constexpr int WP = W / P, C8 = WP / 8, KT = tap_cols(WP), KSPT = KT / 16;
  constexpr int KPASS = 9 * KT, KPAD = P * KPASS;
  constexpr int HS = halo_stride(WP), OS = halo_stride(W), CO8 = W / 8, WN = W / (8 * NT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthreads = blockDim.x, nwarps = nthreads / 32;
  const int channels = split * W, rows = tt_n * tf_n;
  const int pf_n = 2 * tf_n + 1, pt_n = 2 * tt_n + 1;
  const int ws_stride = ksl + 8, nsp = (KPASS + ksl - 1) / ksl, nslices = P * nsp;
  const bool resident = wstages >= nslices;
  const int tiles_f = (fout + tf_n - 1) / tf_n, tiles_t = (tout + tt_n - 1) / tt_n;
  const int ntiles = batch * tiles_t * tiles_f, items = split * ntiles;
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wsm = patch + pt_n * pf_n * HS;
  uint64_t* pbar = reinterpret_cast<uint64_t*>(wsm + wstages * W * ws_stride);
  uint64_t* wbar = pbar + 1;
  if (tid == 0) {
    for (int i = 0; i < 1 + wstages; ++i) mbar_init(&pbar[i], nthreads);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  // the patch of pass p: position (pt, pf) at row pt, slot pf / 2 (even
  // pf) or tf + 1 + pf / 2 (odd pf); a warp a row
  auto load_patch = [&](int item, int p) {
    const int grp = item / ntiles, tile = item % ntiles;
    const int b = tile / (tiles_t * tiles_f);
    const int t0 = (tile / tiles_f) % tiles_t * tt_n, f0 = tile % tiles_f * tf_n;
    for (int pt = warp; pt < pt_n; pt += nwarps) {
      const int t = 2 * t0 - 1 + pt;
      const bool row_valid = t >= 0 && t < tlen;
      const long long row = (static_cast<long long>(b) * tlen + t) * flen;
      for (int j = lane; j < pf_n * C8; j += 32) {
        const int pf = j / C8, c = (j % C8) * 8, f = 2 * f0 - 1 + pf;
        const bool valid = row_valid && f >= 0 && f < flen;
        const int slot = (pf & 1) ? tf_n + 1 + (pf >> 1) : (pf >> 1);
        cp_async16(smem_u32(patch + (pt * pf_n + slot) * HS + c),
                   x + (valid ? (row + f) * channels : 0) + grp * W + p * WP + c, valid);
      }
    }
    cp_async_arrive(pbar);
  };
  // slice j of group grp's weights (slice j % nsp of pass j / nsp) into
  // weight buffer buf
  auto load_slice = [&](int grp, int j, int buf) {
    const int kp = j % nsp * ksl, k0 = j / nsp * KPASS + kp, k8 = min(ksl, KPASS - kp) / 8;
    const __nv_bfloat16* wg = wk + static_cast<long long>(grp) * W * KPAD + k0;
    __nv_bfloat16* ws = wsm + buf * W * ws_stride;
    for (int i = tid; i < W * k8; i += nthreads) {
      const int n = i / k8, k = (i % k8) * 8;
      cp_async16(smem_u32(ws + n * ws_stride + k), wg + static_cast<long long>(n) * KPAD + k,
                 true);
    }
    cp_async_arrive(&wbar[buf]);
  };

  const int wm_idx = warp / WN, wn_idx = warp % WN;
  // this lane's A rows (lane % 16 of each m tile) at tap (0, 0); rows past
  // the tile read a valid row and are never stored
  int rowoff[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = min(wm_idx * 32 + mt * 16 + lane % 16, rows - 1);
    rowoff[mt] = (2 * (r / tf_n) * pf_n + r % tf_n) * HS + (lane / 16) * 8;
  }
  // B rows: n tile pairs by ldmatrix.x4 (lanes 16-31 the second tile), a
  // last odd tile by .x2
  const int bcol4 = ((lane % 8) + 8 * (lane / 16)) * ws_stride + ((lane / 8) % 2) * 8;
  const int bcol2 = (lane % 8) * ws_stride + ((lane / 8) % 2) * 8;
  const int nbase = wn_idx * NT * 8 * ws_stride;

  int fills = 0, q = 0, wloads = 0, wgroup = -1;
  if (static_cast<int>(blockIdx.x) < items) load_patch(blockIdx.x, 0);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int grp = item / ntiles, tile = item % ntiles;
    const int b = tile / (tiles_t * tiles_f);
    const int t0 = (tile / tiles_f) % tiles_t * tt_n, f0 = tile % tiles_f * tf_n;
    const bool conv = grp < split - 1;
    if (conv) {
      if (!resident) {
        for (int j = 0; j < min(wstages - 1, nslices); ++j)
          load_slice(grp, j, (q + j) % wstages);
      } else if (grp != wgroup) {
        for (int j = 0; j < nslices; ++j) load_slice(grp, j, j);
        wgroup = grp;
        ++wloads;
      }
    }
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int p = 0; p < P; ++p) {
      if (p > 0) {  // the next pass's channels into the patch
        __syncthreads();
        load_patch(item, p);
      }
      mbar_wait(pbar, fills++ & 1);
      if (!conv) {  // the average pool of the last group, out of the patch
        for (int i = tid; i < rows * C8; i += nthreads) {
          const int r = i / C8, c = (i % C8) * 8;
          const int ot = r / tf_n, of = r % tf_n;
          if (t0 + ot >= tout || f0 + of >= fout) continue;
          float v8[8];
#pragma unroll
          for (int di = 0; di < 3; ++di)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
              const int slot = dj == 1 ? tf_n + 1 + of : of + dj / 2;
              float v[8];
              vsv::unpack16(*reinterpret_cast<const uint4*>(
                                patch + ((2 * ot + di) * pf_n + slot) * HS + c),
                            v, patch);
#pragma unroll
              for (int e = 0; e < 8; ++e)
                v8[e] = (di == 0 && dj == 0) ? v[e] : vsv::round_to<__nv_bfloat16>(v8[e] + v[e]);
            }
#pragma unroll
          for (int e = 0; e < 8; ++e) v8[e] = v8[e] * (1.0f / 9.0f);
          vsv::store16(out + ((static_cast<long long>(b) * tout + t0 + ot) * fout + f0 + of) *
                                 channels + grp * W + p * WP + c,
                       v8);
        }
        continue;
      }
      const uint32_t pbase = smem_u32(patch);
      for (int jj = 0; jj < nsp; ++jj) {
        const int j = p * nsp + jj;
        int buf = j;
        if (resident) {
          mbar_wait(&wbar[j], (wloads - 1) & 1);
        } else {
          buf = q % wstages;
          // keep wstages - 1 slices in flight: the next goes into the
          // buffer the previous slice freed
          if (j + wstages - 1 < nslices)
            load_slice(grp, j + wstages - 1, (q + wstages - 1) % wstages);
          mbar_wait(&wbar[buf], (q / wstages) & 1);
        }
        const int ks0 = jj * ksl / 16, ksteps = min(ksl, KPASS - jj * ksl) / 16;
        int tap = ks0 / KSPT, ksi = ks0 % KSPT;
        int toff = (tap / 3) * pf_n * HS + (tap % 3 == 1 ? (tf_n + 1) * HS : (tap % 3) / 2 * HS);
        const uint32_t wbase = smem_u32(wsm + buf * W * ws_stride + nbase);
#pragma unroll 2
        for (int kk = 0; kk < ksteps; ++kk) {
          // the lane's 8-channel chunk of this tap; a tap's pad chunk (odd
          // C8) reads the last real chunk again, times the zero weights
          int cc = 16 * ksi;
          if (C8 % 2 != 0 && cc + (lane / 16) * 8 >= WP) cc -= 8;
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(af[mt], pbase + 2 * (rowoff[mt] + toff + cc));
#pragma unroll
          for (int np = 0; np + 1 < NT; np += 2) {
            uint32_t bq[4];
            ldmatrix_x4(bq, wbase + 2 * (np * 8 * ws_stride + bcol4 + 16 * kk));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16_16816(acc[mt][np], af[mt], bq);
              mma_bf16_16816(acc[mt][np + 1], af[mt], bq + 2);
            }
          }
          if constexpr (NT % 2 != 0) {
            uint32_t bf[2];
            ldmatrix_x2(bf, wbase + 2 * ((NT - 1) * 8 * ws_stride + bcol2 + 16 * kk));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][NT - 1], af[mt], bf);
          }
          if (++ksi == KSPT) {
            ksi = 0;
            ++tap;
            toff = (tap / 3) * pf_n * HS + (tap % 3 == 1 ? (tf_n + 1) * HS : (tap % 3) / 2 * HS);
          }
        }
        if (!resident) {
          __syncthreads();  // this slice's buffer is free for the refill
          ++q;
        }
      }
    }
    if (conv) {
      if (resident) __syncthreads();  // every warp is done with the patch

      // epilogue: round the conv output to bf16, eval BN, relu, into the
      // patch's place at stride OS, then 16-byte rows to the output
      const float* mu = stats.mean[grp];
      const float* vr = stats.var[grp];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = (wn_idx * NT + nt) * 8 + 2 * tg;
        const float m0 = mu[co], m1 = mu[co + 1];
        const float i0 = 1.f / sqrtf(vr[co] + eps), i1 = 1.f / sqrtf(vr[co + 1] + eps);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm_idx * 32 + mt * 16 + g + 8 * h;
            if (r >= rows) continue;
            const float v0 = vsv::round_to<__nv_bfloat16>(acc[mt][nt][2 * h]);
            const float v1 = vsv::round_to<__nv_bfloat16>(acc[mt][nt][2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(patch + r * OS + co) =
                __floats2bfloat162_rn(fmaxf((v0 - m0) * i0, 0.f), fmaxf((v1 - m1) * i1, 0.f));
          }
      }
      __syncthreads();
      for (int i = tid; i < rows * CO8; i += nthreads) {
        const int r = i / CO8, c = (i % CO8) * 8;
        const int ot = t0 + r / tf_n, of = f0 + r % tf_n;
        if (ot < tout && of < fout)
          *reinterpret_cast<uint4*>(out + ((static_cast<long long>(b) * tout + ot) * fout + of) *
                                              channels + grp * W + c) =
              *reinterpret_cast<const uint4*>(patch + r * OS + c);
      }
    }
    __syncthreads();  // the patch is free for the next item
    if (item + static_cast<int>(gridDim.x) < items) load_patch(item + gridDim.x, 0);
  }
}

template <int W, int NT, int P>
int launch_mma(const void* x, const void* wk, const GroupStats& stats, void* out, int batch,
               int tlen, int flen, int split, int wm, int tt_n, int tf_n, int ksl, int wstages,
               float eps, long long plan_smem, int num_sms, cudaStream_t stream) {
  const int tout = (tlen - 1) / 2 + 1, fout = (flen - 1) / 2 + 1;
  const int threads = 32 * wm * (W / (8 * NT)), kpass = 9 * tap_cols(W / P);
  const int nslices = P * ((kpass + ksl - 1) / ksl);
  if (threads > kMaxThreads || tt_n < 1 || tf_n < 1 || tf_n > 16 || tt_n * tf_n > 32 * wm ||
      ksl < 16 || ksl % 16 != 0 || wstages < 1 || wstages > 8 ||
      (wstages < nslices && wstages < 2) || num_sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = mma_smem(W, tt_n, tf_n, ksl, wstages, P);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem != plan_smem) return vsv::kPlanMismatch;
  const long long items = static_cast<long long>(split) * batch * ((tout + tt_n - 1) / tt_n) *
                          ((fout + tf_n - 1) / tf_n);
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = stride2_mma_kernel<W, NT, P>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long grid = std::min<long long>(items, static_cast<long long>(per_sm) * num_sms);
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wk), stats,
      static_cast<__nv_bfloat16*>(out), batch, tlen, flen, tout, fout, split, tt_n, tf_n, ksl,
      wstages, eps);
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
// bfloat16. plan: 9 host ints (models/res2net.py:stride2_plan): design (0
// "mma", 1 "vec", 2 "single"), nt, wm, tt, tf, ksl, wstages, passes, tn. x:
// (B, T, F, split * width) channels-last; wk: "mma" (split-1, width,
// passes, 9, tap_cols(width / passes)) bfloat16, row n of group i holding
// output channel n's taps, a pass's block of width / passes input channels
// at a time, each tap's zero-padded to tap_cols; "vec" / "single" the JAX
// layout (3, 3, width, width * (split-1)). stats: a host array of 2
// (split-1) device pointers, each group's (width,) float32 running mean,
// then each group's running variance. out: (B, T', F', split * width)
// channels-last. "mma" and "vec" need 16-byte aligned pointers; "mma" takes
// bfloat16 at the (width, nt, passes) below, wm * width / (8 nt) warps <= 8,
// the tile tt x tf <= 32 wm positions, wstages weight buffers (all the
// slices, or a ring of at least 2), its shared memory mma_smem(...) passed
// as plan_smem (refused where it differs: vsv::kPlanMismatch), and as many
// persistent CTAs as fit num_sms SMs; "vec" and "single" pass plan_smem 0.
extern "C" int split_stride2(int dtype, const int* plan, const void* x, const void* wk,
                             const void* const* stats, void* out, int batch, int tlen, int flen,
                             int split, int width, float eps, long long plan_smem, int num_sms,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int design = plan[0], nt = plan[1], wm = plan[2], tt_n = plan[3], tf_n = plan[4];
  const int ksl = plan[5], wstages = plan[6], passes = plan[7], tn = plan[8];
  if (batch < 1 || tlen < 1 || flen < 1 || split < 2 || split - 1 > kMaxGroups || width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GroupStats st{};
  for (int i = 0; i < split - 1; ++i) {
    st.mean[i] = static_cast<const float*>(stats[i]);
    st.var[i] = static_cast<const float*>(stats[split - 1 + i]);
  }
  if (design == 0) {
    if (dtype != 1 || (wm != 2 && wm != 4)) return static_cast<int>(cudaErrorInvalidValue);
#define VSV_S2_MMA(W, N, P)                                                                    \
  if (width == W && nt == N && passes == P)                                                    \
    return launch_mma<W, N, P>(x, wk, st, out, batch, tlen, flen, split, wm, tt_n, tf_n, ksl,  \
                               wstages, eps, plan_smem, num_sms, s);
    VSV_S2_MMA(8, 1, 1)
    VSV_S2_MMA(16, 1, 1)
    VSV_S2_MMA(32, 2, 1)
    VSV_S2_MMA(48, 3, 1)
    VSV_S2_MMA(64, 4, 1)
    VSV_S2_MMA(64, 4, 2)
    VSV_S2_MMA(96, 6, 1)
    VSV_S2_MMA(96, 6, 2)
    VSV_S2_MMA(192, 6, 1)
    VSV_S2_MMA(192, 12, 2)
#undef VSV_S2_MMA
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
