// K1: Kaldi log-mel FBANK, waveform -> (T, num_bins), with or without dither.
//
// Replaces: voxsrc2020_speaker_verification_tpu/ops/fbank.py:fbank (the
// retired Pallas kernel ops/pallas/fbank.py:fbank_fused computed exactly it).
//
// Every per-frame step before the power spectrum is linear in the frame, so
// it folds into two fp32 matrices A, B (frame_length x num_fft_bins):
//   power = (x A)^2 + (x B)^2,   fbank = log(max(power M, FLT_EPSILON)).
// M comes by columns: column c's weights over the run of FFT bins from its
// first to its last nonzero (a triangular mel filter spans consecutive
// bins), all runs packed in column order.
//
// Bound on the card: operations. Per frame 4 * frame_length * num_fft_bins
// flops of analysis (409,600 at 400 x 256) against 1.6 KB of new samples
// and 320 B of output, so the fp32 peak bounds it, not HBM. The dot products
// run as fp32 FMA on CUDA cores on purpose: power = re^2 + im^2 cancels,
// and TF32 or bf16 inputs (10 or 8 mantissa bits) cost visible log-mel error.
//
// Design: the analysis matrices stay in shared memory and the frames stream
// past them. A thread-block cluster of 8 CTAs splits the 256 FFT bins (32
// each); each CTA stages its A/B column slice (400 x 32 x 2 fp32, 100 KB)
// and the packed M once, then walks 32-frame tiles of the batch. The
// clusters are persistent, as many as the card holds at once (from the
// occupancy query: 15 on an H100, one CTA an SM), and take tiles
// cluster_id, + clusters, ...; so an 8 s wave (25 tiles) spreads over the
// card and each A/B element read from L2 serves every tile its CTA takes.
// - A tile's samples (31 shifts + a frame) arrive as one contiguous run by
//   16-byte cp.async, four floats of padding after every frame shift, so
//   the frames a lane reads at one sample (f, f + 4, ..., f + 28) sit in
//   banks apart from the other lanes'. The next tile's samples are in
//   flight during this one's arithmetic (two buffers).
// - 8 warps split the 400 samples of a frame (50 each); lane l owns 8
//   frames x 4 bins (re and im: 64 accumulators) and per sample reads 8
//   words of samples and 2 16-byte words of A/B for 64 FMA. The warps'
//   partial sums are added in warp order.
// - Mel: each CTA sends its power values to the CTA that owns their frame
//   (rank r owns frames 4r .. 4r + 3) through distributed shared memory;
//   the owner takes each mel column over its run of bins, in bin order,
//   and the log once. The cluster barrier between is split: a CTA arrives
//   after sending tile j and waits only after its analysis of tile j + 1,
//   so the barrier's latency hides behind the FMA (power buffers are
//   double-buffered); the first wait pairs with an arrival on start-up, so
//   no CTA writes to another before it runs. No atomics: reruns agree bit
//   for bit.
// Dither (raw-audio training): Kaldi adds dither * N(0, 1) to every framed
// sample before remove-DC, so each (frame, sample) pair has its own draw and
// the frames cannot share one staged run of samples. The caller passes the
// draws as a contiguous fp32 tensor (batch, num_frames, frame_length); the
// dithered variant (kDither, picked by a non-null noise pointer) adds
// dither * noise[b, t, r] to each framed sample before its FMAs, as the
// first design did, and its sums run in the same order: its outputs are
// that design's bit for bit.
// - Its FMA loop reads staged dithered samples, 8 words and 2 of A/B a
//   sample for 64 FMA, as the dither-off loop reads the shared samples.
// - Each warp stages its own rows, 16 samples of the tile's 32 frames at a
//   time, into a ring of two chunks (frame rows 17 floats apart: the loop's
//   4 frames at one sample sit in 4 banks) inside `red`, the partial sums'
//   buffer, which the tile uses only after its FMA loop (a barrier between):
//   the layout does not grow. A lane loads the next chunk's 16 draws (4
//   frames x 8 samples a warp load) into registers while the warp
//   multiplies this chunk, then loads the chunk's 16 samples before it
//   stores any dithered one (so the loads overlap, instead of each waiting
//   behind the store before it). At a tile's start the CTAs of a cluster
//   prefetch the next tile's draws into L2 (rank r: frames 4r .. 4r + 3).
// - The first design read the 8 draws of each sample in the FMA loop by
//   __ldg (18 loads per 64 FMA, 4 frames' rows a warp load). What is left
//   above dither off is the staging itself (scripts/profile_k1.py: issuing
//   the loads and the adds, not waiting for the loads). Tried on an H100
//   and dropped (PERF.md): 8- and 24-sample chunks (slower, and faster by
//   under 1%), draws by tensor copies into a 4-chunk ring (the partial sums
//   in two halves beside it; slower and, as written, not bit-equal), each
//   CTA reading another row's draws (slower: the cluster's reads of one
//   line are L2 hits).
// - Each CTA of a cluster loads the tile's draws (51 KB) from L2; from HBM
//   once (205 MB at the training shape, 256 x 500 frames: 0.06 ms against
//   0.78 ms of fp32 FMA). Staging them once a cluster (a multicast tensor
//   copy, or one rank's copy read by the others through DSMEM) was not
//   built: a build that loads no draws at all (scripts/profile_k1.py
//   --probe) bounds what it could save, about a tenth of the call (PERF.md).
// General path (fbank_general_f32), for the shapes the design above does
// not take: more than 256 FFT bins (a padded frame over 512 samples, as at
// 32 kHz or with a 50 ms frame) or a count not a multiple of 4, more than
// kMelCap packed mel weights, a frame length or shift over 4096, or a
// layout over a CTA's shared memory. Its first design (a thread a bin, 8
// frames a CTA, A/B and the dense M read from L2 for every 8 frames) ran
// at ~9 of the 67 TFLOP/s, slower than its plain version. This one is a
// register-tiled fp32 GEMM of the frames (T x frame_length, read from the
// wave at stride frame_shift) by [A | B]:
// - A CTA takes a tile of 64 frames x 64 FFT bins (re and im) of one
//   utterance, grid (frame tiles x bin tiles, batch); the plan is
//   ops/fbank.py:general_plan.
// - The K-loop walks a frame's samples in chunks of 32: the A/B rows of the
//   tile's bins and the tile's frame samples (zero past the frame and past
//   the last frame; with the draws beside them, added at staging as
//   x + dither * noise, the fast design's rule) arrive by cp.async in a
//   ring of 3 chunks in shared memory, so each staged A/B value serves 64
//   frames and the next chunks load during this one's arithmetic.
// - 8 warps: two halves of each chunk's samples, each half 4 warps of 32 x
//   32 (frames x bins); a thread holds 8 frames (4 apart) x 4 bins x (re,
//   im) in registers and per 4 samples reads 8 + 8 16-byte words for 256
//   FMA, each load a broadcast without bank conflicts. The halves add in a
//   fixed order.
// - Epilogue: power into shared memory, then each mel column whose packed
//   run (mel_columns, as the fast design takes M) meets the tile's bins
//   sums its share; those partials go to a buffer (bin tile, utterance,
//   frame, column) and the last bin tile of the frame tile to arrive (an
//   integer ticket with fences) adds each column's tiles in order and takes
//   the log. No float atomics: reruns agree bit for bit.
// Bound as above (operations). One tile a CTA: an 8 s wave at 32 kHz is
// 13 x 8 = 104 CTAs, under the 132 SMs. What holds it well above its
// bound is the FMA loop's issue rate, not the staging; 8 x 8 register tiles
// (fewer shared loads an FMA), smaller unrolls and 64-sample chunks did not
// raise it.
// The fast design's launch decisions (cluster, tile, warps, grid, variant)
// are made here; the wrapper passes shapes, the packed M and the noise. The
// general path's tile plan is ops/fbank.py:general_plan (its column table,
// scratch and shared memory, which the entry checks against this layout).
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 8;     // CTAs of a cluster, each a slice of the FFT bins
constexpr int kBins = 32;     // FFT bins a CTA: at most kSplit * kBins = 256
constexpr int kFrames = 32;   // frames a tile
constexpr int kWarps = 8;     // each a share of the frame's samples
constexpr int kThreads = 32 * kWarps;
constexpr int kVals = 64;     // accumulators a lane: 8 frames x 4 bins, re and im
constexpr int kMaxMel = 128;  // mel columns a launch: wider banks run in chunks of 128
constexpr int kMelCap = 1024;  // packed M in shared memory: a Kaldi bank has <= 2 per FFT bin
constexpr int kSmemMax = 227 * 1024;
constexpr int kRowFloats = 2 * kBins;  // an A/B row of the slice: A | B
constexpr int kFramesPerRank = kFrames / kSplit;
constexpr int kPad = 4;        // floats after every frame shift of a tile's samples
// dither: a warp's staged chunk, 32 frames x kDRows samples, frame rows
// kDStride floats apart (odd: 4 frames at one sample in 4 banks); two of
// them a warp, inside `red`
constexpr int kDRows = 16;
constexpr int kDStride = kDRows + 1;
constexpr int kDChunk = kFrames * kDStride;

static_assert(kFrames % kSplit == 0, "each rank owns whole frames");
static_assert(kFrames == 32 && kBins == 32 && kWarps == 8,
              "lane tiles: 4 x 8 frames by 8 x 4 bins; the merge: warp w, frame row w");
static_assert(kWarps * 2 * kDChunk <= kWarps * kVals * 32,
              "the dithered samples' ring fits in red");
static_assert(kDRows % 8 == 0, "a lane stages kDRows / 8 samples of 8 frames a chunk");

__host__ __device__ __forceinline__ int rows_per_warp(int frame_length) {
  return (frame_length + kWarps - 1) / kWarps;
}

// A tile's samples: frames 0..31 at rows up to the padded frame length.
__host__ __device__ __forceinline__ int seg_samples(int frame_length, int frame_shift) {
  return (kFrames - 1) * frame_shift + rows_per_warp(frame_length) * kWarps;
}
// Floats of one padded buffer of them (a multiple of 4).
__host__ __device__ __forceinline__ int seg_floats(int frame_length, int frame_shift) {
  const int n = seg_samples(frame_length, frame_shift);
  return (n + kPad * ((n + frame_shift - 1) / frame_shift) + 3) & ~3;
}

// Shared-memory layout, in floats from the start.
struct Layout {
  int ab, seg, red, rcv, wts, total;
  __host__ __device__ Layout(int frame_length, int frame_shift) {
    const int kpad = rows_per_warp(frame_length) * kWarps;
    ab = 0;                                                 // kpad x kRowFloats
    seg = ab + kpad * kRowFloats;                           // 2 padded sample buffers
    red = seg + 2 * seg_floats(frame_length, frame_shift);  // kWarps x kVals x 32 lanes
    rcv = red + kWarps * kVals * 32;                        // 2 x kFramesPerRank x 256 power
    wts = rcv + 2 * kFramesPerRank * kSplit * kBins;        // kMelCap packed M
    total = wts + kMelCap;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes of which the first `bytes` are copied and the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// The cluster barrier in two halves (release on arrival, acquire on wait).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The fast design's phase profile (a build with -DVSV_K1_PROF,
// scripts/profile_k1.py): lane 0 of every warp laps clock64 into its phases
// and adds them, once at its end, to g_k1_prof[variant][slot] (variant:
// dither off, on). Phases: the tile's samples landing (wait), staging the
// dithered samples (stage: the draws' loads issued, the adds and stores),
// waiting for the draws' loads (draws: a use of the loaded registers
// before staging them), the FMA loop (fma), the warps' meeting after it
// (join), the previous tile's mel (mel), the merge and send of the power
// (merge); slot kK1Warps counts the warps. Without the flag every call is
// empty.
enum { kK1Wait, kK1Stage, kK1Draws, kK1Fma, kK1Join, kK1Mel, kK1Merge, kK1Warps, kK1Slots };
#ifdef VSV_K1_PROF
__device__ unsigned long long g_k1_prof[2 * kK1Slots];
struct K1Prof {
  unsigned long long v[kK1Slots];
  long long t;
  __device__ K1Prof() {
    for (int i = 0; i < kK1Slots; ++i) v[i] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void lap(int slot) {
    const long long n = clock64();
    v[slot] += n - t;
    t = n;
  }
  // wait until the loads into v have landed
  template <int H>
  __device__ __forceinline__ void touch(const float (&v)[H][8]) {
    float t = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int m = 0; m < 8; ++m) t += v[h][m];
    asm volatile("" ::"f"(t));
  }
  __device__ void flush(int variant) {
    if ((threadIdx.x & 31) != 0) return;
    v[kK1Warps] = 1;
    for (int i = 0; i < kK1Slots; ++i) atomicAdd(&g_k1_prof[variant * kK1Slots + i], v[i]);
  }
};
#else
struct K1Prof {
  __device__ __forceinline__ void lap(int) {}
  template <int H>
  __device__ __forceinline__ void touch(const float (&)[H][8]) {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

struct Args {
  const float* waves;
  const float* a;
  const float* b;
  const int* mel_start;  // (num_bins,) first FFT bin of column c's run
  const int* mel_off;    // (num_bins + 1,) offsets of the runs in mel_w
  const float* mel_w;    // (mel_nnz,) the runs
  float* out;
  int num_samples, num_frames, frame_length, frame_shift, num_fft_bins, num_bins, mel_nnz;
  int col0, ncols;  // this launch's chunk of mel columns: col0 .. col0 + ncols - 1
  int use_power, use_log, tiles, work;  // work = batch * tiles
  float floor_value;
  const float* noise;  // (batch, num_frames, frame_length), or null: no dither
  float dither;
};

// Work item j's samples into a padded buffer: sample o of the tile at
// o + kPad * (o / frame_shift), zeros past the wave's end. Whole frame
// shifts by 16-byte copies where the run is 16-byte aligned, else sample
// by sample.
__device__ __forceinline__ void stage_samples(const Args& g, float* seg, int j) {
  const int bb = j / g.tiles, t0 = (j % g.tiles) * kFrames;
  const float* wave = g.waves + static_cast<long long>(bb) * g.num_samples;
  const long long s0 = static_cast<long long>(t0) * g.frame_shift;
  const int n = seg_samples(g.frame_length, g.frame_shift), sh = g.frame_shift;
  if (sh % 4 == 0 && (reinterpret_cast<uintptr_t>(wave + s0) & 15) == 0) {
    const int per = sh / 4, runs = (n + sh - 1) / sh;
    for (int q = threadIdx.x; q < runs * per; q += kThreads) {
      const int run = q / per, o = run * sh + 4 * (q - run * per);
      if (o >= n) continue;
      const long long s = s0 + o;
      const long long left = g.num_samples - s;
      const int bytes = left >= 4 ? 16 : (left > 0 ? static_cast<int>(left) * 4 : 0);
      cp_async16(seg + o + kPad * run, wave + (bytes ? s : 0), bytes);
    }
  } else {
    for (int o = threadIdx.x; o < n; o += kThreads) {
      const long long s = s0 + o;
      const bool ok = s < g.num_samples;
      cp_async4(seg + o + kPad * (o / sh), wave + (ok ? s : 0), ok);
    }
  }
}

// The owner's frames of tile j from its power buffer pw (kFramesPerRank x
// 256): each mel column of the chunk over its run of bins, in bin order,
// then the log.
__device__ __forceinline__ void mel_out(const Args& g, const float* pw, const float* wts,
                                        const int* mstart, const int* moff, int j, int rank) {
  const int nb = g.ncols;
  const int bb = j / g.tiles, t0 = (j % g.tiles) * kFrames + rank * kFramesPerRank;
  for (int o = threadIdx.x; o < kFramesPerRank * nb; o += kThreads) {
    const int fl = o / nb, c = o % nb;
    const int t = t0 + fl;
    if (t >= g.num_frames) continue;
    const float* p = pw + fl * (kSplit * kBins) + mstart[c];
    const float* w = wts + moff[c];
    const int len = moff[c + 1] - moff[c];
    float v = 0.f;
    for (int k = 0; k < len; ++k) v = fmaf(p[k], w[k], v);
    if (g.use_log) v = logf(fmaxf(v, g.floor_value));
    g.out[(static_cast<long long>(bb) * g.num_frames + t) * g.num_bins + g.col0 + c] = v;
  }
}

template <bool kDither>
__global__ void __launch_bounds__(kThreads, 1) fbank_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int mstart[kMaxMel], moff[kMaxMel + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L(g.frame_length, g.frame_shift);
  float* ab = smem + L.ab;
  float* red = smem + L.red;
  float* rcv = smem + L.rcv;
  const float* wts = smem + L.wts;
  const int nb = g.ncols, sh = g.frame_shift;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bin0 = rank * kBins;
  const int cid = blockIdx.x / kSplit, nclusters = gridDim.x / kSplit;
  const int rpw = rows_per_warp(g.frame_length), r0 = warp * rpw;
  const int segf = seg_floats(g.frame_length, sh);
  constexpr int kRcv = kFramesPerRank * kSplit * kBins;  // one power buffer

  // once: the packed M (all of it; the chunk's column table), this warp's
  // rows of the A/B slice, the first tile's samples
  for (int i = tid; i <= nb; i += kThreads) {
    if (i < nb) cp_async4(mstart + i, g.mel_start + g.col0 + i, true);
    cp_async4(moff + i, g.mel_off + g.col0 + i, true);
  }
  for (int i = tid; i < g.mel_nnz; i += kThreads) cp_async4(smem + L.wts + i, g.mel_w + i, true);
  for (int i = lane; i < rpw * 16; i += 32) {
    const int r = r0 + i / 16, p = i % 16, col = 4 * (p % 8);
    const bool ok = r < g.frame_length && bin0 + col < g.num_fft_bins;
    const float* src =
        (p < 8 ? g.a : g.b) + (ok ? static_cast<long long>(r) * g.num_fft_bins + bin0 + col : 0);
    cp_async16(ab + r * kRowFloats + (p < 8 ? 0 : kBins) + col, src, ok ? 16 : 0);
  }
  stage_samples(g, smem + L.seg, cid);
  cp_async_commit();
  cluster_arrive();  // this CTA runs: the first tile's sends wait on it

  const int fg = lane >> 3, bg = lane & 7;  // frames fg + 4i (i < 8), bins 4 bg .. + 3
  int it = 0, prev = -1;
  K1Prof prof;
  for (int j = cid; j < g.work; j += nclusters, ++it) {
    const int cur = it & 1;
    const float* seg = smem + L.seg + cur * segf;
    cp_async_wait<0>();
    __syncthreads();  // this tile's samples (and, first, A/B and M) landed everywhere
    if (j + nclusters < g.work) stage_samples(g, smem + L.seg + (cur ^ 1) * segf, j + nclusters);
    cp_async_commit();
    prof.lap(kK1Wait);

    float re[8][4], im[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) re[i][k] = im[i][k] = 0.f;
    if constexpr (kDither) {
      // the warp's rows r0 .. r0 + rpw - 1 in chunks of kDRows; lane
      // (pf, pj) stages samples r0 + kDRows * k + pj + 8h (h < kDRows / 8)
      // of frames pf + 4m (m < 8) into chunk k, from the padded samples and
      // the draws (a frame past the end reads the last frame's draws, a row
      // past the frame its last draw: their products are not kept)
      float* ring = red + warp * 2 * kDChunk;
      const int pf = lane >> 3, pj = lane & 7;
      const int t0 = (j % g.tiles) * kFrames + pf;
      const float* nrow =
          g.noise + static_cast<long long>(j / g.tiles) * g.num_frames * g.frame_length;
      const float* xf = seg + pf * (sh + kPad);
      const int nch = (rpw + kDRows - 1) / kDRows;
      constexpr int kH = kDRows / 8;
      // the lane's frames' draw rows in nrow (an utterance's draws hold
      // under 2^31 floats)
      int noff[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) noff[m] = min(t0 + 4 * m, g.num_frames - 1) * g.frame_length;
      float nv[kH][8];
      auto fetch = [&](int k) {
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          const int rr = kDRows * k + pj + 8 * h;
          if (rr >= rpw) break;
          const int rn = min(r0 + rr, g.frame_length - 1);
#pragma unroll
          for (int m = 0; m < 8; ++m) nv[h][m] = __ldg(nrow + noff[m] + rn);
        }
      };
      // all the chunk's sample loads before its stores, so they overlap
      auto put = [&](int k) {
        float xs[kH][8];
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          const int r = r0 + kDRows * k + pj + 8 * h;
          if (r - r0 >= rpw) break;
          const float* xr = xf + r + kPad * (r / sh);
#pragma unroll
          for (int m = 0; m < 8; ++m) xs[h][m] = xr[m * 4 * (sh + kPad)];
        }
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          if (kDRows * k + pj + 8 * h >= rpw) break;
          float* d = ring + (k & 1) * kDChunk + pf * kDStride + pj + 8 * h;
#pragma unroll
          for (int m = 0; m < 8; ++m) d[m * 4 * kDStride] = xs[h][m] + g.dither * nv[h][m];
        }
      };
      // the next tile's draws (rank r: frames 4r .. 4r + 3) on their way to
      // L2 while this tile runs: its loads below then hit L2
      if (j + nclusters < g.work) {
        const int jn = j + nclusters;
        const float* nn = g.noise + (static_cast<long long>(jn / g.tiles) * g.num_frames +
                                     (jn % g.tiles) * kFrames + rank * kFramesPerRank) *
                                        g.frame_length;
        const long long left = (static_cast<long long>(jn / g.tiles) + 1) * g.num_frames *
                                   g.frame_length -
                               (nn - g.noise);
        const int lines = static_cast<int>(
            (min(left, static_cast<long long>(kFramesPerRank) * g.frame_length) + 31) / 32);
        for (int q = tid; q < lines; q += kThreads)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(nn + 32 * q));
      }
      fetch(0);
      prof.touch(nv);
      prof.lap(kK1Draws);
      put(0);
      __syncwarp();
      prof.lap(kK1Stage);
      // the full chunks, then the last (rpw % kDRows rows)
      const int nfull = rpw / kDRows;
      auto rows = [&](int k, int n) {
        const float* dk = ring + (k & 1) * kDChunk + fg * kDStride;
#pragma unroll
        for (int jj = 0; jj < kDRows; ++jj) {
          if (jj >= n) break;
          const int r = r0 + kDRows * k + jj;
          float xs[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) xs[i] = dk[i * 4 * kDStride + jj];
          const float4 av = *reinterpret_cast<const float4*>(ab + r * kRowFloats + 4 * bg);
          const float4 bv = *reinterpret_cast<const float4*>(ab + r * kRowFloats + kBins + 4 * bg);
          const float as[4] = {av.x, av.y, av.z, av.w};
          const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              re[i][q] = fmaf(xs[i], as[q], re[i][q]);
              im[i][q] = fmaf(xs[i], bs[q], im[i][q]);
            }
        }
      };
      for (int k = 0; k < nfull; ++k) {
        if (k + 1 < nch) fetch(k + 1);
        prof.lap(kK1Stage);
        rows(k, kDRows);
        prof.lap(kK1Fma);
        prof.touch(nv);
        prof.lap(kK1Draws);
        if (k + 1 < nch) put(k + 1);
        __syncwarp();  // chunk k + 1 staged; chunk k read by every lane
        prof.lap(kK1Stage);
      }
      if (nfull < nch) rows(nfull, rpw - kDRows * nfull);
      prof.lap(kK1Fma);
      __syncthreads();  // every warp is done with its ring before red is written
      prof.lap(kK1Join);
    } else {
      const float* x0 = seg + fg * (sh + kPad);
      const int xstep = 4 * (sh + kPad);
      int rp = r0 + kPad * (r0 / sh), rr = r0 % sh;  // padded position of row r
#pragma unroll 2
      for (int r = r0; r < r0 + rpw; ++r) {
        float xs[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) xs[i] = x0[rp + i * xstep];
        const float4 av = *reinterpret_cast<const float4*>(ab + r * kRowFloats + 4 * bg);
        const float4 bv = *reinterpret_cast<const float4*>(ab + r * kRowFloats + kBins + 4 * bg);
        const float as[4] = {av.x, av.y, av.z, av.w};
        const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            re[i][k] = fmaf(xs[i], as[k], re[i][k]);
            im[i][k] = fmaf(xs[i], bs[k], im[i][k]);
          }
        ++rp;
        if (++rr == sh) {
          rr = 0;
          rp += kPad;
        }
      }
      prof.lap(kK1Fma);
    }

    // every CTA has sent the previous tile's power (or, first, started):
    // that tile's mel, while the others finish this tile's analysis
    cluster_wait();
    if (prev >= 0) mel_out(g, rcv + (cur ^ 1) * kRcv, wts, mstart, moff, prev, rank);
    prof.lap(kK1Mel);

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        red[(warp * kVals + i * 4 + k) * 32 + lane] = re[i][k];
        red[(warp * kVals + 32 + i * 4 + k) * 32 + lane] = im[i][k];
      }
    __syncthreads();
    {
      // lane's values for frame row i = warp: frame fg + 4i, bins 4 bg ..
      // + 3, summed over the warps in order and sent to the frame's owner
      const int i = warp, f = fg + 4 * i;
      float p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float sr = 0.f, si = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sr += red[(w * kVals + i * 4 + k) * 32 + lane];
          si += red[(w * kVals + 32 + i * 4 + k) * 32 + lane];
        }
        p[k] = sr * sr + si * si;
        if (!g.use_power) p[k] = sqrtf(p[k]);
      }
      float* dst = cluster.map_shared_rank(rcv, f / kFramesPerRank) + cur * kRcv +
                   (f % kFramesPerRank) * (kSplit * kBins) + bin0 + 4 * bg;
      *reinterpret_cast<float4*>(dst) = make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();  // red is read before the next tile writes it
    cluster_arrive();
    prev = j;
    prof.lap(kK1Merge);
  }
  // the last tile: after this wait no CTA touches another's memory
  cluster_wait();
  if (prev >= 0) mel_out(g, rcv + ((it - 1) & 1) * kRcv, wts, mstart, moff, prev, rank);
  prof.lap(kK1Mel);
  prof.flush(kDither ? 1 : 0);
}

// Clusters of kSplit CTAs the current card holds at once, cached per
// (variant, device, shared memory); the kernel's shared-memory limit is set
// first.
template <bool kDither>
cudaError_t cluster_capacity(size_t smem, int* clusters) {
  struct Entry {
    int device, clusters;
    size_t smem;
  };
  static Entry cache[16];
  static int used = 0;
  static std::mutex lock;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fbank_kernel<kDither>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (cache[i].device == device && cache[i].smem == smem) {
      *clusters = cache[i].clusters;
      return cudaSuccess;
    }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, fbank_kernel<kDither>, &cfg);
  if (err != cudaSuccess) return err;
  if (used < 16) cache[used++] = {device, *clusters, smem};
  return cudaSuccess;
}

size_t smem_bytes(int frame_length, int frame_shift) {
  return sizeof(float) * static_cast<size_t>(Layout(frame_length, frame_shift).total);
}

// One launch a chunk of kMaxMel mel columns, on as many clusters as the card
// holds at once (at most one a work item).
template <bool kDither>
int launch(Args args, size_t smem, int num_bins, void* stream) {
  int clusters = 0;
  cudaError_t err = cluster_capacity<kDither>(smem, &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(kSplit * std::min(clusters, args.work)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int c0 = 0; c0 < num_bins; c0 += kMaxMel) {
    args.col0 = c0;
    args.ncols = std::min(kMaxMel, num_bins - c0);
    err = cudaLaunchKernelEx(&cfg, fbank_kernel<kDither>, args);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// general path
// ---------------------------------------------------------------------------

constexpr int kGenFrames = 64;    // frames a tile
constexpr int kGenBins = 64;      // FFT bins a tile, re and im
constexpr int kGenK = 32;         // samples a staged chunk
constexpr int kGenStages = 3;     // chunks in the ring
constexpr int kGenThreads = 256;  // 2 sample halves x 4 warps of 32 x 32
constexpr int kGenXs = kGenK + 4;      // floats a staged frame row
constexpr int kGenPw = kGenBins + 4;   // floats a power row
constexpr int kGenHalf = kGenThreads / 2;

// Floats of one ring stage: A and B chunks (kGenK x kGenBins), the frames'
// samples (kGenFrames x kGenXs) and, dithered, their draws.
__host__ __device__ constexpr int gen_stage_floats(bool dither) {
  return 2 * kGenK * kGenBins + (dither ? 2 : 1) * kGenFrames * kGenXs;
}
size_t gen_smem_bytes(bool dither) {
  return sizeof(float) * kGenStages * static_cast<size_t>(gen_stage_floats(dither));
}
// the epilogue reuses the ring: the second half's sums, then the power
static_assert(kGenHalf * 64 + kGenFrames * kGenPw <= kGenStages * gen_stage_floats(false),
              "the epilogue's buffers fit the ring");

struct GenArgs {
  const float* waves;
  const float* a;
  const float* b;
  const int* mel_start;  // M by columns, as Args
  const int* mel_off;
  const float* mel_w;
  const int* tile_cols;  // (bin tiles, 2): the columns whose runs meet each bin tile
  float* out;
  float* part;           // (bin tiles, batch, num_frames, num_bins) the tiles' mel sums
  int* tickets;          // (batch, frame tiles) zero, left zero
  int batch, num_samples, num_frames, frame_length, frame_shift, num_fft_bins, num_bins;
  int frame_tiles, bin_tiles, use_power, use_log;
  float floor_value;
  const float* noise;  // (batch, num_frames, frame_length), or null: no dither
  float dither;
};

// Chunk c of the K-loop into its ring stage: rows r0 .. r0 + kGenK - 1 of A
// and B at the tile's bins, and those samples of the tile's frames (and
// their draws); zeros past the frame, past the bins and past the last frame.
// 16-byte copies where the rows allow, else 4-byte ones.
template <bool kDither>
__device__ __forceinline__ void gen_stage(const GenArgs& g, float* st, int c, int k0, int t0,
                                          const float* wave, const float* noise, bool ab16,
                                          bool x16, bool n16) {
  const int r0 = c * kGenK, L = g.frame_length, nfft = g.num_fft_bins;
  float* as = st;
  float* bs = as + kGenK * kGenBins;
  float* xs = bs + kGenK * kGenBins;
  if (ab16) {
    for (int q = threadIdx.x; q < 2 * kGenK * (kGenBins / 4); q += kGenThreads) {
      const int m = q / (kGenK * (kGenBins / 4)), rem = q % (kGenK * (kGenBins / 4));
      const int r = rem / (kGenBins / 4), col = 4 * (rem % (kGenBins / 4));
      const int k = k0 + col;
      const int n = r0 + r < L ? max(0, min(4, nfft - k)) : 0;
      const float* src = (m ? g.b : g.a) + (n ? static_cast<long long>(r0 + r) * nfft + k : 0);
      cp_async16((m ? bs : as) + r * kGenBins + col, src, 4 * n);
    }
  } else {
    for (int q = threadIdx.x; q < 2 * kGenK * kGenBins; q += kGenThreads) {
      const int m = q / (kGenK * kGenBins), rem = q % (kGenK * kGenBins);
      const int r = rem / kGenBins, col = rem % kGenBins, k = k0 + col;
      const bool ok = r0 + r < L && k < nfft;
      cp_async4((m ? bs : as) + r * kGenBins + col,
                (m ? g.b : g.a) + (ok ? static_cast<long long>(r0 + r) * nfft + k : 0), ok);
    }
  }
  // the frames' samples [and draws]: frame t's sample r0 + r at
  // wave[t * shift + r0 + r] [noise[t * L + r0 + r]]
  for (int s = 0; s < (kDither ? 2 : 1); ++s) {
    const float* base = s ? noise : wave;
    const long long stride = s ? L : g.frame_shift;
    float* dst = xs + s * kGenFrames * kGenXs;
    if (s ? n16 : x16) {
      for (int q = threadIdx.x; q < kGenFrames * (kGenK / 4); q += kGenThreads) {
        const int f = q / (kGenK / 4), col = 4 * (q % (kGenK / 4)), t = t0 + f;
        const int n = t < g.num_frames ? max(0, min(4, L - r0 - col)) : 0;
        cp_async16(dst + f * kGenXs + col, base + (n ? t * stride + r0 + col : 0), 4 * n);
      }
    } else {
      for (int q = threadIdx.x; q < kGenFrames * kGenK; q += kGenThreads) {
        const int f = q / kGenK, r = q % kGenK, t = t0 + f;
        const bool ok = t < g.num_frames && r0 + r < L;
        cp_async4(dst + f * kGenXs + r, base + (ok ? t * stride + r0 + r : 0), ok);
      }
    }
  }
}

template <bool kDither>
__global__ void __launch_bounds__(kGenThreads) fbank_general_kernel(GenArgs g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int last;
  constexpr int SF = gen_stage_floats(kDither);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = warp >> 2;                          // samples 16 half .. + 15 of each chunk
  // frames f0 + 4i (i < 8): the warp's 4 frame groups read adjacent staged
  // rows, in distinct banks, so a quarter warp's load is one wavefront
  const int f0 = ((warp >> 1) & 1) * 32 + (lane >> 3);
  const int b0 = (warp & 1) * 32 + (lane & 7) * 4;          // bins b0 .. b0 + 3
  const int bt = blockIdx.x % g.bin_tiles, ft = blockIdx.x / g.bin_tiles, bb = blockIdx.y;
  const int k0 = bt * kGenBins, t0 = ft * kGenFrames;
  const float* wave = g.waves + static_cast<long long>(bb) * g.num_samples;
  const float* noise =
      kDither ? g.noise + static_cast<long long>(bb) * g.num_frames * g.frame_length : nullptr;
  const bool ab16 = g.num_fft_bins % 4 == 0;
  const bool x16 = g.frame_shift % 4 == 0 && (reinterpret_cast<uintptr_t>(wave) & 15) == 0;
  const bool n16 = kDither && g.frame_length % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(noise) & 15) == 0;
  const int nchunks = (g.frame_length + kGenK - 1) / kGenK;

#pragma unroll
  for (int c = 0; c < kGenStages - 1; ++c) {
    if (c < nchunks)
      gen_stage<kDither>(g, smem + c * SF, c, k0, t0, wave, noise, ab16, x16, n16);
    cp_async_commit();
  }
  float re[8][4], im[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) re[i][k] = im[i][k] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kGenStages - 2>();
    __syncthreads();  // chunk c landed everywhere; chunk c - 1's stage is free
    float* st = smem + (c % kGenStages) * SF;
    float* xs = st + 2 * kGenK * kGenBins;
    if constexpr (kDither) {
      const float* ns = xs + kGenFrames * kGenXs;
      for (int q = tid; q < kGenFrames * kGenK; q += kGenThreads) {
        const int e = (q / kGenK) * kGenXs + q % kGenK;
        xs[e] = __fadd_rn(xs[e], __fmul_rn(g.dither, ns[e]));
      }
      __syncthreads();
    }
    if (c + kGenStages - 1 < nchunks)
      gen_stage<kDither>(g, smem + ((c + kGenStages - 1) % kGenStages) * SF, c + kGenStages - 1,
                         k0, t0, wave, noise, ab16, x16, n16);
    cp_async_commit();
    const float* as = st;
    const float* bs = st + kGenK * kGenBins;
#pragma unroll
    for (int h = 0; h < kGenK / 8; ++h) {
      const int r = half * (kGenK / 2) + 4 * h;  // 4 samples r .. r + 3
      float x[8][4], av[4][4], bv[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(xs + (f0 + 4 * i) * kGenXs + r);
        x[i][0] = v.x; x[i][1] = v.y; x[i][2] = v.z; x[i][3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 va = *reinterpret_cast<const float4*>(as + (r + u) * kGenBins + b0);
        const float4 vb = *reinterpret_cast<const float4*>(bs + (r + u) * kGenBins + b0);
        av[u][0] = va.x; av[u][1] = va.y; av[u][2] = va.z; av[u][3] = va.w;
        bv[u][0] = vb.x; bv[u][1] = vb.y; bv[u][2] = vb.z; bv[u][3] = vb.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            re[i][k] = fmaf(x[i][u], av[u][k], re[i][k]);
            im[i][k] = fmaf(x[i][u], bv[u][k], im[i][k]);
          }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue's buffers reuse it

  // the halves' sums in order (first half + second half), then the power
  float* red = smem;                  // 64 values x kGenHalf threads
  float* pw = smem + 64 * kGenHalf;   // kGenFrames x kGenPw
  const int th = tid % kGenHalf;
  if (half == 1)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        red[(i * 4 + k) * kGenHalf + th] = re[i][k];
        red[(32 + i * 4 + k) * kGenHalf + th] = im[i][k];
      }
  __syncthreads();
  if (half == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float sr = re[i][k] + red[(i * 4 + k) * kGenHalf + th];
        const float si = im[i][k] + red[(32 + i * 4 + k) * kGenHalf + th];
        p[k] = sr * sr + si * si;
        if (!g.use_power) p[k] = sqrtf(p[k]);
      }
      *reinterpret_cast<float4*>(pw + (f0 + 4 * i) * kGenPw + b0) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
  __syncthreads();

  // this bin tile's share of each mel column that meets it, in bin order
  const int c_lo = g.tile_cols[2 * bt], ncols = g.tile_cols[2 * bt + 1] - c_lo;
  const int kend = min(k0 + kGenBins, g.num_fft_bins);
  const long long plane = static_cast<long long>(g.num_frames) * g.num_bins;
  float* part = g.part + (static_cast<long long>(bt) * g.batch + bb) * plane;
  for (int q = tid; q < kGenFrames * ncols; q += kGenThreads) {
    const int f = q / ncols, c = c_lo + q % ncols, t = t0 + f;
    if (t >= g.num_frames) continue;
    const int s0 = g.mel_start[c], off = g.mel_off[c], len = g.mel_off[c + 1] - off;
    const int lo = max(s0, k0), hi = min(s0 + len, kend);
    if (lo >= hi) continue;  // a column of the range whose run misses the tile
    float v = 0.f;
    for (int k = lo; k < hi; ++k) v = fmaf(pw[f * kGenPw + k - k0], g.mel_w[off + k - s0], v);
    part[static_cast<long long>(t) * g.num_bins + c] = v;
  }

  // the last bin tile of this frame tile: each column's tiles in order, the log
  __threadfence();
  __syncthreads();
  int* ticket = g.tickets + static_cast<long long>(bb) * g.frame_tiles + ft;
  if (tid == 0) last = atomicAdd(ticket, 1) == g.bin_tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = g.part + static_cast<long long>(bb) * plane;
  const long long tstride = static_cast<long long>(g.batch) * plane;
  for (int q = tid; q < kGenFrames * g.num_bins; q += kGenThreads) {
    const int f = q / g.num_bins, c = q % g.num_bins, t = t0 + f;
    if (t >= g.num_frames) continue;
    const int s0 = g.mel_start[c], len = g.mel_off[c + 1] - g.mel_off[c];
    float v = 0.f;
    if (len > 0)
      for (int tt = s0 / kGenBins; tt <= (s0 + len - 1) / kGenBins; ++tt)
        v += __ldcg(parts + tt * tstride + static_cast<long long>(t) * g.num_bins + c);
    if (g.use_log) v = logf(fmaxf(v, g.floor_value));
    g.out[(static_cast<long long>(bb) * g.num_frames + t) * g.num_bins + c] = v;
  }
  if (tid == 0) atomicExch(ticket, 0);
}

template <bool kDither>
int launch_general(const GenArgs& args, void* stream) {
  const size_t smem = gen_smem_bytes(kDither);
  cudaError_t err = cudaFuncSetAttribute(fbank_general_kernel<kDither>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(args.frame_tiles * args.bin_tiles),
                  static_cast<unsigned>(args.batch));
  fbank_general_kernel<kDither>
      <<<grid, kGenThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan of a call: the clusters the card holds at once and the
// dynamic shared memory a CTA takes (reported by the callers' timing tools).
#ifdef VSV_K1_PROF
// The phase profile's sums (2 x kK1Slots), then zero them if `reset`.
extern "C" int fbank_prof(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_k1_prof, sizeof(g_k1_prof));
  if (e == cudaSuccess && reset) {
    static unsigned long long zeros[2 * kK1Slots];
    e = cudaMemcpyToSymbol(g_k1_prof, zeros, sizeof(zeros));
  }
  return static_cast<int>(e);
}
#endif

extern "C" int fbank_plan(int frame_length, int frame_shift, int* clusters, int* smem_bytes_out) {
  const size_t smem = smem_bytes(frame_length, frame_shift);
  *smem_bytes_out = static_cast<int>(smem);
  return static_cast<int>(cluster_capacity<false>(smem, clusters));
}

// waves (batch, num_samples) fp32; a, b (frame_length, num_fft_bins); M by
// columns (mel_start, mel_off, mel_w as in Args); out (batch, num_frames,
// num_bins); noise null (no dither) or (batch, num_frames, frame_length)
// fp32 draws, added to the framed samples times `dither` (the dithered
// variant). Takes num_fft_bins <= 256 and a multiple of 4, at most
// kMelCap weights of M, and a frame whose A/B slice and samples fit one
// CTA's shared memory (400 samples, a 160-sample shift: 219 KB). More than
// kMaxMel mel columns run as one launch per chunk of kMaxMel columns (each
// recomputes the power spectrum).
extern "C" int fbank_f32(const float* waves, const float* a, const float* b,
                         const int* mel_start, const int* mel_off, const float* mel_w,
                         float* out, int batch, int num_samples, int num_frames,
                         int frame_length, int frame_shift, int num_fft_bins, int num_bins,
                         int mel_nnz, int use_power, int use_log, float floor_value,
                         const float* noise, float dither, void* stream) {
  if (num_fft_bins > kSplit * kBins || num_fft_bins % 4 != 0 || num_bins < 1 ||
      frame_length < 1 || frame_length > 4096 || frame_shift < 1 ||
      frame_shift > 4096 || batch < 1 || mel_nnz < 0 || mel_nnz > kMelCap)
    return vsv::kShapeUnsupported;
  const size_t smem = smem_bytes(frame_length, frame_shift);
  const long long work = static_cast<long long>(batch) * ((num_frames + kFrames - 1) / kFrames);
  if (smem > static_cast<size_t>(kSmemMax) - 2048 || work > (1LL << 30))
    return vsv::kShapeUnsupported;
  Args args{waves, a, b, mel_start, mel_off, mel_w, out, num_samples, num_frames,
            frame_length, frame_shift, num_fft_bins, num_bins, mel_nnz, 0, 0, use_power,
            use_log, (num_frames + kFrames - 1) / kFrames, static_cast<int>(work),
            floor_value, noise, dither};
  return noise != nullptr ? launch<true>(args, smem, num_bins, stream)
                          : launch<false>(args, smem, num_bins, stream);
}

// The general path: the arguments of fbank_f32 (M by columns), and the
// plan of ops/fbank.py:general_plan: tile_cols (bin tiles, 2) int32, the
// columns whose runs meet each 64-bin tile; part, (bin tiles, batch,
// num_frames, num_bins) fp32 scratch; tickets, batch x frame tiles ints,
// zero, left zero; smem, the dynamic shared memory the plan expects (a
// plan that differs from this source's layout is refused). Any frame
// length, shift, FFT bin count and mel bank.
extern "C" int fbank_general_f32(const float* waves, const float* a, const float* b,
                                 const int* mel_start, const int* mel_off, const float* mel_w,
                                 const int* tile_cols, float* out, float* part,
                                 long long part_floats, int* tickets, int num_tickets,
                                 int batch, int num_samples, int num_frames, int frame_length,
                                 int frame_shift, int num_fft_bins, int num_bins, int use_power,
                                 int use_log, float floor_value, const float* noise, float dither,
                                 int smem, void* stream) {
  if (num_fft_bins < 1 || frame_length < 1 || frame_shift < 1 || num_bins < 1 || batch < 1 ||
      batch > 65535 || num_frames < 1)
    return vsv::kShapeUnsupported;
  const long long frame_tiles = (num_frames + kGenFrames - 1) / kGenFrames;
  const long long bin_tiles = (num_fft_bins + kGenBins - 1) / kGenBins;
  if (frame_tiles * bin_tiles > (1LL << 31) - 1) return vsv::kShapeUnsupported;
  // the scratch the caller sized from the plan: a bin tile's mel sums of
  // every frame, and a ticket a (utterance, frame tile)
  if (static_cast<size_t>(smem) != gen_smem_bytes(noise != nullptr) ||
      part_floats < bin_tiles * batch * num_frames * num_bins ||
      num_tickets < batch * frame_tiles)
    return vsv::kPlanMismatch;
  const GenArgs args{waves, a, b, mel_start, mel_off, mel_w, tile_cols, out, part, tickets,
                     batch, num_samples, num_frames, frame_length, frame_shift, num_fft_bins,
                     num_bins, static_cast<int>(frame_tiles), static_cast<int>(bin_tiles),
                     use_power, use_log, floor_value, noise, dither};
  return noise != nullptr ? launch_general<true>(args, stream)
                          : launch_general<false>(args, stream);
}
