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
// dither * noise[b, t, r] to each sample in the FMA loop, read through the
// read-only path: per sample a lane adds 8 loads (its 8 frames) to 64 FMA,
// and the 8 lanes that share a frame read one address; a lane's 32-byte
// sector of a frame serves its next 7 samples from L1. A 32-frame noise
// tile (51 KB) does not fit beside the 219 KB layout, so all 8 CTAs of the
// cluster read it through L1/L2; from HBM once (205 MB at the training
// shape, 256 x 500 frames: 0.06 ms against 0.78 ms of fp32 FMA). The
// dither-off variant is the same code without those lines.
// General path (fbank_general_f32), for the shapes the design above does
// not take: more than 256 FFT bins (a padded frame over 512 samples, as at
// 32 kHz or with a 50 ms frame) or a count not a multiple of 4, more than
// kMelCap packed mel weights, a frame length or shift over 4096, or a
// layout over a CTA's shared memory. A simple kernel that is right: a CTA
// of 256 threads takes kGenFrames frames of one utterance (one frame where
// the mel accumulators of eight do not fit) and walks the FFT bins in tiles
// of 256, a thread a bin. For each tile it stages the frames' samples in
// chunks of kGenRows rows (with dither * noise added, the draw rule of the
// design above), streams the A/B rows of its bin from global memory (L2:
// 256 threads read 1 KB of each row together), forms the power of the tile
// in shared memory, and adds the tile's share of every mel column (the
// dense M, streamed from L2) into per-(frame, column) accumulators in
// shared memory; after the last tile, the log. Every sum runs in a fixed
// order: reruns agree bit for bit. Bound as above (operations); it reads
// A/B again for every 8 frames, which the design above avoids.
// All launch decisions (cluster, tile, warps, grid, variant) are made here;
// the wrapper passes shapes, the packed M and the noise.
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

static_assert(kFrames % kSplit == 0, "each rank owns whole frames");
static_assert(kFrames == 32 && kBins == 32 && kWarps == 8,
              "lane tiles: 4 x 8 frames by 8 x 4 bins; the merge: warp w, frame row w");

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
  for (int j = cid; j < g.work; j += nclusters, ++it) {
    const int cur = it & 1;
    const float* seg = smem + L.seg + cur * segf;
    cp_async_wait<0>();
    __syncthreads();  // this tile's samples (and, first, A/B and M) landed everywhere
    if (j + nclusters < g.work) stage_samples(g, smem + L.seg + (cur ^ 1) * segf, j + nclusters);
    cp_async_commit();

    float re[8][4], im[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) re[i][k] = im[i][k] = 0.f;
    const float* x0 = seg + fg * (sh + kPad);
    const int xstep = 4 * (sh + kPad);
    int rp = r0 + kPad * (r0 / sh), rr = r0 % sh;  // padded position of row r
    // dither: the noise rows of this lane's frames (a frame past the end
    // reads the last frame's: its output is not written)
    const float* nz[8];
    if constexpr (kDither) {
      const long long row0 = static_cast<long long>(j / g.tiles) * g.num_frames;
      const int t0 = (j % g.tiles) * kFrames + fg;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        nz[i] = g.noise + (row0 + min(t0 + 4 * i, g.num_frames - 1)) * g.frame_length;
    }
#pragma unroll 2
    for (int r = r0; r < r0 + rpw; ++r) {
      float xs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) xs[i] = x0[rp + i * xstep];
      if constexpr (kDither) {
        // rows past the frame (A/B zero there) read the frame's last draw
        const int rn = min(r, g.frame_length - 1);
#pragma unroll
        for (int i = 0; i < 8; ++i) xs[i] += g.dither * __ldg(nz[i] + rn);
      }
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

    // every CTA has sent the previous tile's power (or, first, started):
    // that tile's mel, while the others finish this tile's analysis
    cluster_wait();
    if (prev >= 0) mel_out(g, rcv + (cur ^ 1) * kRcv, wts, mstart, moff, prev, rank);

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
  }
  // the last tile: after this wait no CTA touches another's memory
  cluster_wait();
  if (prev >= 0) mel_out(g, rcv + ((it - 1) & 1) * kRcv, wts, mstart, moff, prev, rank);
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

constexpr int kGenThreads = 256;  // a thread a FFT bin of the tile
constexpr int kGenRows = 256;     // samples a frame per staged chunk
constexpr int kGenFrames = 8;     // frames a CTA (1 where 8 frames' mel sums do not fit)

struct GenArgs {
  const float* waves;
  const float* a;
  const float* b;
  const float* m;  // (num_fft_bins, num_bins) dense
  float* out;
  int num_samples, num_frames, frame_length, frame_shift, num_fft_bins, num_bins;
  int use_power, use_log;
  float floor_value;
  const float* noise;  // (batch, num_frames, frame_length), or null: no dither
  float dither;
};

size_t gen_smem_bytes(int frames, int num_bins) {
  return sizeof(float) * static_cast<size_t>(frames) * (kGenRows + kGenThreads + num_bins);
}

template <int F, bool kDither>
__global__ void __launch_bounds__(kGenThreads) fbank_general_kernel(GenArgs g) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // F x kGenRows samples of the chunk
  float* pw = xs + F * kGenRows;      // F x kGenThreads power of the tile
  float* mel = pw + F * kGenThreads;  // F x num_bins accumulators
  const int tid = threadIdx.x, nb = g.num_bins;
  const int bb = blockIdx.y, t0 = blockIdx.x * F;
  const float* wave = g.waves + static_cast<long long>(bb) * g.num_samples;
  for (int i = tid; i < F * nb; i += kGenThreads) mel[i] = 0.f;
  for (int k0 = 0; k0 < g.num_fft_bins; k0 += kGenThreads) {
    const int k = k0 + tid;
    float re[F], im[F];
#pragma unroll
    for (int f = 0; f < F; ++f) re[f] = im[f] = 0.f;
    for (int r0 = 0; r0 < g.frame_length; r0 += kGenRows) {
      const int rn = min(kGenRows, g.frame_length - r0);
      __syncthreads();  // the previous chunk (and tile) is consumed
      for (int i = tid; i < F * kGenRows; i += kGenThreads) {
        const int f = i / kGenRows, r = i % kGenRows, t = t0 + f;
        float v = 0.f;
        if (t < g.num_frames && r < rn) {
          const long long s = static_cast<long long>(t) * g.frame_shift + r0 + r;
          v = s < g.num_samples ? wave[s] : 0.f;
          if constexpr (kDither)
            v += g.dither *
                 g.noise[(static_cast<long long>(bb) * g.num_frames + t) * g.frame_length + r0 + r];
        }
        xs[i] = v;
      }
      __syncthreads();
      if (k < g.num_fft_bins) {
        for (int r = 0; r < rn; ++r) {
          const long long row = static_cast<long long>(r0 + r) * g.num_fft_bins + k;
          const float av = __ldg(g.a + row), bv = __ldg(g.b + row);
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float x = xs[f * kGenRows + r];
            re[f] = fmaf(x, av, re[f]);
            im[f] = fmaf(x, bv, im[f]);
          }
        }
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float p = re[f] * re[f] + im[f] * im[f];
      if (!g.use_power) p = sqrtf(p);
      pw[f * kGenThreads + tid] = p;
    }
    __syncthreads();
    const int kn = min(kGenThreads, g.num_fft_bins - k0);
    for (int i = tid; i < F * nb; i += kGenThreads) {
      const int f = i / nb, c = i % nb;
      const float* mc = g.m + static_cast<long long>(k0) * nb + c;
      const float* pf = pw + f * kGenThreads;
      float acc = mel[i];
      for (int kk = 0; kk < kn; ++kk) acc = fmaf(pf[kk], __ldg(mc + static_cast<long long>(kk) * nb), acc);
      mel[i] = acc;
    }
  }
  // each accumulator is read by the thread that wrote it: no barrier needed
  for (int i = tid; i < F * nb; i += kGenThreads) {
    const int f = i / nb, c = i % nb, t = t0 + f;
    if (t >= g.num_frames) continue;
    float v = mel[i];
    if (g.use_log) v = logf(fmaxf(v, g.floor_value));
    g.out[(static_cast<long long>(bb) * g.num_frames + t) * nb + c] = v;
  }
}

template <int F, bool kDither>
int launch_general(const GenArgs& args, int batch, void* stream) {
  const size_t smem = gen_smem_bytes(F, args.num_bins);
  cudaError_t err = cudaFuncSetAttribute(fbank_general_kernel<F, kDither>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((args.num_frames + F - 1) / F),
                  static_cast<unsigned>(batch));
  fbank_general_kernel<F, kDither>
      <<<grid, kGenThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan of a call: the clusters the card holds at once and the
// dynamic shared memory a CTA takes (reported by the callers' timing tools).
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

// The general path's frames a CTA for num_bins mel columns (8, or 1 where
// eight frames' accumulators do not fit), 0 if not even one frame's do.
extern "C" int fbank_general_plan(int num_bins, int* frames_out, int* smem_bytes_out) {
  const size_t limit = static_cast<size_t>(kSmemMax) - 2048;
  int frames = 0;
  if (num_bins >= 1) {
    if (gen_smem_bytes(kGenFrames, num_bins) <= limit) frames = kGenFrames;
    else if (gen_smem_bytes(1, num_bins) <= limit) frames = 1;
  }
  *frames_out = frames;
  *smem_bytes_out = frames ? static_cast<int>(gen_smem_bytes(frames, num_bins)) : 0;
  return frames ? 0 : vsv::kShapeUnsupported;
}

// The general path: the arguments of fbank_f32, with M dense (num_fft_bins,
// num_bins) in place of its columns. Any frame length, shift and FFT bin
// count; mel columns as long as one frame's accumulators fit a CTA
// (fbank_general_plan).
extern "C" int fbank_general_f32(const float* waves, const float* a, const float* b,
                                 const float* m, float* out, int batch, int num_samples,
                                 int num_frames, int frame_length, int frame_shift,
                                 int num_fft_bins, int num_bins, int use_power, int use_log,
                                 float floor_value, const float* noise, float dither,
                                 void* stream) {
  int frames = 0, smem = 0;
  if (num_fft_bins < 1 || frame_length < 1 || frame_shift < 1 || batch < 1 ||
      batch > 65535 || fbank_general_plan(num_bins, &frames, &smem) != 0)
    return vsv::kShapeUnsupported;
  const GenArgs args{waves, a, b, m, out, num_samples, num_frames, frame_length, frame_shift,
                     num_fft_bins, num_bins, use_power, use_log, floor_value, noise, dither};
  if (frames == kGenFrames)
    return noise != nullptr ? launch_general<kGenFrames, true>(args, batch, stream)
                            : launch_general<kGenFrames, false>(args, batch, stream);
  return noise != nullptr ? launch_general<1, true>(args, batch, stream)
                          : launch_general<1, false>(args, batch, stream);
}
