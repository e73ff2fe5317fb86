// K1: Kaldi log-mel FBANK, waveform -> (T, num_bins), dither off.
//
// Replaces: voxsrc2020_speaker_verification_tpu/ops/fbank.py:fbank (the
// retired Pallas kernel ops/pallas/fbank.py:fbank_fused computed exactly it).
//
// Every per-frame step before the power spectrum is linear in the frame, so
// it folds into two fp32 matrices A, B (frame_length x num_fft_bins):
//   power = (x A)^2 + (x B)^2,   fbank = log(max(power M, FLT_EPSILON)).
//
// Framing: frames[t, shift*q + r] = wave2d[t + q, r] with wave2d the wave cut
// into rows of `shift` samples. A block stages the contiguous run of samples
// its TT frames cover in shared memory, and reads frame f, sample n at
// seg[f * shift + n]: no (T, frame_length) buffer exists in device memory.
//
// Bound on the card: operations. Per frame 4 * frame_length * num_fft_bins
// flops of analysis (409,600 at 400 x 256) against 1.6 KB of new samples
// and 320 B of output, so the fp32 peak bounds it, not HBM. The dot products
// run as fp32 FMA on CUDA cores on purpose: power = re^2 + im^2 cancels,
// and TF32 or bf16 inputs (10 or 8 mantissa bits) cost visible log-mel error.
// A and B (400 KB each) do not fit a block's shared memory: the kernel tiles
// the FFT-bin axis (NB bins at a time, A/B staged NCH rows at a time) and adds
// each bin tile's power @ M partial into the mel outputs kept in registers;
// the mel product is linear in power, so the partials sum exactly up to order.
// The log is taken once at the end.
#include "common.cuh"

namespace {

constexpr int TT = 32;        // frames per block
constexpr int NB = 32;        // FFT bins per tile
constexpr int NCH = 32;       // rows of A/B staged at a time
constexpr int THREADS = 256;
constexpr int MAX_OUT = 16;   // mel outputs per thread: TT * num_bins <= THREADS * MAX_OUT

__global__ void __launch_bounds__(THREADS) fbank_kernel(
    const float* __restrict__ waves, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ mel,
    float* __restrict__ out, int num_samples, int num_frames,
    int frame_length, int frame_shift, int num_fft_bins, int num_bins,
    int use_power, int use_log, float floor_value) {
  extern __shared__ __align__(16) float smem[];
  const int seg_len = (TT - 1) * frame_shift + frame_length;
  float* seg = smem;              // seg_len samples
  float* as = seg + seg_len;      // NCH x NB
  float* bs = as + NCH * NB;      // NCH x NB
  float* ps = bs + NCH * NB;      // TT x NB power tile
  float* ms = ps + TT * NB;       // NB x num_bins mel tile

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const float* wave = waves + static_cast<long long>(blockIdx.y) * num_samples;
  const long long s0 = static_cast<long long>(t0) * frame_shift;
  for (int i = tid; i < seg_len; i += THREADS) {
    const long long s = s0 + i;
    seg[i] = s < num_samples ? wave[s] : 0.f;
  }

  // analysis micro-tile of this thread: frames fr, fr + 16; bins bn, bn + 16
  const int fr = tid / 16, bn = tid % 16;
  const int n_out = TT * num_bins;
  float acc[MAX_OUT];
#pragma unroll
  for (int r = 0; r < MAX_OUT; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < num_fft_bins; k0 += NB) {
    float re00 = 0.f, re01 = 0.f, re10 = 0.f, re11 = 0.f;
    float im00 = 0.f, im01 = 0.f, im10 = 0.f, im11 = 0.f;
    for (int n0 = 0; n0 < frame_length; n0 += NCH) {
      __syncthreads();  // earlier readers of as/bs (and seg on entry) are done
      for (int i = tid; i < NCH * NB; i += THREADS) {
        const int n = n0 + i / NB, k = k0 + i % NB;
        const bool ok = n < frame_length && k < num_fft_bins;
        const long long src = static_cast<long long>(n) * num_fft_bins + k;
        as[i] = ok ? a[src] : 0.f;
        bs[i] = ok ? b[src] : 0.f;
      }
      __syncthreads();
      const int nmax = min(NCH, frame_length - n0);
      const float* w0 = seg + fr * frame_shift + n0;
      const float* w1 = seg + (fr + 16) * frame_shift + n0;
      for (int n = 0; n < nmax; ++n) {
        const float x0 = w0[n], x1 = w1[n];
        const float a0 = as[n * NB + bn], a1 = as[n * NB + bn + 16];
        const float b0 = bs[n * NB + bn], b1 = bs[n * NB + bn + 16];
        re00 = fmaf(x0, a0, re00); re01 = fmaf(x0, a1, re01);
        re10 = fmaf(x1, a0, re10); re11 = fmaf(x1, a1, re11);
        im00 = fmaf(x0, b0, im00); im01 = fmaf(x0, b1, im01);
        im10 = fmaf(x1, b0, im10); im11 = fmaf(x1, b1, im11);
      }
    }
    float p00 = re00 * re00 + im00 * im00, p01 = re01 * re01 + im01 * im01;
    float p10 = re10 * re10 + im10 * im10, p11 = re11 * re11 + im11 * im11;
    if (!use_power) {
      p00 = sqrtf(p00); p01 = sqrtf(p01); p10 = sqrtf(p10); p11 = sqrtf(p11);
    }
    ps[fr * NB + bn] = p00;
    ps[fr * NB + bn + 16] = p01;
    ps[(fr + 16) * NB + bn] = p10;
    ps[(fr + 16) * NB + bn + 16] = p11;
    for (int i = tid; i < NB * num_bins; i += THREADS) {
      const int k = k0 + i / num_bins;
      ms[i] = k < num_fft_bins
                  ? mel[static_cast<long long>(k) * num_bins + i % num_bins]
                  : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAX_OUT; ++r) {
      const int o = tid + r * THREADS;
      if (o < n_out) {
        const int f = o / num_bins, j = o % num_bins;
        float s = acc[r];
        for (int k = 0; k < NB; ++k) s = fmaf(ps[f * NB + k], ms[k * num_bins + j], s);
        acc[r] = s;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < MAX_OUT; ++r) {
    const int o = tid + r * THREADS;
    if (o < n_out) {
      const int f = o / num_bins, j = o % num_bins;
      const int t = t0 + f;
      if (t < num_frames) {
        float v = acc[r];
        if (use_log) v = logf(fmaxf(v, floor_value));
        out[(static_cast<long long>(blockIdx.y) * num_frames + t) * num_bins + j] = v;
      }
    }
  }
}

}  // namespace

extern "C" int fbank_f32(const float* waves, const float* a, const float* b,
                         const float* mel, float* out, int batch,
                         int num_samples, int num_frames, int frame_length,
                         int frame_shift, int num_fft_bins, int num_bins,
                         int use_power, int use_log, float floor_value,
                         void* stream) {
  if (num_bins > THREADS * MAX_OUT / TT) return static_cast<int>(cudaErrorInvalidValue);
  const int seg_len = (TT - 1) * frame_shift + frame_length;
  const size_t smem = sizeof(float) *
      (seg_len + 2 * NCH * NB + TT * NB + NB * num_bins);
  cudaFuncSetAttribute(fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((num_frames + TT - 1) / TT, batch);
  fbank_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      waves, a, b, mel, out, num_samples, num_frames, frame_length,
      frame_shift, num_fft_bins, num_bins, use_power, use_log, floor_value);
  return static_cast<int>(cudaGetLastError());
}
