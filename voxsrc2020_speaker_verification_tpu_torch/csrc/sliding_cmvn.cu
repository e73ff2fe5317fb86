// K7: sliding-window cepstral mean (and variance) normalization over time.
//
// Replaces: voxsrc2020_speaker_verification_tpu/ops/cmvn.py:sliding_cmvn
// (lines 29-87), which XLA computed on the TPU as one float32 cumulative sum
// over the whole utterance plus two gathers.
//
// Input (B, T, F) float32, contiguous; num_valid (B,) int32 or null (every
// frame valid). For frame t of an utterance with n valid frames the window
// is [start, end):
//
//   centred:  start = clip(t - w/2, 0, max(0, n - w)),  end = min(start + w, n)
//   trailing: end   = min(max(t + 1, min(min_window, n)), n)
//             start = min(max(t - w + 1, 0), max(end - w, 0))
//
//   y[t] = x[t] - mean(x[start:end])
//   y[t] = y[t] * rsqrt(max(var(x[start:end]), 1e-10))      (norm_vars)
//
// with count max(end - start, 1). The window never reaches past n, so padded
// frames (t >= n) add nothing; they are normalized with the last window's
// statistics, as the JAX version does.
//
// Bound on the card: bytes (x read once and y written once, a few flops a
// frame). One thread a (utterance, bin, tile of kTile frames); consecutive
// threads take consecutive bins, so each frame row is read by neighbouring
// lanes. A thread sums its tile's first window directly, then slides it: both
// window edges are monotone in t for the centred and the trailing rule, so
// each step adds the frames that enter and subtracts the frames that leave.
// The running sums are float64: the error of a slid sum stays independent
// of T (a float32 cumulative sum over a 16000-frame utterance drifts to
// ~1.5e-4 on features of 12 +- 3), and the card's float64 rate is far above
// what the bytes allow. Reruns are bit-equal: each output has one order of
// additions.
#include "common.cuh"

namespace {

constexpr int kTile = 128;     // frames one thread walks
constexpr int kThreads = 256;

__device__ __forceinline__ void window_at(int t, int n, int w, int center,
                                          int min_window, int* start, int* end) {
  if (center) {
    const int s = min(max(t - w / 2, 0), max(0, n - w));
    *start = s;
    *end = min(s + w, n);
  } else {
    const int e = min(max(t + 1, min(min_window, n)), n);
    *start = min(max(t - w + 1, 0), max(e - w, 0));
    *end = e;
  }
}

__global__ void __launch_bounds__(kThreads)
    sliding_cmvn_kernel(const float* __restrict__ x, const int* __restrict__ num_valid,
                        float* __restrict__ out, int batch, int tlen, int flen, int tiles,
                        int window, int center, int norm_vars, int min_window) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= static_cast<long long>(batch) * tiles * flen) return;
  const int f = static_cast<int>(g % flen);
  const long long row = g / flen;
  const int tile = static_cast<int>(row % tiles);
  const int b = static_cast<int>(row / tiles);
  const int n = num_valid != nullptr ? min(max(num_valid[b], 0), tlen) : tlen;
  const long long base = static_cast<long long>(b) * tlen * flen + f;
  const float* xb = x + base;
  float* ob = out + base;

  const int t0 = tile * kTile;
  const int t1 = min(t0 + kTile, tlen);
  int s, e;
  window_at(t0, n, window, center, min_window, &s, &e);
  double sum = 0.0, sq = 0.0;
  for (int t = s; t < e; ++t) {
    const double v = xb[static_cast<long long>(t) * flen];
    sum += v;
    sq += v * v;
  }
  for (int t = t0; t < t1; ++t) {
    int s2, e2;
    window_at(t, n, window, center, min_window, &s2, &e2);
    for (; e < e2; ++e) {
      const double v = xb[static_cast<long long>(e) * flen];
      sum += v;
      sq += v * v;
    }
    for (; s < s2; ++s) {
      const double v = xb[static_cast<long long>(s) * flen];
      sum -= v;
      sq -= v * v;
    }
    const double count = static_cast<double>(max(e - s, 1));
    const double mean = sum / count;
    double y = static_cast<double>(xb[static_cast<long long>(t) * flen]) - mean;
    if (norm_vars) y *= 1.0 / sqrt(fmax(sq / count - mean * mean, 1e-10));
    ob[static_cast<long long>(t) * flen] = static_cast<float>(y);
  }
}

}  // namespace

// x, out: (batch, tlen, flen) float32; num_valid: (batch,) int32 or null.
// One launch; refuses a window below 1.
extern "C" int sliding_cmvn(const float* x, const int* num_valid, float* out, int batch,
                            int tlen, int flen, int window, int center, int norm_vars,
                            int min_window, cudaStream_t stream) {
  if (window < 1 || batch < 0 || tlen < 0 || flen < 0) return vsv::kShapeUnsupported;
  if (batch == 0 || tlen == 0 || flen == 0) return 0;
  const int tiles = (tlen + kTile - 1) / kTile;
  const long long threads = static_cast<long long>(batch) * tiles * flen;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return vsv::kShapeUnsupported;
  sliding_cmvn_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, num_valid, out, batch, tlen, flen, tiles, window, center, norm_vars, min_window);
  return static_cast<int>(cudaGetLastError());
}
