// K6: sub-center cos-margin head (sc_cm_linear) with softmax cross-entropy,
// forward and backward.
//
// Replaces: voxsrc2020_speaker_verification_tpu/losses/projections.py:
// MarginProjection for kind "sc_cm_linear" (lines 96-140, from the max over
// centers on) and the cross-entropy and accuracy of training/trainer.py:
// 152-154, with their JAX autodiff, which XLA compiled on the TPU.
//
// Input: cos_all (K, B, C) fp32, the products of the l2-normalized
// embeddings and the l2-normalized sub-center kernel (a torch matmul), and
// int64 labels (B,). Per row b, with y = labels[b]:
//
//   v[c]     = clip(max_k cos_all[k, b, c], -1, 1)
//   logit[c] = scale * (c == y ? v cos m - sqrt(max(1 - v^2, 0)) sin m - m1 : v)
//   loss[b]  = logsumexp(logit) - logit[y],  correct[b] = (argmax logit == y)
//
// (first-index argmax, as jnp.argmax.) The backward recomputes the row and
// writes dcos_all: (softmax - onehot) * scale * dloss, times
// cos m + sin m * v / sin(theta) at the target, zero where the clip is
// active, routed to the maximal center(s), ties split evenly (the gradient
// of jnp.max).
//
// Bound on the card: bytes. (K, B, C) fp32 is read once forward and read and
// written once backward, at ~10 flops and one exp per class. One block per
// row walks C with an online max and sum (logsumexp in one pass); threads
// read consecutive classes, so every center's row streams coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Margin {
  float scale, cos_m, sin_m, m1;
};

__device__ __forceinline__ float target_logit(float v, const Margin& mg) {
  const float st = sqrtf(fmaxf(1.f - v * v, 0.f));
  return mg.scale * (v * mg.cos_m - st * mg.sin_m - mg.m1);
}

__device__ __forceinline__ float clip1(float v) {
  return fminf(fmaxf(v, -1.f), 1.f);
}

__global__ void margin_ce_fwd_kernel(const float* __restrict__ cos_all,
                                     const long long* __restrict__ labels,
                                     int centers, int batch, int classes,
                                     Margin mg, float* __restrict__ loss,
                                     float* __restrict__ correct,
                                     float* __restrict__ lse_out) {
  const int b = blockIdx.x;
  const int y = static_cast<int>(labels[b]);
  const long long kstride = static_cast<long long>(batch) * classes;
  const float* row = cos_all + static_cast<long long>(b) * classes;
  float m = -INFINITY, s = 0.f, best = -INFINITY;
  int best_c = classes;
  for (int c = threadIdx.x; c < classes; c += blockDim.x) {
    float v = row[c];
    for (int k = 1; k < centers; ++k) v = fmaxf(v, row[k * kstride + c]);
    v = clip1(v);
    const float l = c == y ? target_logit(v, mg) : mg.scale * v;
    if (l > m) {
      s = s * expf(m - l) + 1.f;
      m = l;
    } else {
      s += expf(l - m);
    }
    if (l > best) {
      best = l;
      best_c = c;
    }
  }
  __shared__ float sh_m[kThreads], sh_s[kThreads], sh_b[kThreads];
  __shared__ int sh_c[kThreads];
  sh_m[threadIdx.x] = m;
  sh_s[threadIdx.x] = s;
  sh_b[threadIdx.x] = best;
  sh_c[threadIdx.x] = best_c;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      const int o = threadIdx.x + half;
      const float m0 = sh_m[threadIdx.x], m1 = sh_m[o];
      const float mm = fmaxf(m0, m1);
      float ss = 0.f;
      if (m0 > -INFINITY) ss += sh_s[threadIdx.x] * expf(m0 - mm);
      if (m1 > -INFINITY) ss += sh_s[o] * expf(m1 - mm);
      sh_m[threadIdx.x] = mm;
      sh_s[threadIdx.x] = ss;
      const float b0 = sh_b[threadIdx.x], b1 = sh_b[o];
      if (b1 > b0 || (b1 == b0 && sh_c[o] < sh_c[threadIdx.x])) {
        sh_b[threadIdx.x] = b1;
        sh_c[threadIdx.x] = sh_c[o];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float v = row[y];
    for (int k = 1; k < centers; ++k) v = fmaxf(v, row[k * kstride + y]);
    const float lse = sh_m[0] + logf(sh_s[0]);
    loss[b] = lse - target_logit(clip1(v), mg);
    correct[b] = sh_c[0] == y ? 1.f : 0.f;
    lse_out[b] = lse;
  }
}

__global__ void margin_ce_bwd_kernel(const float* __restrict__ cos_all,
                                     const long long* __restrict__ labels,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ dloss,
                                     int centers, int batch, int classes,
                                     Margin mg, float* __restrict__ dcos_all) {
  const int b = blockIdx.x;
  const int y = static_cast<int>(labels[b]);
  const long long kstride = static_cast<long long>(batch) * classes;
  const long long roff = static_cast<long long>(b) * classes;
  const float l0 = lse[b], g0 = dloss[b];
  for (int c = threadIdx.x; c < classes; c += blockDim.x) {
    float v = cos_all[roff + c];
    for (int k = 1; k < centers; ++k) v = fmaxf(v, cos_all[k * kstride + roff + c]);
    int ties = 0;
    for (int k = 0; k < centers; ++k) ties += cos_all[k * kstride + roff + c] == v;
    const float vc = clip1(v);
    float dv;
    if (c == y) {
      const float st = sqrtf(fmaxf(1.f - vc * vc, 0.f));
      const float p = expf(target_logit(vc, mg) - l0);
      dv = (p - 1.f) * g0 * mg.scale * (mg.cos_m + mg.sin_m * vc / st);
    } else {
      dv = expf(mg.scale * vc - l0) * g0 * mg.scale;
    }
    if (v < -1.f || v > 1.f) dv = 0.f;
    dv /= static_cast<float>(ties);
    for (int k = 0; k < centers; ++k) {
      const long long e = k * kstride + roff + c;
      dcos_all[e] = cos_all[e] == v ? dv : 0.f;
    }
  }
}

}  // namespace

// cos_all: (centers, batch, classes) fp32; labels: (batch,) int64. Writes
// loss, correct (0/1) and lse, each (batch,) fp32.
extern "C" int margin_ce_fwd(const float* cos_all, const long long* labels,
                             int centers, int batch, int classes, float scale,
                             float cos_m, float sin_m, float m1, float* loss,
                             float* correct, float* lse, void* stream) {
  const Margin mg{scale, cos_m, sin_m, m1};
  margin_ce_fwd_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cos_all, labels, centers, batch, classes, mg, loss, correct, lse);
  return static_cast<int>(cudaGetLastError());
}

// dloss: (batch,) fp32, the gradient of the per-row loss. Writes every
// element of dcos_all (centers, batch, classes).
extern "C" int margin_ce_bwd(const float* cos_all, const long long* labels,
                             const float* lse, const float* dloss, int centers,
                             int batch, int classes, float scale, float cos_m,
                             float sin_m, float m1, float* dcos_all,
                             void* stream) {
  const Margin mg{scale, cos_m, sin_m, m1};
  margin_ce_bwd_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cos_all, labels, lse, dloss, centers, batch, classes, mg, dcos_all);
  return static_cast<int>(cudaGetLastError());
}
