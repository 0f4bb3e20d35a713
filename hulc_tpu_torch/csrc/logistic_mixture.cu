// Logistic-mixture action sampler.
//
// Replaces hulc_tpu/ops/logistic_mixture.py logistic_mixture_sample
// (lines 114-145): for each action dimension, a Gumbel-max pick of one of K
// mixture components, argmax_k(logit_k - log(-log u_k)), then the logistic
// inverse CDF mean_k + exp(log_scale_k) * (log u - log(1 - u)). The
// uniforms are inputs (drawn by the caller's torch.Generator, or injected by
// tests), so the kernel is deterministic.
//
// Bound on the H100: launch latency. The policy step samples 64 lanes x 6
// dims x 10 components, about 61 KB in all, some 20 ns of memory traffic;
// the launch itself costs microseconds. Design: one thread per (lane, dim)
// walking its K components in registers, one launch for the whole batch,
// and no reduction across threads. The final multiply-add uses
// round-to-nearest intrinsics so it is not contracted into an FMA and
// rounds as the plain PyTorch version does.

#include <cmath>
#include <cuda_runtime.h>

namespace {

__global__ void logistic_mixture_sample_kernel(const float* __restrict__ logit_probs,
                                               const float* __restrict__ log_scales,
                                               const float* __restrict__ means,
                                               const float* __restrict__ u_mix,
                                               const float* __restrict__ u_inv,
                                               float* __restrict__ out, long long rows, int k) {
  long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const long long base = row * k;
  float best = -INFINITY;
  int pick = 0;
  for (int j = 0; j < k; ++j) {
    float score = logit_probs[base + j] - logf(-logf(u_mix[base + j]));
    if (score > best) {  // strict: the first maximum wins, as argmax does
      best = score;
      pick = j;
    }
  }
  const float u = u_inv[row];
  const float logistic = __fsub_rn(logf(u), logf(1.0f - u));
  out[row] = __fadd_rn(means[base + pick], __fmul_rn(expf(log_scales[base + pick]), logistic));
}

}  // namespace

extern "C" int hulc_logistic_mixture_sample(const void* logit_probs, const void* log_scales,
                                            const void* means, const void* u_mix,
                                            const void* u_inv, void* out, long long rows, int k,
                                            void* stream) {
  if (rows > 0) {
    const int threads = 128;
    long long blocks = (rows + threads - 1) / threads;
    logistic_mixture_sample_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logit_probs), static_cast<const float*>(log_scales),
        static_cast<const float*>(means), static_cast<const float*>(u_mix),
        static_cast<const float*>(u_inv), static_cast<float*>(out), rows, k);
  }
  return static_cast<int>(cudaGetLastError());
}
