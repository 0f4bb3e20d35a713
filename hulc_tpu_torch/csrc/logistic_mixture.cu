// Logistic-mixture action sampler, from the raw uniform draws to the action.
//
// Replaces hulc_tpu/ops/logistic_mixture.py logistic_mixture_sample
// (lines 114-145) and the gripper pick of hulc_tpu/models/decoders.py
// _sample_from_outputs (lines 157-162). For each action dimension, a
// Gumbel-max pick of one of K mixture components,
// argmax_k(logit_k - log(-log u_k)), then the logistic inverse CDF
// mean_k + exp(log_scale_k) * (log u - log(1 - u)); with gripper logits, the
// last column is act_max where logit_1 > logit_0 (argmax's first index on
// ties), else act_min. The uniforms are inputs (raw draws of the caller's
// torch.Generator, or noise the tests inject), mapped in the kernel as
// lo + span * u with round-to-nearest intrinsics, which is the plain
// version's multiply then add; injected noise passes (0, 1), which is exact.
//
// Bound on the H100: launch latency. The policy step samples 64 lanes x 6
// dims x 10 components, about 61 KB in all; the launch itself costs
// microseconds. Design: a row's components spread over a 16-lane group, one
// a lane (a lane loop when K > 16), so each lane's two logs run side by
// side rather than 20 on one thread's chain; a segmented 4-round shuffle
// argmax that keeps the first index on ties and orders NaN first, as
// torch.argmax does; the lane that holds the
// picked component (its mean and log scale already in registers) does the
// inverse CDF. One launch writes the whole (..., A + 1) action. The final
// multiply-add uses round-to-nearest intrinsics so it is not contracted
// into an FMA and rounds as the plain PyTorch version does.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;  // lanes per (lane, dim) row
constexpr int kThreads = 128;

__device__ __forceinline__ float map_uniform(float u, float lo, float span) {
  return __fadd_rn(__fmul_rn(u, span), lo);
}

// (a, ia) before (b, ib) in torch.argmax's order: NaN above every number,
// then the larger value, then the lower index. A strict total order, so
// exactly one lane of a group ends holding the winner.
__device__ __forceinline__ bool ahead(float a, int ia, float b, int ib) {
  const bool a_nan = isnan(a), b_nan = isnan(b);  // bitwise: no branch on the chain
  return (a > b) | (a_nan & !b_nan) | (((a == b) | (a_nan & b_nan)) & (ia < ib));
}

__global__ void __launch_bounds__(kThreads)
logistic_mixture_sample_kernel(const float* __restrict__ logit_probs, const float* __restrict__ log_scales,
                               const float* __restrict__ means, const float* __restrict__ u_mix,
                               const float* __restrict__ u_inv, const float* __restrict__ gripper_logits,
                               float* __restrict__ out, long long rows, int dims, int k, float lo, float span,
                               float grip_lo, float grip_hi) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kLanes;
  if (row >= rows) return;  // whole groups: a group never straddles the end
  const int sub = threadIdx.x % kLanes;
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
  const long long lead = row / dims;
  const int dim = static_cast<int>(row - lead * dims);
  const int cols = dims + (gripper_logits != nullptr);
  const long long base = row * k;
  const float u = map_uniform(__ldg(u_inv + row), lo, span);

  float best = -INFINITY, mean = 0.0f, log_scale = 0.0f;
  int pick = INT_MAX;
  for (int j = sub; j < k; j += kLanes) {
    const float lp = __ldg(logit_probs + base + j), mu = __ldg(means + base + j);
    const float ls = __ldg(log_scales + base + j);
    const float score = lp - logf(-logf(map_uniform(__ldg(u_mix + base + j), lo, span)));
    if (ahead(score, j, best, pick)) best = score, pick = j, mean = mu, log_scale = ls;
  }
  int winner = pick;
  for (int offset = kLanes / 2; offset > 0; offset >>= 1) {
    const float ob = __shfl_xor_sync(mask, best, offset);
    const int oj = __shfl_xor_sync(mask, winner, offset);
    if (ahead(ob, oj, best, winner)) best = ob, winner = oj;
  }
  if (pick == winner) {  // the one lane that holds the picked component
    const float logistic = __fsub_rn(logf(u), logf(__fsub_rn(1.0f, u)));
    out[lead * cols + dim] = __fadd_rn(mean, __fmul_rn(expf(log_scale), logistic));
  }
  if (gripper_logits != nullptr && dim == 0 && sub == kLanes - 1) {
    const float g0 = __ldg(gripper_logits + 2 * lead), g1 = __ldg(gripper_logits + 2 * lead + 1);
    // torch.argmax over the pair: index 1 where it is larger, or NaN while index 0 is not
    const bool open = g1 > g0 || (isnan(g1) && !isnan(g0));
    out[lead * cols + dims] = open ? grip_hi : grip_lo;
  }
}

}  // namespace

extern "C" int hulc_logistic_mixture_sample(const void* logit_probs, const void* log_scales,
                                            const void* means, const void* u_mix, const void* u_inv,
                                            const void* gripper_logits, void* out, long long rows, int dims,
                                            int k, float lo, float span, float grip_lo, float grip_hi,
                                            void* stream) {
  if (rows > 0) {
    const long long blocks = (rows * kLanes + kThreads - 1) / kThreads;
    logistic_mixture_sample_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logit_probs), static_cast<const float*>(log_scales),
        static_cast<const float*>(means), static_cast<const float*>(u_mix), static_cast<const float*>(u_inv),
        static_cast<const float*>(gripper_logits), static_cast<float*>(out), rows, dims, k, lo, span, grip_lo,
        grip_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
