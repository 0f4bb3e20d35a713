// Discretized logistic-mixture NLL plus the gripper cross-entropy, forward
// and backward.
//
// Replaces hulc_tpu/ops/logistic_mixture.py logistic_mixture_log_prob /
// logistic_mixture_loss (lines 23-111) and hulc_tpu/models/decoders.py
// _cross_entropy_gripper (lines 52-61), which the JAX package writes as
// fused jnp expressions and differentiates with XLA. For each (b, s) row:
//
//   loss = -sum_a logsumexp_k(branch_ak + log_softmax_k(logit_probs)_ak)
//          + gripper_alpha * CE(gripper_logits, gt_gripper > 0)
//
// where branch_ak is the log mass of the action's bin under component k,
// with the three `where` branches and the 1e-12 / 1e-5 guards of the JAX
// function (edge bins at act_min + 1e-3 / act_max - 1e-3, the interior
// bin's mass, the density fallback when that mass is below 1e-5). The mean
// over S (and over B) stays in torch.
//
// Bound on the H100: launch latency. The training step's inputs are three
// (64, 32, 6, 10) fp32 tensors, the actions and the gripper logits, about
// 1.5 MB, a fraction of a microsecond of memory traffic. Design: one thread
// per row, looping over A = 6 dimensions and K = 10 components in registers;
// nothing is stored between the loops but a few scalars, so each loop over
// K recomputes the branch values it needs (a few dozen flops) instead of
// keeping them in local memory. The backward recomputes the forward's
// intermediates from the same inputs and writes the gradients of the logits,
// the log scales (zero where the clamp at log_scale_min is active, i.e.
// where the input lies below it, as torch.clamp_min's backward does), the
// means and the gripper logits, scaled by the incoming per-row gradient.

#include <cmath>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

struct Bin {
  float x;              // the action
  float half_width;     // half a bin
  float lo, hi;         // act_min + 1e-3, act_max - 1e-3
  float log_half_bins;  // log((num_classes - 1) / 2)
};

// Log mass of the action's bin under one logistic component; with GRAD also
// its derivatives with respect to the mean and the (clamped) log scale.
template <bool GRAD>
__device__ __forceinline__ float bin_log_prob(const Bin& bin, float mean, float log_scale,
                                              float* d_mean, float* d_log_scale) {
  const float centered = bin.x - mean;
  const float inv_stdv = expf(-log_scale);
  const float plus_in = inv_stdv * (centered + bin.half_width);
  const float min_in = inv_stdv * (centered - bin.half_width);
  if (bin.x < bin.lo) {  // lowest bin: log sigmoid(plus_in)
    if (GRAD) {
      const float d = 1.0f - sigmoid(plus_in);
      *d_mean = -d * inv_stdv;
      *d_log_scale = -d * plus_in;
    }
    return plus_in - softplus(plus_in);
  }
  if (bin.x > bin.hi) {  // highest bin: log(1 - sigmoid(min_in))
    if (GRAD) {
      const float d = -sigmoid(min_in);
      *d_mean = -d * inv_stdv;
      *d_log_scale = -d * min_in;
    }
    return -softplus(min_in);
  }
  const float s_plus = sigmoid(plus_in), s_min = sigmoid(min_in);
  const float cdf_delta = s_plus - s_min;
  if (cdf_delta > 1e-5f) {  // interior bin's mass
    if (GRAD) {
      const float dp = s_plus * (1.0f - s_plus) / cdf_delta;
      const float dm = -s_min * (1.0f - s_min) / cdf_delta;
      *d_mean = -(dp + dm) * inv_stdv;
      *d_log_scale = -(dp * plus_in + dm * min_in);
    }
    return logf(fmaxf(cdf_delta, 1e-12f));
  }
  const float mid_in = inv_stdv * centered;  // density at the bin's centre
  if (GRAD) {
    const float d = 1.0f - 2.0f * sigmoid(mid_in);
    *d_mean = -d * inv_stdv;
    *d_log_scale = -d * mid_in - 1.0f;
  }
  return mid_in - log_scale - 2.0f * softplus(mid_in) - bin.log_half_bins;
}

struct Args {
  const float* logit_probs;  // (rows, A, K)
  const float* log_scales;   // (rows, A, K)
  const float* means;        // (rows, A, K)
  const float* actions;      // (rows, act_stride): A continuous dims, then the gripper
  const float* gripper;      // (rows, 2) or null
  const float* act_min;      // (A,)
  const float* act_max;      // (A,)
  long long rows;
  int a_dims, k, act_stride, num_classes;
  float log_scale_min, gripper_alpha;
};

__device__ __forceinline__ Bin make_bin(const Args& p, long long row, int a) {
  Bin bin;
  bin.x = p.actions[row * p.act_stride + a];
  const float act_range = (p.act_max[a] - p.act_min[a]) / 2.0f;
  bin.half_width = act_range / static_cast<float>(p.num_classes - 1);
  bin.lo = p.act_min[a] + 1e-3f;
  bin.hi = p.act_max[a] - 1e-3f;
  bin.log_half_bins = logf(static_cast<float>(p.num_classes - 1) / 2.0f);
  return bin;
}

// Per dimension: the log-softmax normalizer of the logits (max, log-sum)
// and the logsumexp over components of branch + log-softmax (max, sum).
struct DimStats {
  float lp_max, lp_sum, lp_log_sum, comp_max, comp_sum;
};

__device__ __forceinline__ float component(const Args& p, const Bin& bin, long long off, int k,
                                           const DimStats& st) {
  const float ls = fmaxf(p.log_scales[off + k], p.log_scale_min);
  float unused0, unused1;
  return bin_log_prob<false>(bin, p.means[off + k], ls, &unused0, &unused1) +
         ((p.logit_probs[off + k] - st.lp_max) - st.lp_log_sum);
}

__device__ __forceinline__ DimStats dim_stats(const Args& p, const Bin& bin, long long off) {
  DimStats st;
  st.lp_max = -INFINITY;
  for (int k = 0; k < p.k; ++k) st.lp_max = fmaxf(st.lp_max, p.logit_probs[off + k]);
  float s = 0.0f;
  for (int k = 0; k < p.k; ++k) s += expf(p.logit_probs[off + k] - st.lp_max);
  st.lp_sum = s;
  st.lp_log_sum = logf(s);
  st.comp_max = -INFINITY;
  for (int k = 0; k < p.k; ++k) st.comp_max = fmaxf(st.comp_max, component(p, bin, off, k, st));
  st.comp_sum = 0.0f;
  for (int k = 0; k < p.k; ++k) st.comp_sum += expf(component(p, bin, off, k, st) - st.comp_max);
  return st;
}

__device__ __forceinline__ int gripper_label(const Args& p, long long row) {
  return p.actions[row * p.act_stride + p.a_dims] > 0.0f ? 1 : 0;
}

__global__ void mixture_nll_fwd_kernel(Args p, float* __restrict__ out) {
  long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= p.rows) return;
  float total = 0.0f;
  for (int a = 0; a < p.a_dims; ++a) {
    const Bin bin = make_bin(p, row, a);
    const DimStats st = dim_stats(p, bin, (row * p.a_dims + a) * p.k);
    total += st.comp_max + logf(st.comp_sum);
  }
  float loss = -total;
  if (p.gripper != nullptr) {
    const float g0 = p.gripper[2 * row], g1 = p.gripper[2 * row + 1];
    const float m = fmaxf(g0, g1);
    const float log_sum = logf(expf(g0 - m) + expf(g1 - m));
    const float picked = gripper_label(p, row) ? g1 : g0;
    loss += p.gripper_alpha * -((picked - m) - log_sum);
  }
  out[row] = loss;
}

__global__ void mixture_nll_bwd_kernel(Args p, const float* __restrict__ grad,
                                       float* __restrict__ d_logit_probs,
                                       float* __restrict__ d_log_scales,
                                       float* __restrict__ d_means,
                                       float* __restrict__ d_gripper) {
  long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= p.rows) return;
  const float g = grad[row];
  for (int a = 0; a < p.a_dims; ++a) {
    const Bin bin = make_bin(p, row, a);
    const long long off = (row * p.a_dims + a) * p.k;
    const DimStats st = dim_stats(p, bin, off);
    // d loss / d logsumexp = -g; the logsumexp's weights w_k; the
    // log-softmax's backward subtracts pi_j * sum_k(g_k)
    float g_sum = 0.0f;
    for (int k = 0; k < p.k; ++k)
      g_sum += -g * (expf(component(p, bin, off, k, st) - st.comp_max) / st.comp_sum);
    for (int k = 0; k < p.k; ++k) {
      const float gk = -g * (expf(component(p, bin, off, k, st) - st.comp_max) / st.comp_sum);
      const float pi = expf(p.logit_probs[off + k] - st.lp_max) / st.lp_sum;
      d_logit_probs[off + k] = gk - pi * g_sum;
      const float raw_ls = p.log_scales[off + k];
      const float ls = fmaxf(raw_ls, p.log_scale_min);
      float dm, dl;
      bin_log_prob<true>(bin, p.means[off + k], ls, &dm, &dl);
      d_means[off + k] = gk * dm;
      d_log_scales[off + k] = raw_ls < p.log_scale_min ? 0.0f : gk * dl;
    }
  }
  if (p.gripper != nullptr) {
    const float g0 = p.gripper[2 * row], g1 = p.gripper[2 * row + 1];
    const float m = fmaxf(g0, g1);
    const float e0 = expf(g0 - m), e1 = expf(g1 - m);
    const float s = e0 + e1;
    const int label = gripper_label(p, row);
    const float c = p.gripper_alpha * g;
    d_gripper[2 * row] = c * (e0 / s - (label == 0 ? 1.0f : 0.0f));
    d_gripper[2 * row + 1] = c * (e1 / s - (label == 1 ? 1.0f : 0.0f));
  }
}

Args make_args(const void* logit_probs, const void* log_scales, const void* means,
               const void* actions, const void* gripper, const void* act_min,
               const void* act_max, long long rows, int a_dims, int k, int act_stride,
               int num_classes, float log_scale_min, float gripper_alpha) {
  Args p;
  p.logit_probs = static_cast<const float*>(logit_probs);
  p.log_scales = static_cast<const float*>(log_scales);
  p.means = static_cast<const float*>(means);
  p.actions = static_cast<const float*>(actions);
  p.gripper = static_cast<const float*>(gripper);
  p.act_min = static_cast<const float*>(act_min);
  p.act_max = static_cast<const float*>(act_max);
  p.rows = rows;
  p.a_dims = a_dims;
  p.k = k;
  p.act_stride = act_stride;
  p.num_classes = num_classes;
  p.log_scale_min = log_scale_min;
  p.gripper_alpha = gripper_alpha;
  return p;
}

const int kThreads = 128;

}  // namespace

extern "C" int hulc_mixture_nll_fwd(const void* logit_probs, const void* log_scales,
                                    const void* means, const void* actions, const void* gripper,
                                    const void* act_min, const void* act_max, void* out,
                                    long long rows, int a_dims, int k, int act_stride,
                                    int num_classes, float log_scale_min, float gripper_alpha,
                                    void* stream) {
  if (rows > 0) {
    Args p = make_args(logit_probs, log_scales, means, actions, gripper, act_min, act_max, rows,
                       a_dims, k, act_stride, num_classes, log_scale_min, gripper_alpha);
    long long blocks = (rows + kThreads - 1) / kThreads;
    mixture_nll_fwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(p, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hulc_mixture_nll_bwd(const void* logit_probs, const void* log_scales,
                                    const void* means, const void* actions, const void* gripper,
                                    const void* act_min, const void* act_max, const void* grad,
                                    void* d_logit_probs, void* d_log_scales, void* d_means,
                                    void* d_gripper, long long rows, int a_dims, int k,
                                    int act_stride, int num_classes, float log_scale_min,
                                    float gripper_alpha, void* stream) {
  if (rows > 0) {
    Args p = make_args(logit_probs, log_scales, means, actions, gripper, act_min, act_max, rows,
                       a_dims, k, act_stride, num_classes, log_scale_min, gripper_alpha);
    long long blocks = (rows + kThreads - 1) / kThreads;
    mixture_nll_bwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const float*>(grad), static_cast<float*>(d_logit_probs),
        static_cast<float*>(d_log_scales), static_cast<float*>(d_means),
        static_cast<float*>(d_gripper));
  }
  return static_cast<int>(cudaGetLastError());
}
