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
// 1.5 MB, a fraction of a microsecond of memory traffic. So the design
// spreads the work over every SM and evaluates each component once:
//   * forward: a block of 256 threads takes a tile of whole rows (as many as
//     fit one component per thread, 4 rows at A * K = 60, so 512 blocks for
//     the step's 2048 rows; one row, its components strided over the
//     threads, where A * K > 256). The row's actions and the bin bounds go
//     to shared memory; then one thread per (row, a, k) loads its three
//     inputs (consecutive threads, consecutive addresses) and evaluates its
//     component's branch value once, into shared memory. One thread per
//     (row, a) segment reduces over K from shared memory: the logits' max
//     and log-sum, then the logsumexp of branch + log_softmax. One thread
//     per row sums its A segments and adds the gripper CE.
//   * gradients: when autograd will need them, the same launch also writes,
//     per component, the derivatives of its row's loss (pi_k the mixture
//     softmax, w_k the logsumexp weight, both from the segment's stored
//     max and sums): d_logit = pi - w, d_mean = -w * d branch / d mean,
//     d_log_scale = -w * d branch / d log_scale (zero where the clamp at
//     log_scale_min is active, i.e. where the input lies below it, as
//     torch.clamp_min's backward does), and d_gripper = alpha * (softmax -
//     onehot). Under no_grad the pointers are null and nothing more is
//     written.
//   * backward: one launch multiplies those four tensors by the incoming
//     per-row gradient, 16-byte loads and stores where the pointers allow.
// Shared memory grows with A * K (16 bytes a component with gradients); the
// launch refuses a tile that needs more than the 227 KB a block can have,
// which is A * K above about 14,000.

#include <cmath>
#include <cstdint>
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

struct FwdArgs {
  const float* logit_probs;  // (rows, A, K)
  const float* log_scales;   // (rows, A, K)
  const float* means;        // (rows, A, K)
  const float* actions;      // (rows, act_stride): A continuous dims, then the gripper
  const float* gripper;      // (rows, 2) or null
  const float* act_min;      // (A,)
  const float* act_max;      // (A,)
  float* out;                // (rows,)
  float* d_logit_probs;      // (rows, A, K) or null: no gradients
  float* d_log_scales;       // (rows, A, K)
  float* d_means;            // (rows, A, K)
  float* d_gripper;          // (rows, 2) or null
  long long rows;
  int a_dims, k, act_stride, num_classes, tile_rows;
  float log_scale_min, gripper_alpha;
};

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;

// Floats of shared memory for a tile: per component the logit and the
// branch value (and with gradients its two derivatives); per segment the
// action, the logits' max and log-sum and the logsumexp; per dimension
// the bin's bounds and half width.
long long fwd_smem_floats(long long tile_rows, long long a_dims, long long k, bool grad) {
  return (grad ? 4 : 2) * tile_rows * a_dims * k + 4 * tile_rows * a_dims + 3 * a_dims;
}

__global__ void __launch_bounds__(kFwdThreads) mixture_nll_fwd_kernel(FwdArgs p) {
  extern __shared__ float smem[];
  const int A = p.a_dims, K = p.k, comps = A * K;
  const bool grad = p.d_logit_probs != nullptr;
  const long long row0 = static_cast<long long>(blockIdx.x) * p.tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.rows - row0));
  const int n = rows * comps, segs = rows * A;
  const int span = p.tile_rows * comps, seg_span = p.tile_rows * A;
  float* s_lp = smem;
  float* s_branch = s_lp + span;
  float* s_dmean = s_branch + span;
  float* s_dls = s_dmean + (grad ? span : 0);
  float* s_x = s_dls + (grad ? span : 0);
  float* s_max = s_x + seg_span;
  float* s_log_sum = s_max + seg_span;
  float* s_lse = s_log_sum + seg_span;
  float* s_lo = s_lse + seg_span;
  float* s_hi = s_lo + A;
  float* s_half = s_hi + A;

  for (int i = threadIdx.x; i < segs; i += kFwdThreads) {
    const int r = i / A;
    s_x[i] = p.actions[(row0 + r) * p.act_stride + (i - r * A)];
  }
  for (int a = threadIdx.x; a < A; a += kFwdThreads) {
    const float lo = p.act_min[a], hi = p.act_max[a];
    s_lo[a] = lo + 1e-3f;
    s_hi[a] = hi - 1e-3f;
    s_half[a] = ((hi - lo) / 2.0f) / static_cast<float>(p.num_classes - 1);
  }
  __syncthreads();

  // one thread per component: its branch value, once
  const long long base = row0 * comps;
  const float log_half_bins = logf(static_cast<float>(p.num_classes - 1) / 2.0f);
  for (int e = threadIdx.x; e < n; e += kFwdThreads) {
    const int seg = e / K, a = seg % A;
    const Bin bin{s_x[seg], s_half[a], s_lo[a], s_hi[a], log_half_bins};
    const float raw_ls = p.log_scales[base + e];
    const float mean = p.means[base + e];
    const float ls = fmaxf(raw_ls, p.log_scale_min);
    s_lp[e] = p.logit_probs[base + e];
    if (grad) {
      float dm, dl;
      s_branch[e] = bin_log_prob<true>(bin, mean, ls, &dm, &dl);
      s_dmean[e] = dm;
      s_dls[e] = raw_ls < p.log_scale_min ? 0.0f : dl;
    } else {
      float unused0, unused1;
      s_branch[e] = bin_log_prob<false>(bin, mean, ls, &unused0, &unused1);
    }
  }
  __syncthreads();

  // one thread per (row, a): the reductions over K
  for (int s = threadIdx.x; s < segs; s += kFwdThreads) {
    const float* lp = s_lp + s * K;
    const float* br = s_branch + s * K;
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) m = fmaxf(m, lp[k]);
    float sum = 0.0f;
    for (int k = 0; k < K; ++k) sum += expf(lp[k] - m);
    const float log_sum = logf(sum);
    float c_max = -INFINITY;
    for (int k = 0; k < K; ++k) c_max = fmaxf(c_max, br[k] + ((lp[k] - m) - log_sum));
    float c_sum = 0.0f;
    for (int k = 0; k < K; ++k) c_sum += expf((br[k] + ((lp[k] - m) - log_sum)) - c_max);
    s_max[s] = m;
    s_log_sum[s] = log_sum;
    s_lse[s] = c_max + logf(c_sum);
  }
  __syncthreads();

  if (grad) {
    for (int e = threadIdx.x; e < n; e += kFwdThreads) {
      const int seg = e / K;
      const float log_pi = (s_lp[e] - s_max[seg]) - s_log_sum[seg];
      const float w = expf((s_branch[e] + log_pi) - s_lse[seg]);
      p.d_logit_probs[base + e] = expf(log_pi) - w;
      p.d_means[base + e] = -w * s_dmean[e];
      p.d_log_scales[base + e] = -w * s_dls[e];
    }
  }
  // one thread per row: the sum over A and the gripper CE
  for (int r = threadIdx.x; r < rows; r += kFwdThreads) {
    const long long row = row0 + r;
    float total = 0.0f;
    for (int a = 0; a < A; ++a) total += s_lse[r * A + a];
    float loss = -total;
    if (p.gripper != nullptr) {
      const float g0 = p.gripper[2 * row], g1 = p.gripper[2 * row + 1];
      const float m = fmaxf(g0, g1);
      const float e0 = expf(g0 - m), e1 = expf(g1 - m);
      const float log_sum = logf(e0 + e1);
      const bool label = p.actions[row * p.act_stride + A] > 0.0f;
      loss += p.gripper_alpha * -(((label ? g1 : g0) - m) - log_sum);
      if (grad) {
        const float s = e0 + e1;
        p.d_gripper[2 * row] = p.gripper_alpha * (e0 / s - (label ? 0.0f : 1.0f));
        p.d_gripper[2 * row + 1] = p.gripper_alpha * (e1 / s - (label ? 1.0f : 0.0f));
      }
    }
    p.out[row] = loss;
  }
}

struct BwdArgs {
  const float* grad;                           // (rows,)
  const float *d_logit_probs, *d_log_scales, *d_means, *d_gripper;  // the forward's
  float *g_logit_probs, *g_log_scales, *g_means, *g_gripper;        // outputs
  long long rows;
  int comps;  // A * K
  bool vec;   // every pointer 16-byte aligned
};

// dst[e] = grad[e / per_row] * src[e] for the 4 elements from 4 * chunk.
__device__ __forceinline__ void scale_chunk(const float* __restrict__ src, float* __restrict__ dst,
                                            const float* __restrict__ grad, long long chunk,
                                            long long n, int per_row, bool vec) {
  const long long e0 = 4 * chunk;
  if (e0 >= n) return;
  long long row = e0 / per_row;
  int col = static_cast<int>(e0 - row * per_row);
  float g[4];
  for (int j = 0; j < 4; ++j) {
    g[j] = e0 + j < n ? grad[row] : 0.0f;
    if (++col == per_row) {
      col = 0;
      ++row;
    }
  }
  if (vec && e0 + 4 <= n) {
    float4 v = *reinterpret_cast<const float4*>(src + e0);
    v.x *= g[0];
    v.y *= g[1];
    v.z *= g[2];
    v.w *= g[3];
    *reinterpret_cast<float4*>(dst + e0) = v;
  } else {
    for (int j = 0; j < 4 && e0 + j < n; ++j) dst[e0 + j] = src[e0 + j] * g[j];
  }
}

__global__ void __launch_bounds__(kBwdThreads) mixture_nll_bwd_kernel(BwdArgs p) {
  const long long chunk = static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  const long long n = p.rows * p.comps;
  scale_chunk(p.d_logit_probs, p.g_logit_probs, p.grad, chunk, n, p.comps, p.vec);
  scale_chunk(p.d_log_scales, p.g_log_scales, p.grad, chunk, n, p.comps, p.vec);
  scale_chunk(p.d_means, p.g_means, p.grad, chunk, n, p.comps, p.vec);
  if (p.d_gripper != nullptr) scale_chunk(p.d_gripper, p.g_gripper, p.grad, chunk, 2 * p.rows, 2, p.vec);
}

}  // namespace

// With d_logit_probs, d_log_scales and d_means (and d_gripper when there is
// a gripper) the forward also writes each row's per-component derivatives;
// pass null for all four when no gradient is needed.
extern "C" int hulc_mixture_nll_fwd(const void* logit_probs, const void* log_scales,
                                    const void* means, const void* actions, const void* gripper,
                                    const void* act_min, const void* act_max, void* out,
                                    void* d_logit_probs, void* d_log_scales, void* d_means,
                                    void* d_gripper, long long rows, int a_dims, int k,
                                    int act_stride, int num_classes, float log_scale_min,
                                    float gripper_alpha, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const bool grad = d_logit_probs != nullptr;
  if (a_dims < 1 || k < 1 || (grad && (!d_log_scales || !d_means || (gripper && !d_gripper))))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs p;
  p.logit_probs = static_cast<const float*>(logit_probs);
  p.log_scales = static_cast<const float*>(log_scales);
  p.means = static_cast<const float*>(means);
  p.actions = static_cast<const float*>(actions);
  p.gripper = static_cast<const float*>(gripper);
  p.act_min = static_cast<const float*>(act_min);
  p.act_max = static_cast<const float*>(act_max);
  p.out = static_cast<float*>(out);
  p.d_logit_probs = static_cast<float*>(d_logit_probs);
  p.d_log_scales = static_cast<float*>(d_log_scales);
  p.d_means = static_cast<float*>(d_means);
  p.d_gripper = static_cast<float*>(d_gripper);
  p.rows = rows;
  p.a_dims = a_dims;
  p.k = k;
  p.act_stride = act_stride;
  p.num_classes = num_classes;
  p.log_scale_min = log_scale_min;
  p.gripper_alpha = gripper_alpha;
  const long long comps = static_cast<long long>(a_dims) * k;
  p.tile_rows = static_cast<int>(comps >= kFwdThreads ? 1 : kFwdThreads / comps);
  const long long smem_bytes = fwd_smem_floats(p.tile_rows, a_dims, k, grad) * 4;
  if (smem_bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);  // 227 KB a block
  const int smem = static_cast<int>(smem_bytes);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(mixture_nll_fwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (rows + p.tile_rows - 1) / p.tile_rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mixture_nll_fwd_kernel<<<static_cast<unsigned int>(blocks), kFwdThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// g_* = grad[row] * d_*: the forward's derivatives scaled by the incoming
// per-row gradient. d_gripper / g_gripper are null without a gripper.
extern "C" int hulc_mixture_nll_bwd(const void* grad, const void* d_logit_probs,
                                    const void* d_log_scales, const void* d_means,
                                    const void* d_gripper, void* g_logit_probs,
                                    void* g_log_scales, void* g_means, void* g_gripper,
                                    long long rows, int comps, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (comps < 1 || (d_gripper != nullptr) != (g_gripper != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs p;
  p.grad = static_cast<const float*>(grad);
  p.d_logit_probs = static_cast<const float*>(d_logit_probs);
  p.d_log_scales = static_cast<const float*>(d_log_scales);
  p.d_means = static_cast<const float*>(d_means);
  p.d_gripper = static_cast<const float*>(d_gripper);
  p.g_logit_probs = static_cast<float*>(g_logit_probs);
  p.g_log_scales = static_cast<float*>(g_log_scales);
  p.g_means = static_cast<float*>(g_means);
  p.g_gripper = static_cast<float*>(g_gripper);
  p.rows = rows;
  p.comps = comps;
  const std::uintptr_t any = reinterpret_cast<std::uintptr_t>(d_logit_probs) |
                             reinterpret_cast<std::uintptr_t>(d_log_scales) |
                             reinterpret_cast<std::uintptr_t>(d_means) |
                             reinterpret_cast<std::uintptr_t>(d_gripper) |
                             reinterpret_cast<std::uintptr_t>(g_logit_probs) |
                             reinterpret_cast<std::uintptr_t>(g_log_scales) |
                             reinterpret_cast<std::uintptr_t>(g_means) |
                             reinterpret_cast<std::uintptr_t>(g_gripper);
  p.vec = (any & 15) == 0;
  const long long n = rows * (comps > 2 ? comps : 2);
  const long long blocks = ((n + 3) / 4 + kBwdThreads - 1) / kBwdThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mixture_nll_bwd_kernel<<<static_cast<unsigned int>(blocks), kBwdThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
