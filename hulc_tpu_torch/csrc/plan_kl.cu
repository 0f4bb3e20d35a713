// Straight-through plan sample and the balanced KL of the discrete plan,
// forward and backward.
//
// Replaces hulc_tpu/ops/plan_distributions.py rsample and kl / balanced_kl
// (lines 102-147), which the JAX package writes as jnp expressions over the
// (B, categories, classes) logit grid and differentiates with XLA. Per
// (b, category) row of `classes` logits:
//
//   pick  = argmax_j(gumbel_j + post_j)  (first index on ties, as jnp.argmax)
//   p     = softmax(post)
//   st_j  = (one_hot(pick)_j + p_j) - p_j        (the value is not exactly
//           the one-hot: it is computed as JAX computes it)
//   kl    = sum_j exp(lp_j) * (lp_j - lq_j), lp / lq the log-softmax of the
//           posterior / prior logits
//
// and per b, over the categories: out_b = alpha * kl + (1 - alpha) * kl, the
// value of alpha * KL(sg(post) || prior) + (1 - alpha) * KL(post || sg(prior)).
// The backward carries the two stop-gradients apart: the straight-through
// path gives the softmax-Jacobian product p * (d_st - <p, d_st>) to the
// posterior, the (1 - alpha) term gives the posterior the KL's gradient in
// p, and the alpha term gives the prior the KL's gradient in q.
//
// Bound on the H100: launch latency. At the training step the inputs are
// three (64, 32, 32) fp32 grids, 0.8 MB. Design: one block per sample b,
// one warp per category, the lanes over the classes (32 on the hulc plan),
// warp shuffles for the argmax, the maxima and the sums; the per-category
// KLs meet in shared memory and are summed in category order.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_max(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// Per category row: the max and sum of exp(x - max) of each logit vector.
struct RowNorm {
  float post_max, post_sum, prior_max, prior_sum;
};

__device__ __forceinline__ RowNorm row_norm(const float* post, const float* prior, int classes,
                                            int lane) {
  RowNorm r;
  float pm = -INFINITY, qm = -INFINITY;
  for (int j = lane; j < classes; j += 32) {
    pm = fmaxf(pm, post[j]);
    qm = fmaxf(qm, prior[j]);
  }
  r.post_max = warp_max(pm);
  r.prior_max = warp_max(qm);
  float ps = 0.0f, qs = 0.0f;
  for (int j = lane; j < classes; j += 32) {
    ps += expf(post[j] - r.post_max);
    qs += expf(prior[j] - r.prior_max);
  }
  r.post_sum = warp_sum(ps);
  r.prior_sum = warp_sum(qs);
  return r;
}

const int kMaxWarps = 32;

__global__ void plan_st_kl_fwd_kernel(const float* __restrict__ post,
                                      const float* __restrict__ prior,
                                      const float* __restrict__ gumbel, float* __restrict__ st,
                                      float* __restrict__ kl_out, int cats, int classes,
                                      float alpha, float one_minus_alpha) {
  __shared__ float warp_kl[kMaxWarps];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  float kl_acc = 0.0f;
  for (int cat = warp; cat < cats; cat += n_warps) {
    const long long base = (static_cast<long long>(b) * cats + cat) * classes;
    const float* x = post + base;
    const float* y = prior + base;
    float best = -INFINITY;
    int best_j = INT_MAX;
    for (int j = lane; j < classes; j += 32) {
      const float v = gumbel[base + j] + x[j];
      if (v > best) {
        best = v;
        best_j = j;
      }
    }
    for (int offset = 16; offset > 0; offset >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, offset);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j, offset);
      if (ob > best || (ob == best && oj < best_j)) {
        best = ob;
        best_j = oj;
      }
    }
    const RowNorm r = row_norm(x, y, classes, lane);
    const float post_log_sum = logf(r.post_sum), prior_log_sum = logf(r.prior_sum);
    float kl = 0.0f;
    for (int j = lane; j < classes; j += 32) {
      const float lp = (x[j] - r.post_max) - post_log_sum;
      const float lq = (y[j] - r.prior_max) - prior_log_sum;
      kl += expf(lp) * (lp - lq);
      const float p = expf(x[j] - r.post_max) / r.post_sum;
      const float one_hot = j == best_j ? 1.0f : 0.0f;
      st[base + j] = __fsub_rn(__fadd_rn(one_hot, p), p);
    }
    kl_acc += warp_sum(kl);
  }
  if (lane == 0) warp_kl[warp] = kl_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float kl = 0.0f;
    for (int w = 0; w < n_warps; ++w) kl += warp_kl[w];
    kl_out[b] = alpha * kl + one_minus_alpha * kl;
  }
}

__global__ void plan_st_kl_bwd_kernel(const float* __restrict__ post,
                                      const float* __restrict__ prior,
                                      const float* __restrict__ d_st,
                                      const float* __restrict__ d_kl,
                                      float* __restrict__ d_post, float* __restrict__ d_prior,
                                      int cats, int classes, float alpha,
                                      float one_minus_alpha) {
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const float c_post = one_minus_alpha * d_kl[b];  // KL(post || sg(prior))
  const float c_prior = alpha * d_kl[b];           // KL(sg(post) || prior)
  for (int cat = warp; cat < cats; cat += n_warps) {
    const long long base = (static_cast<long long>(b) * cats + cat) * classes;
    const float* x = post + base;
    const float* y = prior + base;
    const float* g = d_st + base;
    const RowNorm r = row_norm(x, y, classes, lane);
    const float post_log_sum = logf(r.post_sum), prior_log_sum = logf(r.prior_sum);
    // <p, d_st> for the softmax's backward; the sums the two log-softmax
    // backwards subtract: sum_j p_j (lp_j - lq_j + 1) and sum_j -p_j
    float dot = 0.0f, g_lp_sum = 0.0f, g_lq_sum = 0.0f;
    for (int j = lane; j < classes; j += 32) {
      const float lp = (x[j] - r.post_max) - post_log_sum;
      const float lq = (y[j] - r.prior_max) - prior_log_sum;
      const float p = expf(lp);
      dot += (expf(x[j] - r.post_max) / r.post_sum) * g[j];
      g_lp_sum += p * (lp - lq) + p;
      g_lq_sum += -p;
    }
    dot = warp_sum(dot);
    g_lp_sum = warp_sum(g_lp_sum);
    g_lq_sum = warp_sum(g_lq_sum);
    for (int j = lane; j < classes; j += 32) {
      const float lp = (x[j] - r.post_max) - post_log_sum;
      const float lq = (y[j] - r.prior_max) - prior_log_sum;
      const float p = expf(lp), q = expf(lq);
      const float soft = expf(x[j] - r.post_max) / r.post_sum;
      const float g_lp = p * (lp - lq) + p;
      d_post[base + j] = soft * (g[j] - dot) + c_post * (g_lp - p * g_lp_sum);
      d_prior[base + j] = c_prior * (-p - q * g_lq_sum);
    }
  }
}

int block_threads(int cats) { return 32 * (cats < kMaxWarps ? (cats > 0 ? cats : 1) : kMaxWarps); }

}  // namespace

extern "C" int hulc_plan_st_kl_fwd(const void* post, const void* prior, const void* gumbel,
                                   void* st, void* kl, long long batch, int cats, int classes,
                                   float alpha, float one_minus_alpha, void* stream) {
  if (batch > 0) {
    plan_st_kl_fwd_kernel<<<static_cast<unsigned int>(batch), block_threads(cats), 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(post), static_cast<const float*>(prior),
        static_cast<const float*>(gumbel), static_cast<float*>(st), static_cast<float*>(kl),
        cats, classes, alpha, one_minus_alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hulc_plan_st_kl_bwd(const void* post, const void* prior, const void* d_st,
                                   const void* d_kl, void* d_post, void* d_prior,
                                   long long batch, int cats, int classes, float alpha,
                                   float one_minus_alpha, void* stream) {
  if (batch > 0) {
    plan_st_kl_bwd_kernel<<<static_cast<unsigned int>(batch), block_threads(cats), 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(post), static_cast<const float*>(prior),
        static_cast<const float*>(d_st), static_cast<const float*>(d_kl),
        static_cast<float*>(d_post), static_cast<float*>(d_prior), cats, classes, alpha,
        one_minus_alpha);
  }
  return static_cast<int>(cudaGetLastError());
}
