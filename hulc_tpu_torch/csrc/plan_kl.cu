// Straight-through plan sample and the balanced KL of the discrete plan,
// forward and backward.
//
// Replaces hulc_tpu/ops/plan_distributions.py rsample and kl / balanced_kl
// (lines 102-147), which the JAX package writes as jnp expressions over the
// (B, categories, classes) logit grid and differentiates with XLA. Per
// (b, category) row of `classes` logits:
//
//   g     = the Gumbel noise, or -log(-log(max(u, FLT_MIN))) of a uniform
//           draw u (what jax.random.gumbel and the port's gumbel_noise
//           compute from their uniforms)
//   pick  = argmax_j(g_j + post_j)  (NaN first, then first index on ties,
//           as jnp.argmax)
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
// Bound on the H100: launch latency and the dependent chain inside the
// launch. At the training step the inputs are three (64, 32, 32) fp32 grids,
// 0.8 MB. Design: one block per sample b; a row is held in registers by a
// group of 8 lanes, 4 classes a lane (the hulc plan's 32 classes in one
// chunk, one 16-byte load per input array and lane, a 16-byte store). Each
// row's independent reductions share shuffle rounds: the argmax pair with
// both maxima, then both sums, then the KL (the backward: its three sums),
// 3 rounds each at 8 lanes. A row wider than 32 classes is walked in chunks
// of 32 and reloaded for each pass; any (batch, categories, classes) and
// any alignment run (16-byte accesses only where every row is aligned).
// The per-category KLs of a sample meet in shared memory and are summed in
// a fixed order, with no atomics.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;                   // lanes per (b, category) row
constexpr int kPerLane = 4;                 // classes per lane and chunk
constexpr int kChunk = kGroup * kPerLane;   // 32 classes
constexpr int kMaxGroups = 32;              // rows in flight per block: 256 threads

// The lanes of this thread's row group, for shuffles that stay inside it.
__device__ __forceinline__ unsigned group_mask() {
  return 0xffu << ((threadIdx.x & 31) & ~(kGroup - 1));
}

// (a, ia) before (b, ib) in argmax's order (torch's and jnp's): NaN above
// every number, then the larger value, then the lower index. A strict total
// order, so every lane of a row group ends with the same pick.
__device__ __forceinline__ bool ahead(float a, int ia, float b, int ib) {
  const bool a_nan = isnan(a), b_nan = isnan(b);  // bitwise: no branch on the chain
  return (a > b) | (a_nan & !b_nan) | (((a == b) | (a_nan & b_nan)) & (ia < ib));
}

// Classes j0 .. j0 + 3 of a row; slots past the row get `fill`. With `vec`
// (classes % 4 == 0 and every row 16-byte aligned) the four are valid or
// none, and one 16-byte load reads them.
__device__ __forceinline__ void load4(const float* __restrict__ row, int j0, int classes, bool vec,
                                      float (&out)[kPerLane], float fill) {
  if (vec) {
    if (j0 < classes) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row + j0));
      out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
    } else {
      for (int t = 0; t < kPerLane; ++t) out[t] = fill;
    }
    return;
  }
  for (int t = 0; t < kPerLane; ++t) out[t] = j0 + t < classes ? __ldg(row + j0 + t) : fill;
}

__device__ __forceinline__ void store4(float* __restrict__ row, int j0, int classes, bool vec,
                                       const float (&v)[kPerLane]) {
  if (vec) {
    if (j0 < classes) *reinterpret_cast<float4*>(row + j0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int t = 0; t < kPerLane; ++t)
    if (j0 + t < classes) row[j0 + t] = v[t];
}

// -log(-log(u)) with u clamped at the smallest normal float: gumbel_noise's
// clamp_min, log, neg, log, neg, each rounded as PyTorch rounds them.
__device__ __forceinline__ float gumbel_of_uniform(float u) { return -logf(-logf(fmaxf(u, FLT_MIN))); }

template <bool kOneChunk>
__global__ void __launch_bounds__(kGroup * kMaxGroups)
plan_st_kl_fwd_kernel(const float* __restrict__ post, const float* __restrict__ prior,
                      const float* __restrict__ noise, float* __restrict__ st, float* __restrict__ kl_out,
                      int cats, int classes, bool vec, bool noise_is_uniform, float alpha,
                      float one_minus_alpha) {
  __shared__ float group_kl[kMaxGroups];
  const int b = blockIdx.x;
  const int group = threadIdx.x / kGroup, sub = threadIdx.x % kGroup, n_groups = blockDim.x / kGroup;
  const unsigned mask = group_mask();
  const int n_chunks = kOneChunk ? 1 : (classes + kChunk - 1) / kChunk;
  float kl_acc = 0.0f;
  for (int cat = group; cat < cats; cat += n_groups) {
    const long long base = (static_cast<long long>(b) * cats + cat) * classes;
    const float *x_row = post + base, *y_row = prior + base, *g_row = noise + base;
    float x[kPerLane], y[kPerLane], g[kPerLane], ex[kPerLane];
    auto load = [&](int j0) {
      load4(x_row, j0, classes, vec, x, -INFINITY);
      load4(y_row, j0, classes, vec, y, -INFINITY);
      load4(g_row, j0, classes, vec, g, 0.5f);
      if (noise_is_uniform)
        for (int t = 0; t < kPerLane; ++t) g[t] = gumbel_of_uniform(g[t]);
    };
    if (kOneChunk) load(sub * kPerLane);

    // pass 1: the pick and both maxima, in one set of rounds
    float best = -INFINITY, xm = -INFINITY, ym = -INFINITY;
    int best_j = INT_MAX;
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = c * kChunk + sub * kPerLane;
      if (!kOneChunk) load(j0);
      for (int t = 0; t < kPerLane; ++t) {
        if (j0 + t >= classes) break;
        const float v = g[t] + x[t];
        if (ahead(v, j0 + t, best, best_j)) best = v, best_j = j0 + t;
        xm = fmaxf(xm, x[t]);
        ym = fmaxf(ym, y[t]);
      }
    }
    for (int offset = kGroup / 2; offset > 0; offset >>= 1) {
      const float ob = __shfl_xor_sync(mask, best, offset);
      const int oj = __shfl_xor_sync(mask, best_j, offset);
      const float oxm = __shfl_xor_sync(mask, xm, offset);
      const float oym = __shfl_xor_sync(mask, ym, offset);
      if (ahead(ob, oj, best, best_j)) best = ob, best_j = oj;
      xm = fmaxf(xm, oxm);
      ym = fmaxf(ym, oym);
    }

    // pass 2: both sums
    float xs = 0.0f, ys = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = c * kChunk + sub * kPerLane;
      if (!kOneChunk) load(j0);
      for (int t = 0; t < kPerLane; ++t) {
        ex[t] = expf(x[t] - xm);
        if (j0 + t < classes) {
          xs += ex[t];
          ys += expf(y[t] - ym);
        }
      }
    }
    for (int offset = kGroup / 2; offset > 0; offset >>= 1) {
      const float oxs = __shfl_xor_sync(mask, xs, offset);
      const float oys = __shfl_xor_sync(mask, ys, offset);
      xs += oxs;
      ys += oys;
    }

    // pass 3: the KL and the straight-through value
    const float post_log_sum = logf(xs), prior_log_sum = logf(ys);
    float kl = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = c * kChunk + sub * kPerLane;
      if (!kOneChunk) {
        load(j0);
        for (int t = 0; t < kPerLane; ++t) ex[t] = expf(x[t] - xm);
      }
      float out[kPerLane];
      for (int t = 0; t < kPerLane; ++t) {
        const float p = ex[t] / xs;
        out[t] = __fsub_rn(__fadd_rn(j0 + t == best_j ? 1.0f : 0.0f, p), p);
        if (j0 + t < classes) {
          const float lp = (x[t] - xm) - post_log_sum;
          const float lq = (y[t] - ym) - prior_log_sum;
          kl += expf(lp) * (lp - lq);
        }
      }
      store4(st + base, j0, classes, vec, out);
    }
    for (int offset = kGroup / 2; offset > 0; offset >>= 1) kl += __shfl_xor_sync(mask, kl, offset);
    kl_acc += kl;
  }
  if (sub == 0) group_kl[group] = kl_acc;
  __syncthreads();
  if (threadIdx.x < 32) {  // the groups' KLs, in a fixed order
    float kl = static_cast<int>(threadIdx.x) < n_groups ? group_kl[threadIdx.x] : 0.0f;
    for (int offset = 16; offset > 0; offset >>= 1) kl += __shfl_xor_sync(0xffffffffu, kl, offset);
    if (threadIdx.x == 0) kl_out[b] = alpha * kl + one_minus_alpha * kl;
  }
}

template <bool kOneChunk>
__global__ void __launch_bounds__(kGroup * kMaxGroups)
plan_st_kl_bwd_kernel(const float* __restrict__ post, const float* __restrict__ prior,
                      const float* __restrict__ d_st, const float* __restrict__ d_kl,
                      float* __restrict__ d_post, float* __restrict__ d_prior, int cats, int classes,
                      bool vec, float alpha, float one_minus_alpha) {
  const int b = blockIdx.x;
  const int group = threadIdx.x / kGroup, sub = threadIdx.x % kGroup, n_groups = blockDim.x / kGroup;
  const unsigned mask = group_mask();
  const int n_chunks = kOneChunk ? 1 : (classes + kChunk - 1) / kChunk;
  const float c_post = one_minus_alpha * d_kl[b];  // KL(post || sg(prior))
  const float c_prior = alpha * d_kl[b];           // KL(sg(post) || prior)
  for (int cat = group; cat < cats; cat += n_groups) {
    const long long base = (static_cast<long long>(b) * cats + cat) * classes;
    const float *x_row = post + base, *y_row = prior + base, *g_row = d_st + base;
    float x[kPerLane], y[kPerLane], g[kPerLane];
    auto load = [&](int j0) {
      load4(x_row, j0, classes, vec, x, -INFINITY);
      load4(y_row, j0, classes, vec, y, -INFINITY);
      load4(g_row, j0, classes, vec, g, 0.0f);
    };
    if (kOneChunk) load(sub * kPerLane);

    float xm = -INFINITY, ym = -INFINITY;
    for (int c = 0; c < n_chunks; ++c) {
      if (!kOneChunk) load(c * kChunk + sub * kPerLane);
      for (int t = 0; t < kPerLane; ++t) {
        xm = fmaxf(xm, x[t]);
        ym = fmaxf(ym, y[t]);
      }
    }
    for (int offset = kGroup / 2; offset > 0; offset >>= 1) {
      const float oxm = __shfl_xor_sync(mask, xm, offset);
      const float oym = __shfl_xor_sync(mask, ym, offset);
      xm = fmaxf(xm, oxm);
      ym = fmaxf(ym, oym);
    }
    float xs = 0.0f, ys = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = c * kChunk + sub * kPerLane;
      if (!kOneChunk) load(j0);
      for (int t = 0; t < kPerLane; ++t) {
        if (j0 + t < classes) {
          xs += expf(x[t] - xm);
          ys += expf(y[t] - ym);
        }
      }
    }
    for (int offset = kGroup / 2; offset > 0; offset >>= 1) {
      const float oxs = __shfl_xor_sync(mask, xs, offset);
      const float oys = __shfl_xor_sync(mask, ys, offset);
      xs += oxs;
      ys += oys;
    }
    const float post_log_sum = logf(xs), prior_log_sum = logf(ys);
    // per class: lp, lq, p = exp(lp) and the softmax value
    auto terms = [&](int t, float& lp, float& lq, float& p, float& soft) {
      lp = (x[t] - xm) - post_log_sum;
      lq = (y[t] - ym) - prior_log_sum;
      p = expf(lp);
      soft = expf(x[t] - xm) / xs;
    };
    // <p, d_st> for the softmax's backward; the sums the two log-softmax
    // backwards subtract: sum_j p_j (lp_j - lq_j + 1) and sum_j -p_j
    float dot = 0.0f, g_lp_sum = 0.0f, g_lq_sum = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = c * kChunk + sub * kPerLane;
      if (!kOneChunk) load(j0);
      for (int t = 0; t < kPerLane; ++t) {
        if (j0 + t >= classes) break;
        float lp, lq, p, soft;
        terms(t, lp, lq, p, soft);
        dot += soft * g[t];
        g_lp_sum += p * (lp - lq) + p;
        g_lq_sum += -p;
      }
    }
    for (int offset = kGroup / 2; offset > 0; offset >>= 1) {
      const float od = __shfl_xor_sync(mask, dot, offset);
      const float olp = __shfl_xor_sync(mask, g_lp_sum, offset);
      const float olq = __shfl_xor_sync(mask, g_lq_sum, offset);
      dot += od;
      g_lp_sum += olp;
      g_lq_sum += olq;
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = c * kChunk + sub * kPerLane;
      if (!kOneChunk) load(j0);
      float dp[kPerLane], dq[kPerLane];
      for (int t = 0; t < kPerLane; ++t) {
        float lp, lq, p, soft;
        terms(t, lp, lq, p, soft);
        const float g_lp = p * (lp - lq) + p;
        dp[t] = soft * (g[t] - dot) + c_post * (g_lp - p * g_lp_sum);
        dq[t] = c_prior * (-p - expf(lq) * g_lq_sum);
      }
      store4(d_post + base, j0, classes, vec, dp);
      store4(d_prior + base, j0, classes, vec, dq);
    }
  }
}

int block_threads(int cats) {
  const int groups = cats < kMaxGroups ? (cats > 0 ? cats : 1) : kMaxGroups;
  return (groups * kGroup + 31) / 32 * 32;
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int hulc_plan_st_kl_fwd(const void* post, const void* prior, const void* noise, void* st,
                                   void* kl, long long batch, int cats, int classes, int noise_is_uniform,
                                   float alpha, float one_minus_alpha, void* stream) {
  if (batch > 0) {
    const bool vec = classes % 4 == 0 && aligned16(post) && aligned16(prior) && aligned16(noise) &&
                     aligned16(st);
    const auto kernel = classes <= kChunk ? plan_st_kl_fwd_kernel<true> : plan_st_kl_fwd_kernel<false>;
    kernel<<<static_cast<unsigned int>(batch), block_threads(cats), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(post), static_cast<const float*>(prior), static_cast<const float*>(noise),
        static_cast<float*>(st), static_cast<float*>(kl), cats, classes, vec, noise_is_uniform != 0, alpha,
        one_minus_alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hulc_plan_st_kl_bwd(const void* post, const void* prior, const void* d_st,
                                   const void* d_kl, void* d_post, void* d_prior,
                                   long long batch, int cats, int classes, float alpha,
                                   float one_minus_alpha, void* stream) {
  if (batch > 0) {
    const bool vec = classes % 4 == 0 && aligned16(post) && aligned16(prior) && aligned16(d_st) &&
                     aligned16(d_post) && aligned16(d_prior);
    const auto kernel = classes <= kChunk ? plan_st_kl_bwd_kernel<true> : plan_st_kl_bwd_kernel<false>;
    kernel<<<static_cast<unsigned int>(batch), block_threads(cats), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(post), static_cast<const float*>(prior), static_cast<const float*>(d_st),
        static_cast<const float*>(d_kl), static_cast<float*>(d_post), static_cast<float*>(d_prior), cats,
        classes, vec, alpha, one_minus_alpha);
  }
  return static_cast<int>(cudaGetLastError());
}
