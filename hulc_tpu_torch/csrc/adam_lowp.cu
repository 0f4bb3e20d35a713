// Adam with bf16-stored moments: one launch over every parameter tensor.
//
// Replaces hulc_tpu/training/optimizers.py scale_by_adam_lowp (lines 24-73)
// chained with optax.scale_by_learning_rate, which the JAX package runs as
// one XLA fusion per parameter leaf. Per element, in fp32 and in the optax
// order:
//
//   m' = m * b1 + (1 - b1) * g            v' = v * b2 + (1 - b2) * (g * g)
//   u  = (m' / c1) / (sqrt(v' / c2) + eps)
//   p' = p + (-lr) * u                    m, v <- bf16(m'), bf16(v')
//
// c1 = 1 - b1^t and c2 = 1 - b2^t come from the wrapper as fp32 values,
// computed as the plain version computes them. Every operation is a
// round-to-nearest intrinsic, so nvcc does not contract a multiply-add into
// an FMA, and the bf16 write-back rounds to nearest even as
// `.to(torch.bfloat16)` does: parameters and moments are bit-equal to the
// plain PyTorch version's.
//
// Bound on the H100: bytes. Each element reads p, g (fp32) and m, v (bf16)
// and writes p, m, v: 20 bytes. For the hulc model's ~47M parameters that
// is about 0.94 GB, 0.28 ms at 3.35 TB/s. Design: the wrapper hands a
// device table of (p, g, m, v, numel, first chunk) rows, one per tensor;
// the grid has one block per chunk of `chunk` elements over all tensors, and
// each block finds its tensor by a binary search of the first-chunk column.
// So one launch covers the whole model, whatever the number of tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

const int kThreads = 256;

struct AdamConsts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, neg_lr, c1, c2;
};

// table: n_tensors rows of 6 int64: p, g, m, v (addresses), numel, first chunk
__global__ void adam_lowp_kernel(const long long* __restrict__ table, int n_tensors,
                                 long long chunk_elems, AdamConsts k) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[6 * mid + 5] <= chunk) lo = mid; else hi = mid - 1;
  }
  const long long* row = table + 6 * lo;
  float* p = reinterpret_cast<float*>(row[0]);
  const float* g = reinterpret_cast<const float*>(row[1]);
  __nv_bfloat16* m = reinterpret_cast<__nv_bfloat16*>(row[2]);
  __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(row[3]);
  const long long numel = row[4];
  const long long begin = (chunk - row[5]) * chunk_elems;
  const long long end = begin + chunk_elems < numel ? begin + chunk_elems : numel;
  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const float gi = g[i];
    const float m1 = __fadd_rn(__fmul_rn(__bfloat162float(m[i]), k.b1), __fmul_rn(k.one_minus_b1, gi));
    const float v1 = __fadd_rn(__fmul_rn(__bfloat162float(v[i]), k.b2),
                               __fmul_rn(k.one_minus_b2, __fmul_rn(gi, gi)));
    const float u = __fdiv_rn(__fdiv_rn(m1, k.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, k.c2)), k.eps));
    p[i] = __fadd_rn(p[i], __fmul_rn(k.neg_lr, u));
    m[i] = __float2bfloat16_rn(m1);
    v[i] = __float2bfloat16_rn(v1);
  }
}

}  // namespace

extern "C" int hulc_adam_lowp(const void* table, int n_tensors, long long n_chunks,
                              long long chunk_elems, float b1,
                              float one_minus_b1, float b2, float one_minus_b2, float eps,
                              float neg_lr, float c1, float c2, void* stream) {
  if (n_tensors > 0 && n_chunks > 0) {
    AdamConsts k{b1, one_minus_b1, b2, one_minus_b2, eps, neg_lr, c1, c2};
    adam_lowp_kernel<<<static_cast<unsigned int>(n_chunks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(table), n_tensors, chunk_elems, k);
  }
  return static_cast<int>(cudaGetLastError());
}
