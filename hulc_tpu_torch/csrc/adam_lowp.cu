// Adam with bf16-stored moments, and the global norm of the gradients it
// reads: one launch over every parameter tensor, then one one-block launch.
//
// hulc_adam_lowp replaces hulc_tpu/training/optimizers.py scale_by_adam_lowp
// (lines 24-73) chained with optax.scale_by_learning_rate, which the JAX
// package runs as one XLA fusion per parameter leaf. Per element, in fp32
// and in the optax order:
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
// plain PyTorch version's, whether an element goes through the 4-wide or the
// scalar path (both call adam_element).
//
// The same pass also writes each block's sum of g^2 (fp64) to `partials`;
// hulc_grad_norm_finish sums them into sqrt(sum g^2). That replaces
// hulc_tpu/training/trainer.py:258, optax.global_norm(grads), which XLA fuses
// into the JAX step; the port's eager version (training/optimizers.py
// global_norm) launches three kernels per tensor. No atomics: which elements
// a block sums, and in what order, depends only on the table, and the finish
// reads the partials in a fixed order, so two launches give the same bits.
//
// Bound on the H100: bytes. Each element reads p, g (fp32) and m, v (bf16)
// and writes p, m, v: 20 bytes. For the hulc model's 47,053,559 parameters
// that is 0.94 GB, 0.281 ms at 3.35 TB/s; the norm adds only the partials
// (8 bytes a block). B.7 alone would read the 188 MB of gradients, 0.056 ms.
//
// Design (the first one found each 16,384-element chunk's tensor by a
// binary search of the table in device memory and moved 4- and 2-byte
// scalars):
//   * the wrapper builds a table once per set of parameters and moments
//     (addresses and sizes) and keeps it on the device: one row per tensor
//     (p, m, v, numel, head, first block), then one entry per block, the
//     index of its tensor's row. Each tensor has its own range of blocks of
//     `elems_per_block` elements, so a block never straddles two tensors
//     and a block finds its row with two loads, no search. The gradients'
//     addresses change from step to step (autograd allocates them anew), so
//     they are not in the table: each launch takes them by value, up to
//     kMaxGrads in its parameters (`__grid_constant__`, read in place), and
//     a step uploads nothing (a column of them uploaded from pinned memory
//     with each launch held the stream about 0.13 ms a step on the H100);
//   * 16-byte loads and stores of p and g (4 fp32), 8-byte ones of m and v
//     (4 bf16), four such groups a thread in flight. The wrapper takes only
//     tensors whose four arrays sit at one phase modulo 4 elements (always
//     so for PyTorch's own allocations); `head` (0-3) scalar elements come
//     first so that the groups are aligned, and the last block takes a
//     scalar tail of fewer than 4;
//   * a null g is a zero gradient (a parameter without one); it is not read;
//   * each thread sums g^2 in fp64 over its elements in a fixed order, the
//     warp by fixed shuffles, the block's eight warp sums in index order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

const int kThreads = 256;
const int kWarps = kThreads / 32;
const int kGroups = 4;  // 4-element groups a thread has in flight
const int kRowCols = 6;  // p, m, v, numel, head, first block
const int kMaxGrads = 448;  // gradient pointers a launch takes by value: 3,584 of the 4,096 parameter bytes
const int kFinishThreads = 1024;

struct AdamConsts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, neg_lr, c1, c2;
};

// the gradients of rows [row_begin, row_begin + n) of the table; null: none
struct GradPointers {
  const float* g[kMaxGrads];
};

// One element's update in the optax order; m and v in and out as fp32.
// Where m' is zero, u is m' itself, as IEEE rounds (0 / c1) / (sqrt(v' / c2)
// + eps) for c1, c2, eps > 0 (the sign of the zero kept); the division and
// square root would reach it through their special-operand path, slowly. In
// the train step half of the gradients are exactly zero (parameters the loss
// does not reach), and so are their moments.
__device__ __forceinline__ void adam_element(float& p, float g, float& m, float& v, const AdamConsts& k) {
  const float m1 = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(k.one_minus_b1, g));
  const float v1 = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(k.one_minus_b2, __fmul_rn(g, g)));
  const float u = m1 == 0.0f ? m1 : __fdiv_rn(__fdiv_rn(m1, k.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, k.c2)), k.eps));
  p = __fadd_rn(p, __fmul_rn(k.neg_lr, u));
  m = m1;
  v = v1;
}

__device__ __forceinline__ void add_square(double& acc, float g) {
  const double d = static_cast<double>(g);
  acc = __fma_rn(d, d, acc);
}

__device__ __forceinline__ void update_scalar(float* p, const float* g, __nv_bfloat16* m, __nv_bfloat16* v,
                                              long long i, const AdamConsts& k, double& acc) {
  const float gi = g != nullptr ? g[i] : 0.0f;
  float pi = p[i], mi = __bfloat162float(m[i]), vi = __bfloat162float(v[i]);
  adam_element(pi, gi, mi, vi, k);
  p[i] = pi;
  m[i] = __float2bfloat16_rn(mi);
  v[i] = __float2bfloat16_rn(vi);
  add_square(acc, gi);
}

// 4 bf16 in 8 bytes (element 0 in the low half of .x) to fp32 and back
__device__ __forceinline__ void unpack4(uint2 raw, float* out) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(lo);
  out[1] = __high2float(lo);
  out[2] = __low2float(hi);
  out[3] = __high2float(hi);
}

__device__ __forceinline__ uint2 pack4(const float* in) {
  const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(in[0]), __float2bfloat16_rn(in[1]));
  const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(in[2]), __float2bfloat16_rn(in[3]));
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  return raw;
}

// The tensor's element range of its block j of nb: [0 or head + j E, numel
// or head + (j + 1) E), so block 0 also takes the head and the last block
// the tail. Mirrored by training/optimizers.py block_ranges.
// Block blockIdx.x of a launch is block block_begin + blockIdx.x of the
// table's plan, and writes that entry of `partials`.
__global__ void __launch_bounds__(kThreads) adam_lowp_kernel(const long long* __restrict__ table, int n_tensors,
                                                             int row_begin, long long block_begin,
                                                             long long elems_per_block, double* __restrict__ partials,
                                                             AdamConsts k, const __grid_constant__ GradPointers grads) {
  const long long b = block_begin + blockIdx.x;
  const long long r = __ldg(table + kRowCols * n_tensors + b);
  const long long* row = table + kRowCols * r;
  float* p = reinterpret_cast<float*>(__ldg(row + 0));
  const float* g = grads.g[r - row_begin];
  __nv_bfloat16* m = reinterpret_cast<__nv_bfloat16*>(__ldg(row + 1));
  __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(__ldg(row + 2));
  const long long numel = __ldg(row + 3), head = __ldg(row + 4);
  const long long j = b - __ldg(row + 5);
  const long long groups = (numel - head) / 4;
  const long long nb = groups > 0 ? (4 * groups + elems_per_block - 1) / elems_per_block : 1;
  const bool last = j == nb - 1;
  double acc = 0.0;

  if (j == 0 && threadIdx.x < head) update_scalar(p, g, m, v, threadIdx.x, k, acc);
  float4* p4 = reinterpret_cast<float4*>(p + head);
  const float4* g4 = g != nullptr ? reinterpret_cast<const float4*>(g + head) : nullptr;
  uint2* m4 = reinterpret_cast<uint2*>(m + head);
  uint2* v4 = reinterpret_cast<uint2*>(v + head);
  const long long q_begin = j * (elems_per_block / 4);
  const long long q_end = last ? groups : q_begin + elems_per_block / 4;
  for (long long q = q_begin + threadIdx.x; q < q_end; q += kGroups * kThreads) {
    float4 pv[kGroups], gv[kGroups];
    uint2 mv[kGroups], vv[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long qq = q + u * kThreads;
      if (qq < q_end) {
        pv[u] = p4[qq];
        gv[u] = g4 != nullptr ? __ldcs(g4 + qq) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        mv[u] = m4[qq];
        vv[u] = v4[qq];
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long qq = q + u * kThreads;
      if (qq < q_end) {
        float ps[4] = {pv[u].x, pv[u].y, pv[u].z, pv[u].w};
        const float gs[4] = {gv[u].x, gv[u].y, gv[u].z, gv[u].w};
        float ms[4], vs[4];
        unpack4(mv[u], ms);
        unpack4(vv[u], vs);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          adam_element(ps[e], gs[e], ms[e], vs[e], k);
          add_square(acc, gs[e]);
        }
        p4[qq] = make_float4(ps[0], ps[1], ps[2], ps[3]);
        m4[qq] = pack4(ms);
        v4[qq] = pack4(vs);
      }
    }
  }
  if (last) {
    const long long i = head + 4 * groups + threadIdx.x;
    if (i < numel) update_scalar(p, g, m, v, i, k, acc);
  }

  // the block's sum of g^2: fixed shuffles, then the warps in index order
  __shared__ double warp_sums[kWarps];
  for (int offset = 16; offset > 0; offset >>= 1) acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, offset));
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = warp_sums[0];
    for (int w = 1; w < kWarps; ++w) sum = __dadd_rn(sum, warp_sums[w]);
    partials[b] = sum;
  }
}

// sqrt of the sum of n partials, in fp64: thread t sums its contiguous
// share of ceil(n / kFinishThreads) partials in index order, then the
// threads' sums go by fixed shuffles and the warps' in index order.
// Mirrored by training/optimizers.py grad_norm_finish_plain.
__global__ void __launch_bounds__(kFinishThreads) grad_norm_finish_kernel(const double* __restrict__ partials,
                                                                          long long n, float* __restrict__ out) {
  const long long share = (n + kFinishThreads - 1) / kFinishThreads;
  const long long begin = threadIdx.x * share;
  const long long end = begin + share < n ? begin + share : n;
  double acc = 0.0;
  for (long long i = begin; i < end; ++i) acc = __dadd_rn(acc, partials[i]);
  __shared__ double warp_sums[kFinishThreads / 32];
  for (int offset = 16; offset > 0; offset >>= 1) acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, offset));
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = warp_sums[0];
    for (int w = 1; w < kFinishThreads / 32; ++w) sum = __dadd_rn(sum, warp_sums[w]);
    out[0] = __double2float_rn(__dsqrt_rn(sum));
  }
}

}  // namespace

// table (device): n_tensors rows of kRowCols int64, then one int64 row
// index per block of the plan. One launch updates rows [row_begin,
// row_begin + n_rows), which own the plan's blocks [block_begin,
// block_begin + n_blocks); grad_ptrs (host) holds their n_rows gradient
// addresses (0: no gradient). partials (device): one fp64 per block of the
// plan.
extern "C" int hulc_adam_lowp(const void* table, int n_tensors, int row_begin, int n_rows, long long block_begin,
                              long long n_blocks, long long elems_per_block, void* partials,
                              const long long* grad_ptrs, float b1, float one_minus_b1, float b2, float one_minus_b2,
                              float eps, float neg_lr, float c1, float c2, void* stream) {
  if (elems_per_block <= 0 || elems_per_block % 4 != 0 || n_blocks > 0x7fffffffLL || n_rows > kMaxGrads ||
      n_rows < 0 || row_begin < 0 || row_begin + n_rows > n_tensors || block_begin < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0 && n_blocks > 0) {
    AdamConsts k{b1, one_minus_b1, b2, one_minus_b2, eps, neg_lr, c1, c2};
    GradPointers grads{};
    for (int i = 0; i < n_rows; ++i) grads.g[i] = reinterpret_cast<const float*>(grad_ptrs[i]);
    adam_lowp_kernel<<<static_cast<unsigned int>(n_blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(table), n_tensors, row_begin, block_begin, elems_per_block,
        static_cast<double*>(partials), k, grads);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: one fp32, sqrt of the sum of the n_partials fp64 partials (0 when
// there are none).
extern "C" int hulc_grad_norm_finish(const void* partials, long long n_partials, void* out, void* stream) {
  if (n_partials < 0) return static_cast<int>(cudaErrorInvalidValue);
  grad_norm_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partials), n_partials, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
