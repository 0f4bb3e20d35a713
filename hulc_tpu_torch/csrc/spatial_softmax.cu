// SpatialSoftmax forward: expected keypoint coordinates per feature map.
//
// Replaces hulc_tpu/models/vision.py SpatialSoftmax.__call__ (lines 38-75),
// which the JAX package writes as fused XLA reduces over the NHWC map. For
// each (n, c) row of H*W logits: z = x / temperature, a max-subtracted fp32
// softmax, then the expectation of a linspace(-1, 1) grid. As in the
// reference, x is weighted by the ROW index and y by the COLUMN index (the
// grid quirk of vision_network.py; square maps only), and the output is
// interleaved: out[n, 2c] = x, out[n, 2c + 1] = y.
//
// Bound on the H100: bytes (each logit is read once and costs ~9 flops),
// 64 lanes x 64 channels x 21 x 21 fp32 = 7.2 MB, about 2.2 us at 3.35 TB/s;
// at that size and below, launch latency dominates. Design: one warp per
// row, lanes striding over the 441 logits so each load instruction of the
// warp is contiguous; pass one finds the max, pass two (reading the row
// again, from L1) accumulates sum(e), sum(e * row_coord) and
// sum(e * col_coord) in fp32, and warp shuffles reduce both passes. The
// temperature is read from device memory when it is a learnable parameter.
//
// hulc_spatial_softmax_bwd is its backward, which the JAX package leaves to
// XLA's autodiff of the same reduces. With p the row's softmax, E_x and E_y
// the two expectations and (g_x, g_y) the incoming gradient of the row's two
// outputs: dx_ij = p_ij / T * (g_x * (lin_h[i] - E_x) + g_y * (lin_w[j] - E_y)),
// and for a learnable temperature dT = -(1/T) * sum over rows and ij of
// x_ij * dx_ij.
//
// Bound on the H100: bytes, the map read once and dx written once; at the
// training step's (2048, 64, 21, 21) fp32 that is 2 x 231 MB, 0.1383 ms.
// The first design (one warp per 441-float row with lanes striding 4-byte
// loads, three passes that counted on L1 to keep the row, and per element
// two expf, five IEEE divides, two integer divisions and branchy linspace
// calls) reached a fifth of that. This design:
//   * loads: a block takes kRowsPerBlock = 8 consecutive rows. Row r starts
//     at r * hw * 4 bytes, so every group of 4 rows, and so every block,
//     starts 16-byte aligned whatever hw is; the block stages its rows in
//     shared memory once with 16-byte cp.async (a tail of fewer than four
//     floats, where rows * hw is not a multiple of 4, element by element);
//   * per element: one warp per row; e = exp(x * (1/T) - max) once, kept
//     in shared memory; each element's two coordinates from a shared table
//     of the same torch.linspace values, built per block without integer
//     division; dx = e * (1/s * 1/T) * g;
//   * stores: dx goes back through shared memory as 16-byte stores;
//   * temperature: read from a device pointer when it is learnable, so the
//     caller needs no host sync. Then each warp also writes its row's
//     sum of x * dx, and a second launch of one block reduces those partials
//     in a fixed order (in fp64) to dT: no atomics, the same dT every run.

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

__global__ void spatial_softmax_kernel(const float* __restrict__ x, float* __restrict__ out,
                                       long long rows, int c, int h, int w,
                                       const float* __restrict__ temp_ptr, float temp_value) {
  long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together: rows are warp-uniform
  const float temp = temp_ptr ? *temp_ptr : temp_value;
  const int hw = h * w;
  const float* z = x + row * hw;

  float m = -INFINITY;
  for (int i = lane; i < hw; i += 32) m = fmaxf(m, z[i] / temp);
  m = warp_max(m);

  const float step_r = h > 1 ? 2.0f / (h - 1) : 0.0f;
  const float step_c = w > 1 ? 2.0f / (w - 1) : 0.0f;
  float s = 0.0f, sx = 0.0f, sy = 0.0f;
  for (int i = lane; i < hw; i += 32) {
    float e = expf(z[i] / temp - m);
    int r = i / w;
    int col = i - r * w;
    s += e;
    sx += e * (-1.0f + r * step_r);
    sy += e * (-1.0f + col * step_c);
  }
  s = warp_sum(s);
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  if (lane == 0) {
    long long n = row / c;
    int ch = static_cast<int>(row - n * c);
    out[n * 2 * c + 2 * ch] = sx / s;
    out[n * 2 * c + 2 * ch + 1] = sy / s;
  }
}

// torch.linspace(-1, 1, n)[i]: the first half counts up from -1, the second
// half down from 1, as PyTorch computes it.
__device__ __forceinline__ float linspace_pm1(int i, int n) {
  if (n == 1) return -1.0f;
  const float step = 2.0f / static_cast<float>(n - 1);
  return i < n / 2 ? __fadd_rn(-1.0f, __fmul_rn(step, static_cast<float>(i)))
                   : __fsub_rn(1.0f, __fmul_rn(step, static_cast<float>(n - 1 - i)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

constexpr int kRowsPerBlock = 8;  // two 4-row groups, so a block starts 16-byte aligned
constexpr int kBwdThreads = 32 * kRowsPerBlock;
constexpr int kReduceThreads = 1024;

// Shared memory, in floats: xs and es (kRowsPerBlock * hw each), then the
// coordinate of every element of a map, lin_r[i] = lin_h[i / w] and
// lin_c[i] = lin_w[i % w] (hw each).
__global__ void __launch_bounds__(kBwdThreads)
    spatial_softmax_bwd_kernel(const float* __restrict__ x, const float* __restrict__ grad_out,
                               float* __restrict__ dx, float* __restrict__ row_xdx, int rows,
                               int h, int w, const float* __restrict__ temp_ptr, float temp_value) {
  extern __shared__ __align__(16) float smem[];
  const int hw = h * w;
  float* xs = smem;
  float* es = xs + kRowsPerBlock * hw;
  float* lin_r = es + kRowsPerBlock * hw;
  float* lin_c = lin_r + hw;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int count = min(kRowsPerBlock, rows - row0) * hw;
  const long long first = static_cast<long long>(row0) * hw;
  const float* src = x + first;

  const int vecs = count >> 2;
  for (int i = threadIdx.x; i < vecs; i += kBwdThreads) cp_async16(xs + 4 * i, src + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = 4 * vecs + threadIdx.x; i < count; i += kBwdThreads) xs[i] = src[i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < h; r += kRowsPerBlock) {
    const float lh = linspace_pm1(r, h);
    for (int col = lane; col < w; col += 32) {
      lin_r[r * w + col] = lh;
      lin_c[r * w + col] = linspace_pm1(col, w);
    }
  }
  const float temp = temp_ptr ? *temp_ptr : temp_value;
  const float inv_t = 1.0f / temp;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int row = row0 + warp;
  if (row < rows) {
    const float* xr = xs + warp * hw;
    float* er = es + warp * hw;
    // max(x * inv_t) = max(x) * inv_t: rounding is monotone and inv_t > 0
    float m = -INFINITY;
    for (int i = lane; i < hw; i += 32) m = fmaxf(m, xr[i]);
    m = warp_max(m) * inv_t;

    float s = 0.0f, sx = 0.0f, sy = 0.0f;
    for (int i = lane; i < hw; i += 32) {
      const float e = expf(fmaf(xr[i], inv_t, -m));
      er[i] = e;
      s += e;
      sx += e * lin_r[i];
      sy += e * lin_c[i];
    }
    s = warp_sum(s);
    const float ex = warp_sum(sx) / s;
    const float ey = warp_sum(sy) / s;
    const float gx = grad_out[2 * static_cast<long long>(row)];
    const float gy = grad_out[2 * static_cast<long long>(row) + 1];
    const float scale = (1.0f / s) * inv_t;

    float xdx = 0.0f;
    for (int i = lane; i < hw; i += 32) {
      const float g = gx * (lin_r[i] - ex) + gy * (lin_c[i] - ey);
      const float d = er[i] * scale * g;
      er[i] = d;
      xdx += xr[i] * d;
    }
    if (row_xdx) {
      xdx = warp_sum(xdx);
      if (lane == 0) row_xdx[row] = xdx;
    }
  }
  __syncthreads();

  float* dst = dx + first;
  for (int i = threadIdx.x; i < vecs; i += kBwdThreads)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(es)[i];
  for (int i = 4 * vecs + threadIdx.x; i < count; i += kBwdThreads) dst[i] = es[i];
}

// dT = -(1/T) * sum of the rows' partials, in a fixed order: each thread
// sums a strided slice, then a tree in shared memory, all in fp64.
__global__ void __launch_bounds__(kReduceThreads)
    spatial_softmax_temperature_grad_kernel(const float* __restrict__ row_xdx, int rows,
                                            const float* __restrict__ temp_ptr,
                                            float* __restrict__ dtemp) {
  __shared__ double part[kReduceThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < rows; i += kReduceThreads) acc += row_xdx[i];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) part[threadIdx.x] += part[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) dtemp[0] = static_cast<float>(-part[0] / static_cast<double>(*temp_ptr));
}

}  // namespace

// With a learnable temperature (temp_ptr), row_xdx (rows floats of
// scratch) and dtemp (one float) are given too, and dT is written.
extern "C" int hulc_spatial_softmax_bwd(const void* x, const void* grad_out, void* dx,
                                        void* row_xdx, void* dtemp, long long n, int c, int h,
                                        int w, const void* temp_ptr, float temp_value,
                                        void* stream) {
  const long long rows = n * c;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (rows > 0x7fffffffLL - kRowsPerBlock || (temp_ptr && (!row_xdx || !dtemp)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hw = h * w;
  const int smem = static_cast<int>(sizeof(float)) * (2 * kRowsPerBlock + 2) * hw;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(spatial_softmax_bwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* temp = static_cast<const float*>(temp_ptr);
  const unsigned int blocks = static_cast<unsigned int>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  spatial_softmax_bwd_kernel<<<blocks, kBwdThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(grad_out), static_cast<float*>(dx),
      temp ? static_cast<float*>(row_xdx) : nullptr, static_cast<int>(rows), h, w, temp, temp_value);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !temp) return static_cast<int>(err);
  spatial_softmax_temperature_grad_kernel<<<1, kReduceThreads, 0, s>>>(
      static_cast<const float*>(row_xdx), static_cast<int>(rows), temp, static_cast<float*>(dtemp));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hulc_spatial_softmax(const void* x, void* out, long long n, int c, int h, int w,
                                    const void* temp_ptr, float temp_value, void* stream) {
  long long rows = n * c;
  if (rows > 0) {
    const int threads = 256;  // 8 rows per block
    long long blocks = (rows * 32 + threads - 1) / threads;
    spatial_softmax_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, c, h, w,
        static_cast<const float*>(temp_ptr), temp_value);
  }
  return static_cast<int>(cudaGetLastError());
}
