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
// outputs: dx_ij = p_ij / T * (g_x * (lin_h[i] - E_x) + g_y * (lin_w[j] - E_y)).
// Bound on the H100: bytes, the map read once and dx written once; at the
// training step's (2048, 64, 21, 21) fp32 that is 2 x 231 MB, about 0.14 ms.
// Design: one warp per row, as the forward. It recomputes the max and the
// three sums from the saved input (cheaper than saving p: the input is
// already kept for the convolution's backward), then writes dx in a third
// pass over the row, which is still in L1. Only a fixed temperature has a
// backward here (the wrapper refuses a learnable one).

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

__global__ void spatial_softmax_bwd_kernel(const float* __restrict__ x,
                                           const float* __restrict__ grad_out,
                                           float* __restrict__ dx, long long rows, int c, int h,
                                           int w, float temp) {
  long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int hw = h * w;
  const float* z = x + row * hw;
  float* d = dx + row * hw;
  long long n = row / c;
  int ch = static_cast<int>(row - n * c);
  const float gx = grad_out[n * 2 * c + 2 * ch];
  const float gy = grad_out[n * 2 * c + 2 * ch + 1];

  float m = -INFINITY;
  for (int i = lane; i < hw; i += 32) m = fmaxf(m, z[i] / temp);
  m = warp_max(m);

  float s = 0.0f, sx = 0.0f, sy = 0.0f;
  for (int i = lane; i < hw; i += 32) {
    float e = expf(z[i] / temp - m);
    int r = i / w;
    s += e;
    sx += e * linspace_pm1(r, h);
    sy += e * linspace_pm1(i - r * w, w);
  }
  s = warp_sum(s);
  const float ex = warp_sum(sx) / s;
  const float ey = warp_sum(sy) / s;

  for (int i = lane; i < hw; i += 32) {
    float p = expf(z[i] / temp - m) / s;
    int r = i / w;
    float g = gx * (linspace_pm1(r, h) - ex) + gy * (linspace_pm1(i - r * w, w) - ey);
    d[i] = p * g / temp;
  }
}

}  // namespace

extern "C" int hulc_spatial_softmax_bwd(const void* x, const void* grad_out, void* dx,
                                        long long n, int c, int h, int w, float temp,
                                        void* stream) {
  long long rows = n * c;
  if (rows > 0) {
    const int threads = 256;  // 8 rows per block
    long long blocks = (rows * 32 + threads - 1) / threads;
    spatial_softmax_bwd_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(grad_out),
        static_cast<float*>(dx), rows, c, h, w, temp);
  }
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
