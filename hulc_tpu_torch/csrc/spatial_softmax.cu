// SpatialSoftmax forward: expected keypoint coordinates per feature map.
//
// Replaces hulc_tpu/models/vision.py SpatialSoftmax.__call__ (lines 38-75),
// which the JAX package writes as fused XLA reduces over the NHWC map. For
// each (n, c) row of H*W logits: z = x / temperature, a max-subtracted fp32
// softmax, then the expectation of a linspace(-1, 1) grid. As in the
// reference, x is weighted by the ROW index and y by the COLUMN index (the
// grid quirk of vision_network.py; square maps only), and the output is
// interleaved: out[n, 2c] = x, out[n, 2c + 1] = y, i.e. out[2 * row] and
// out[2 * row + 1] for row = n * C + c.
//
// Bound on the H100: bytes, the map read once; at the training step's
// (2048, 64, 21, 21) fp32 that is 231 MB, 0.0693 ms at 3.35 TB/s, and at
// the 64-lane policy's (64, 64, 21, 21) 7.2 MB, 0.0022 ms, where launch
// latency weighs as much. The first design (one warp per 441-float row,
// lanes striding 4-byte loads, a second pass over global memory that
// counted on L1, two IEEE divides and an integer division per element,
// coordinates -1 + r * step that differ by an ulp from torch.linspace's for
// the second half of the grid) reached a fifth of that at the step's shape.
// This design shares the backward's row handling (the helpers below):
//   * loads: a block takes kRowsPerBlock = 8 consecutive rows. Row r starts
//     at r * hw * 4 bytes, so every group of 4 rows, and so every block,
//     starts 16-byte aligned whatever hw is; the block stages its rows in
//     shared memory once with 16-byte cp.async (a tail of fewer than four
//     floats, where rows * hw is not a multiple of 4, element by element);
//     each logit is read from device memory once;
//   * per element: one warp per row; the max over raw x, scaled by 1/T
//     (exact for T > 0: rounding is monotone); e = exp(x * (1/T) - max);
//     the two coordinates from a per-block table of torch.linspace's values,
//     built without integer division; no divide. The forward and the
//     backward compute e and the coordinates by the same code
//     (softmax_moments), so the p the backward recomputes is the p the
//     forward used;
//   * stores: one float2 per row.
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
//   * loads and per element: as the forward's, with e kept in shared memory;
//     dx = e * (1/s * 1/T) * g;
//   * stores: dx goes back through shared memory as 16-byte stores;
//   * temperature: read from a device pointer when it is learnable, so the
//     caller needs no host sync. Then each warp also writes its row's
//     sum of x * dx, and a second launch of one block reduces those partials
//     in a fixed order (in fp64) to dT: no atomics, the same dT every run.
//
// bf16 instances (B.14): a bf16 model's SpatialSoftmax reads the bf16 conv
// map (hulc_tpu/models/vision.py:66 computes on x.astype(float32)), so each
// kernel is a template on the map's element type, float or __nv_bfloat16,
// with an extern "C" launcher for each instance (the _bf16 ones). A bf16
// row is converted to fp32 in registers as it is read from shared memory;
// the max, exp and sums are the fp32 instance's, in the same order; the
// keypoints stay fp32. The backward writes dx in bf16, the fp32 value
// rounded once (the transpose of JAX's convert), and dT from the fp32 dx.
// Staging is by the block, not by the row: 8 rows of bf16 are 16 * hw
// bytes, so a block starts 16-byte aligned, while a 441-element row (882 B)
// does not. The bound halves with the bytes: at the step's (2048, 64, 21,
// 21) bf16 the forward reads 115.6 MB (0.0345 ms at 3.35 TB/s), the
// backward reads and writes 231.2 MB (0.069 ms).

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;  // two 4-row groups, so a block starts 16-byte aligned
constexpr int kThreads = 32 * kRowsPerBlock;  // one warp per row
constexpr int kReduceThreads = 1024;

__device__ __forceinline__ float warp_max(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Copy the block's rows [row0, row0 + kRowsPerBlock) of x (fewer at the
// end) into xs: 16-byte cp.async for the body (4 floats or 8 bf16 a copy),
// committed as one group, the last elements that fill no 16 bytes one by
// one. Returns the number of elements.
template <typename T>
__device__ __forceinline__ int stage_rows(T* xs, const T* __restrict__ x, int row0, int rows, int hw) {
  constexpr int kVec = 16 / sizeof(T);
  const int count = min(kRowsPerBlock, rows - row0) * hw;
  const T* src = x + static_cast<long long>(row0) * hw;
  const int vecs = count / kVec;
  for (int i = threadIdx.x; i < vecs; i += kThreads) cp_async16(xs + kVec * i, src + kVec * i);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = kVec * vecs + threadIdx.x; i < count; i += kThreads) xs[i] = src[i];
  return count;
}

// The coordinate of every element of a map: lin_r[i] = lin_h[i / w] and
// lin_c[i] = lin_w[i % w], walked by row and column (no integer division).
__device__ __forceinline__ void coordinate_tables(float* lin_r, float* lin_c, int h, int w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < h; r += kRowsPerBlock) {
    const float lh = linspace_pm1(r, h);
    for (int col = lane; col < w; col += 32) {
      lin_r[r * w + col] = lh;
      lin_c[r * w + col] = linspace_pm1(col, w);
    }
  }
}

struct Moments {
  float s, sx, sy;  // sum(e), sum(e * lin_r), sum(e * lin_c) over the row
};

// One warp's row xr: e_i = exp(x_i * (1/T) - max(x) * (1/T)) and its
// moments, reduced over the warp; with kKeep, e is also written to er.
template <bool kKeep, typename T>
__device__ __forceinline__ Moments softmax_moments(const T* xr, float* er, const float* lin_r,
                                                   const float* lin_c, int hw, float inv_t, int lane) {
  // max(x * inv_t) = max(x) * inv_t: rounding is monotone and inv_t > 0
  float m = -INFINITY;
  for (int i = lane; i < hw; i += 32) m = fmaxf(m, to_float(xr[i]));
  m = warp_max(m) * inv_t;

  float s = 0.0f, sx = 0.0f, sy = 0.0f;
  for (int i = lane; i < hw; i += 32) {
    const float e = expf(fmaf(to_float(xr[i]), inv_t, -m));
    if (kKeep) er[i] = e;
    s += e;
    sx += e * lin_r[i];
    sy += e * lin_c[i];
  }
  return {warp_sum(s), warp_sum(sx), warp_sum(sy)};
}

// Shared memory: xs (kRowsPerBlock * hw elements of T), then lin_r and
// lin_c (hw floats each).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spatial_softmax_kernel(const T* __restrict__ x, float2* __restrict__ out, int rows, int h, int w,
                           const float* __restrict__ temp_ptr, float temp_value) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hw = h * w;
  T* xs = reinterpret_cast<T*>(smem);
  float* lin_r = reinterpret_cast<float*>(xs + kRowsPerBlock * hw);
  float* lin_c = lin_r + hw;
  const int row0 = blockIdx.x * kRowsPerBlock;
  stage_rows(xs, x, row0, rows, hw);
  coordinate_tables(lin_r, lin_c, h, w);
  const float inv_t = 1.0f / (temp_ptr ? *temp_ptr : temp_value);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = row0 + warp;
  if (row < rows) {
    const Moments mo = softmax_moments<false, T>(xs + warp * hw, nullptr, lin_r, lin_c, hw, inv_t, lane);
    if (lane == 0) out[row] = make_float2(mo.sx / mo.s, mo.sy / mo.s);
  }
}

// The block's dx (count elements) from es: 16-byte stores of 4 floats, or
// of 8 bf16 each the fp32 value rounded once; the elements that fill no 16
// bytes one by one.
__device__ __forceinline__ void store_rows(float* dst, const float* es, int count) {
  const int vecs = count >> 2;
  for (int i = threadIdx.x; i < vecs; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(es)[i];
  for (int i = 4 * vecs + threadIdx.x; i < count; i += kThreads) dst[i] = es[i];
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo at the lower address
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float* es, int count) {
  const int vecs = count >> 3;
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    const float4 a = reinterpret_cast<const float4*>(es)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(es)[2 * i + 1];
    reinterpret_cast<uint4*>(dst)[i] =
        make_uint4(bf16_pair(a.x, a.y), bf16_pair(a.z, a.w), bf16_pair(b.x, b.y), bf16_pair(b.z, b.w));
  }
  for (int i = 8 * vecs + threadIdx.x; i < count; i += kThreads) dst[i] = __float2bfloat16_rn(es[i]);
}

// Shared memory: xs (kRowsPerBlock * hw elements of T), then es
// (kRowsPerBlock * hw floats), lin_r and lin_c (hw floats each).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spatial_softmax_bwd_kernel(const T* __restrict__ x, const float* __restrict__ grad_out,
                               T* __restrict__ dx, float* __restrict__ row_xdx, int rows,
                               int h, int w, const float* __restrict__ temp_ptr, float temp_value) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hw = h * w;
  T* xs = reinterpret_cast<T*>(smem);
  float* es = reinterpret_cast<float*>(xs + kRowsPerBlock * hw);
  float* lin_r = es + kRowsPerBlock * hw;
  float* lin_c = lin_r + hw;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int count = stage_rows(xs, x, row0, rows, hw);
  coordinate_tables(lin_r, lin_c, h, w);
  const float temp = temp_ptr ? *temp_ptr : temp_value;
  const float inv_t = 1.0f / temp;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = row0 + warp;
  if (row < rows) {
    const T* xr = xs + warp * hw;
    float* er = es + warp * hw;
    const Moments mo = softmax_moments<true, T>(xr, er, lin_r, lin_c, hw, inv_t, lane);
    const float ex = mo.sx / mo.s;
    const float ey = mo.sy / mo.s;
    const float gx = grad_out[2 * static_cast<long long>(row)];
    const float gy = grad_out[2 * static_cast<long long>(row) + 1];
    const float scale = (1.0f / mo.s) * inv_t;

    float xdx = 0.0f;
    for (int i = lane; i < hw; i += 32) {
      const float g = gx * (lin_r[i] - ex) + gy * (lin_c[i] - ey);
      const float d = er[i] * scale * g;
      er[i] = d;
      xdx += to_float(xr[i]) * d;
    }
    if (row_xdx) {
      xdx = warp_sum(xdx);
      if (lane == 0) row_xdx[row] = xdx;
    }
  }
  __syncthreads();
  store_rows(dx + static_cast<long long>(row0) * hw, es, count);
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

// Dynamic shared memory above 48 KB must be asked for; returns the error.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
int launch_bwd(const void* x, const void* grad_out, void* dx, void* row_xdx, void* dtemp, long long n, int c,
               int h, int w, const void* temp_ptr, float temp_value, void* stream) {
  const long long rows = n * c;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (rows > 0x7fffffffLL - kRowsPerBlock || (temp_ptr && (!row_xdx || !dtemp)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hw = h * w;
  const int smem = static_cast<int>(sizeof(T)) * kRowsPerBlock * hw +
                   static_cast<int>(sizeof(float)) * (kRowsPerBlock + 2) * hw;
  cudaError_t err = allow_smem(spatial_softmax_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* temp = static_cast<const float*>(temp_ptr);
  const unsigned int blocks = static_cast<unsigned int>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  spatial_softmax_bwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(grad_out), static_cast<T*>(dx),
      temp ? static_cast<float*>(row_xdx) : nullptr, static_cast<int>(rows), h, w, temp, temp_value);
  err = cudaGetLastError();
  if (err != cudaSuccess || !temp) return static_cast<int>(err);
  spatial_softmax_temperature_grad_kernel<<<1, kReduceThreads, 0, s>>>(
      static_cast<const float*>(row_xdx), static_cast<int>(rows), temp, static_cast<float*>(dtemp));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* x, void* out, long long n, int c, int h, int w, const void* temp_ptr,
               float temp_value, void* stream) {
  const long long rows = n * c;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (rows > 0x7fffffffLL - kRowsPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(T)) * kRowsPerBlock * h * w + static_cast<int>(sizeof(float)) * 2 * h * w;
  const cudaError_t err = allow_smem(spatial_softmax_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  spatial_softmax_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<float2*>(out), static_cast<int>(rows), h, w,
      static_cast<const float*>(temp_ptr), temp_value);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// With a learnable temperature (temp_ptr), row_xdx (rows floats of
// scratch) and dtemp (one float) are given too, and dT is written. x and
// dx of the map's type (float here, bf16 in the _bf16 instance), x 16-byte
// aligned (the wrapper checks).
extern "C" int hulc_spatial_softmax_bwd(const void* x, const void* grad_out, void* dx,
                                        void* row_xdx, void* dtemp, long long n, int c, int h,
                                        int w, const void* temp_ptr, float temp_value,
                                        void* stream) {
  return launch_bwd<float>(x, grad_out, dx, row_xdx, dtemp, n, c, h, w, temp_ptr, temp_value, stream);
}

extern "C" int hulc_spatial_softmax_bwd_bf16(const void* x, const void* grad_out, void* dx,
                                             void* row_xdx, void* dtemp, long long n, int c, int h,
                                             int w, const void* temp_ptr, float temp_value,
                                             void* stream) {
  return launch_bwd<__nv_bfloat16>(x, grad_out, dx, row_xdx, dtemp, n, c, h, w, temp_ptr, temp_value, stream);
}

// x (float here, bf16 in the _bf16 instance) must start 16-byte aligned and
// out 8-byte aligned (the wrapper checks).
extern "C" int hulc_spatial_softmax(const void* x, void* out, long long n, int c, int h, int w,
                                    const void* temp_ptr, float temp_value, void* stream) {
  return launch_fwd<float>(x, out, n, c, h, w, temp_ptr, temp_value, stream);
}

extern "C" int hulc_spatial_softmax_bf16(const void* x, void* out, long long n, int c, int h, int w,
                                         const void* temp_ptr, float temp_value, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, out, n, c, h, w, temp_ptr, temp_value, stream);
}
