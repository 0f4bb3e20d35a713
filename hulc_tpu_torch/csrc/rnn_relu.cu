// The decoder's relu-RNN recurrence, forward and backward, one layer a launch.
//
// Replaces hulc_tpu/models/layers.py ScanRNN.__call__'s lax.scan for the
// "rnn" cell (lines 233-237 and 265-267): with the input projection xp
// (B, S, H) already computed (b_ih in it) and W = W_hh in torch nn.RNN
// layout (H_out, H_in),
//   y_t = relu(xp_t + h_{t-1} W^T + b_hh),   h_{-1} = h0,   t = 0 .. S-1,
// and its backward with the custom-VJP relu's mask (layers.py:25-56,
// g * (y > 0)): with dh_{S-1} = dcarry and g_t = dy_t + dh_t,
//   dpre_t = g_t * (y_t > 0),   dh_{t-1} = dpre_t W,   dh0 = dh_{-1}.
// The caller forms dW_hh = dpre^T [h0, y_{:-1}] as one matrix product over
// all S * B rows and db_hh as dpre's sum: no per-step weight gradients.
//
// Bound on the H100: operations. Each time step is 2 B H^2 fp32 FLOP that
// cannot start before every column of the step before is done; at the
// training step's B = 64, S = 32, H = 2048 that is 17.2 GFLOP a layer,
// 0.256 ms at 67 TFLOP/s. At one serving lane (B = S = 1) it is the read
// of W, 16.8 MB, 0.005 ms at 3.35 TB/s.
//
// Design: one persistent cooperative launch per layer and direction.
//   * Each block owns `cols` (<= 16) output columns, chosen from the SM
//     count so every block is resident at once (128 blocks on an H100 at
//     H = 2048), and keeps its slice of W in shared memory for the whole
//     sequence: the forward the rows W[j0:j0+cols, :], the backward the
//     columns W[:, i0:i0+cols] transposed, so both reduce along a
//     contiguous row of the slice (128 KB at H = 2048).
//   * At every step the block streams the previous state (h_{t-1}, or
//     dpre_t in the backward) through shared memory in 128-wide chunks,
//     double-buffered with 16-byte cp.async.cg (L2 only: another block
//     wrote it), and computes its 64 x 16 output tile in fp32 FMA:
//     each lane an 8 x 8 register tile over a sixteenth of every chunk's k
//     (16 loads of 16 bytes for 256 FMAs; an 8 x 4 tile took 10% longer),
//     the two slices of a warp folded by shuffles, then the 8 warps'
//     partial sums added in a fixed order. Rows and slices are skewed by 4
//     floats so the 16-byte loads do not conflict.
//   * The epilogue adds xp and b_hh and applies relu (forward), or forms
//     the next dpre from dy and the mask (backward), and stores the tile.
//   * One grid-wide barrier per time step (cooperative_groups).
// No TF32 and no tensor cores: the port computes in fp32.
//
// Where a step's time goes (evaluation/recurrence_variants.py, which times
// this file with parts taken out): streaming the state from L2 and the
// FMAs each take about half of it and overlap little. Every block reads
// all of h_{t-1}, 64 MB of L2 reads per step across 128 blocks; clusters
// sharing one load (TMA multicast) would cut that.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;                                  // most columns a block owns
constexpr int kRows = 64;                                  // batch rows per tile
constexpr int kChunk = 128;                                // k values staged at a time
constexpr int kChunkQuads = kChunk / 4;
constexpr int kHStride = kChunk + 4;                       // floats per staged row (bank skew)
constexpr int kRedStride = 20;                             // floats per row of the partial sums
constexpr int kOutPerThread = kRows * kCols / kThreads;    // 4
// Each lane accumulates an 8 x kTileCols tile of the block's outputs over
// one slice of every chunk's k; a slice is kSliceLanes lanes, a warp holds
// 32 / kSliceLanes slices.
constexpr int kTileRows = 8;
constexpr int kTileCols = 8;
constexpr int kColGroups = kCols / kTileCols;
constexpr int kSliceLanes = kRows / kTileRows * kColGroups;
constexpr int kSlices = kThreads / kSliceLanes;
constexpr int kQuadsPerSlice = kChunkQuads / kSlices;
static_assert(kSliceLanes <= 32 && kQuadsPerSlice * kSlices == kChunkQuads, "slices split warps and chunks");
constexpr int kStageFloats = 2 * kRows * kHStride;         // two chunk buffers
static_assert(kWarps * kRows * kRedStride <= kStageFloats, "the partial sums reuse the chunk buffers");

// Floats per row of the weight slice: whole 32-float groups plus a skew of 4.
__host__ __device__ __forceinline__ int weight_stride(int hidden) { return (hidden + 31) / 32 * 32 + 4; }

__host__ __device__ __forceinline__ int smem_bytes(int hidden) {
  return static_cast<int>(sizeof(float)) * (kCols * weight_stride(hidden) + kStageFloats);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ws[jj * wst + k] = W[c0 + jj, k] (kTransposed: W[k, c0 + jj]) for the
// block's valid columns and k < hidden; zero elsewhere. W is never written
// by these kernels, so read-only loads are safe. With vec (hidden and
// cols multiples of 4, W 16-byte aligned) the rows go by 16-byte cp.async
// (committed as one group, which the first chunk's wait covers) and the
// transposed columns by batches of eight 16-byte loads in flight per
// thread: a load at a time would leave the serving launch (one step)
// waiting on 130 round trips to device memory per thread.
template <bool kTransposed>
__device__ __forceinline__ void load_weight_slice(float* ws, const float* w, int hidden, int c0, int c_valid,
                                                  bool vec) {
  const int wst = weight_stride(hidden);
  if (vec && !kTransposed) {
    const int quads = wst / 4;
    for (int idx = threadIdx.x; idx < kCols * quads; idx += kThreads) {
      const int jj = idx / quads, k = 4 * (idx % quads);
      float* dst = ws + jj * wst + k;
      if (jj < c_valid && k < hidden) {
        cp_async16(dst, w + static_cast<long long>(c0 + jj) * hidden + k);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    return;
  }
  if (vec) {
    constexpr int kBatch = 8;
    const int items = hidden * (kCols / 4);  // (k, column quad)
    for (int base = threadIdx.x; base < items; base += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int idx = base + i * kThreads, k = idx >> 2, jq = 4 * (idx & 3);
        v[i] = idx < items && jq < c_valid
                   ? __ldg(reinterpret_cast<const float4*>(w + static_cast<long long>(k) * hidden + c0 + jq))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int idx = base + i * kThreads, k = idx >> 2, jq = 4 * (idx & 3);
        if (idx < items) {
          ws[jq * wst + k] = v[i].x;
          ws[(jq + 1) * wst + k] = v[i].y;
          ws[(jq + 2) * wst + k] = v[i].z;
          ws[(jq + 3) * wst + k] = v[i].w;
        }
      }
    }
    for (int idx = threadIdx.x; idx < kCols * (wst - hidden); idx += kThreads)
      ws[(idx % kCols) * wst + hidden + idx / kCols] = 0.0f;
    return;
  }
  for (int idx = threadIdx.x; idx < kCols * wst; idx += kThreads) {
    // transposed: the 16 columns of one W row are neighbours in memory
    const int jj = kTransposed ? idx % kCols : idx / wst;
    const int k = kTransposed ? idx / kCols : idx % wst;
    float v = 0.0f;
    if (jj < c_valid && k < hidden)
      v = kTransposed ? w[static_cast<long long>(k) * hidden + c0 + jj]
                      : w[static_cast<long long>(c0 + jj) * hidden + k];
    ws[jj * wst + k] = v;
  }
}

// Stage rows [0, rows) and k in [k0, k0 + kChunk) of src (row stride
// `stride` floats) into hs (kRows x kHStride); k >= hidden and rows >=
// `rows` are zero. With vec, every source row starts 16-byte aligned and
// hidden % 4 == 0, so full quads go by cp.async; else by L2 loads. Commits
// one cp.async group.
__device__ __forceinline__ void stage_chunk(float* hs, const float* src, long long stride, int rows, int k0,
                                            int hidden, bool vec) {
  for (int i = threadIdx.x; i < kRows * kChunkQuads; i += kThreads) {
    const int r = i / kChunkQuads, q = i % kChunkQuads;
    const int k = k0 + 4 * q;
    float* dst = hs + r * kHStride + 4 * q;
    if (r >= rows || k >= hidden) {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float* s = src + r * stride + k;
    if (vec) {
      cp_async16(dst, s);
    } else {
      for (int e = 0; e < 4; ++e) dst[e] = k + e < hidden ? __ldcg(s + e) : 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The block's kRows x kCols tile of src[0:rows, :hidden] ws^T. Thread
// threadIdx.x gets the outputs (row, col) = (threadIdx.x / 16 + 16 m,
// threadIdx.x % 16), m < kOutPerThread.
__device__ __forceinline__ void tile_product(float (&out)[kOutPerThread], const float* src, long long stride,
                                             int rows, const float* ws, float* stage, int hidden, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = threadIdx.x / kSliceLanes, ls = threadIdx.x % kSliceLanes;
  const int rg = ls / kColGroups, cg = ls % kColGroups;  // rows rg + 8 r, columns cg + kColGroups q
  const int wst = weight_stride(hidden);
  float acc[kTileRows][kTileCols];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r)
#pragma unroll
    for (int q = 0; q < kTileCols; ++q) acc[r][q] = 0.0f;

  const int chunks = (hidden + kChunk - 1) / kChunk;
  stage_chunk(stage, src, stride, rows, 0, hidden, vec);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_chunk(stage + ((c + 1) & 1) * kRows * kHStride, src, stride, rows, (c + 1) * kChunk, hidden, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* hs = stage + (c & 1) * kRows * kHStride;
    const int k0 = c * kChunk;
#pragma unroll
    for (int i = 0; i < kQuadsPerSlice; ++i) {
      const int kk = 4 * (slice * kQuadsPerSlice + i);
      if (k0 + kk < hidden) {
        float4 h[kTileRows], wv[kTileCols];
#pragma unroll
        for (int r = 0; r < kTileRows; ++r)
          h[r] = *reinterpret_cast<const float4*>(hs + (rg + 8 * r) * kHStride + kk);
#pragma unroll
        for (int q = 0; q < kTileCols; ++q)
          wv[q] = *reinterpret_cast<const float4*>(ws + (cg + kColGroups * q) * wst + k0 + kk);
#pragma unroll
        for (int r = 0; r < kTileRows; ++r)
#pragma unroll
          for (int q = 0; q < kTileCols; ++q) {
            float a = acc[r][q];
            a = fmaf(h[r].x, wv[q].x, a);
            a = fmaf(h[r].y, wv[q].y, a);
            a = fmaf(h[r].z, wv[q].z, a);
            acc[r][q] = fmaf(h[r].w, wv[q].w, a);
          }
      }
    }
    __syncthreads();  // the buffer is refilled two chunks on, or reused below
  }

  // the warp's slices folded into its first kSliceLanes lanes, then the
  // warps' partial tiles added in a fixed order
#pragma unroll
  for (int offset = kSliceLanes; offset < 32; offset *= 2)
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
#pragma unroll
      for (int q = 0; q < kTileCols; ++q) acc[r][q] += __shfl_down_sync(0xffffffffu, acc[r][q], offset);
  float* red = stage;
  if (lane < kSliceLanes) {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
#pragma unroll
      for (int q = 0; q < kTileCols; ++q)
        red[(warp * kRows + rg + 8 * r) * kRedStride + cg + kColGroups * q] = acc[r][q];
  }
  __syncthreads();
  const int col = threadIdx.x % kCols;
#pragma unroll
  for (int m = 0; m < kOutPerThread; ++m) {
    const int row = threadIdx.x / kCols + (kThreads / kCols) * m;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * kRows + row) * kRedStride + col];
    out[m] = s;
  }
  __syncthreads();  // red is read before the next tile stages into it
}

__global__ void __launch_bounds__(kThreads, 1)
    rnn_relu_fwd_kernel(const float* __restrict__ xp, const float* h0, const float* __restrict__ w,
                        const float* __restrict__ bias, float* y, float* h_last, int batch, int seq, int hidden,
                        int cols, int vec, int vec_w) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* stage = smem + kCols * weight_stride(hidden);
  const int c0 = blockIdx.x * cols;
  const int c_valid = min(cols, hidden - c0);
  load_weight_slice<false>(ws, w, hidden, c0, c_valid, vec_w);
  const int col = threadIdx.x % kCols;
  const bool col_ok = col < c_valid;
  const float b = col_ok ? bias[c0 + col] : 0.0f;
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const long long seq_stride = static_cast<long long>(seq) * hidden;
  for (int t = 0; t < seq; ++t) {
    if (t > 0) grid.sync();  // y[:, t - 1] is complete, in every column
    const float* src = t == 0 ? h0 : y + static_cast<long long>(t - 1) * hidden;
    const long long stride = t == 0 ? hidden : seq_stride;
    for (int r0 = 0; r0 < batch; r0 += kRows) {
      const int rows = min(kRows, batch - r0);
      long long at[kOutPerThread];
      float xv[kOutPerThread];
#pragma unroll
      for (int m = 0; m < kOutPerThread; ++m) {
        const int row = threadIdx.x / kCols + (kThreads / kCols) * m;
        at[m] = row < rows && col_ok ? (static_cast<long long>(r0 + row) * seq + t) * hidden + c0 + col : -1;
        xv[m] = at[m] >= 0 ? xp[at[m]] : 0.0f;
      }
      float out[kOutPerThread];
      tile_product(out, src + r0 * stride, stride, rows, ws, stage, hidden, vec);
#pragma unroll
      for (int m = 0; m < kOutPerThread; ++m) {
        if (at[m] < 0) continue;
        const float v = fmaxf(xv[m] + (out[m] + b), 0.0f);
        y[at[m]] = v;
        if (h_last && t == seq - 1) {
          const int row = threadIdx.x / kCols + (kThreads / kCols) * m;
          h_last[static_cast<long long>(r0 + row) * hidden + c0 + col] = v;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    rnn_relu_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ y, const float* __restrict__ dcarry,
                        const float* __restrict__ w, float* dpre, float* dh0, int batch, int seq, int hidden,
                        int cols, int vec, int vec_w) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* stage = smem + kCols * weight_stride(hidden);
  const int c0 = blockIdx.x * cols;
  const int c_valid = min(cols, hidden - c0);
  load_weight_slice<true>(ws, w, hidden, c0, c_valid, vec_w);
  const int col = threadIdx.x % kCols;
  const bool col_ok = col < c_valid;

  // dpre_{S-1} = (dy_{S-1} + dcarry) * (y_{S-1} > 0), in the block's columns
  for (int i = threadIdx.x; i < batch * kCols; i += kThreads) {
    const int row = i / kCols, cc = i % kCols;
    if (cc >= c_valid) continue;
    const long long o = (static_cast<long long>(row) * seq + seq - 1) * hidden + c0 + cc;
    const float g = dy[o] + (dcarry ? dcarry[static_cast<long long>(row) * hidden + c0 + cc] : 0.0f);
    dpre[o] = g * (y[o] > 0.0f ? 1.0f : 0.0f);
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const long long seq_stride = static_cast<long long>(seq) * hidden;
  for (int t = seq - 1; t >= 0; --t) {
    grid.sync();  // dpre[:, t] is complete, in every column
    const float* src = dpre + static_cast<long long>(t) * hidden;
    for (int r0 = 0; r0 < batch; r0 += kRows) {
      const int rows = min(kRows, batch - r0);
      long long at[kOutPerThread];
      float dyv[kOutPerThread], mask[kOutPerThread];
#pragma unroll
      for (int m = 0; m < kOutPerThread; ++m) {
        const int row = threadIdx.x / kCols + (kThreads / kCols) * m;
        const bool ok = row < rows && col_ok;
        // where dh_{t-1} goes: into dpre[:, t - 1], or dh0 at t = 0
        at[m] = !ok ? -1
                : t > 0 ? (static_cast<long long>(r0 + row) * seq + t - 1) * hidden + c0 + col
                        : static_cast<long long>(r0 + row) * hidden + c0 + col;
        dyv[m] = ok && t > 0 ? dy[at[m]] : 0.0f;
        mask[m] = ok && t > 0 && y[at[m]] > 0.0f ? 1.0f : 0.0f;
      }
      float out[kOutPerThread];
      tile_product(out, src + r0 * seq_stride, seq_stride, rows, ws, stage, hidden, vec);
#pragma unroll
      for (int m = 0; m < kOutPerThread; ++m) {
        if (at[m] < 0) continue;
        if (t > 0) {
          dpre[at[m]] = (dyv[m] + out[m]) * mask[m];
        } else {
          dh0[at[m]] = out[m];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

// Columns per block from the SM count, the grid, and the checks a
// cooperative launch needs: the slice fits in shared memory, and every
// block fits on the card at once.
template <typename Kernel>
cudaError_t plan(Kernel kernel, int hidden, int* cols, int* blocks, int* smem) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *cols = (hidden + sms - 1) / sms;
  *blocks = (hidden + *cols - 1) / *cols;
  *smem = smem_bytes(hidden);
  if (*cols > kCols || *smem > optin) return cudaErrorInvalidValue;  // H too large for the slice
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, *smem);
  if (err != cudaSuccess) return err;
  return per_sm * sms >= *blocks ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

template <typename Kernel>
int launch(Kernel kernel, int blocks, int smem, void** args, void* stream) {
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kThreads),
                                                args, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// y (B, S, H) and, when h_last is not null, y[:, S - 1] again as (B, H).
extern "C" int hulc_rnn_relu_fwd(const void* xp, const void* h0, const void* w, const void* bias, void* y,
                                 void* h_last, int batch, int seq, int hidden, void* stream) {
  if (batch <= 0 || seq <= 0 || hidden <= 0) return static_cast<int>(cudaGetLastError());
  int cols = 0, blocks = 0, smem = 0;
  const cudaError_t err = plan(rnn_relu_fwd_kernel, hidden, &cols, &blocks, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int vec = hidden % 4 == 0 && aligned16(h0) && aligned16(y);
  int vec_w = hidden % 4 == 0 && aligned16(w);
  const float* xp_ = static_cast<const float*>(xp);
  const float* h0_ = static_cast<const float*>(h0);
  const float* w_ = static_cast<const float*>(w);
  const float* b_ = static_cast<const float*>(bias);
  float* y_ = static_cast<float*>(y);
  float* hl_ = static_cast<float*>(h_last);
  void* args[] = {&xp_, &h0_, &w_, &b_, &y_, &hl_, &batch, &seq, &hidden, &cols, &vec, &vec_w};
  return launch(rnn_relu_fwd_kernel, blocks, smem, args, stream);
}

// dpre (B, S, H) and dh0 (B, H); dcarry (B, H) may be null (no gradient
// reaches the final carry).
extern "C" int hulc_rnn_relu_bwd(const void* dy, const void* y, const void* dcarry, const void* w, void* dpre,
                                 void* dh0, int batch, int seq, int hidden, void* stream) {
  if (batch <= 0 || seq <= 0 || hidden <= 0) return static_cast<int>(cudaGetLastError());
  int cols = 0, blocks = 0, smem = 0;
  const cudaError_t err = plan(rnn_relu_bwd_kernel, hidden, &cols, &blocks, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int vec = hidden % 4 == 0 && aligned16(dpre);
  int vec_w = hidden % 4 == 0 && cols % 4 == 0 && aligned16(w);
  const float* dy_ = static_cast<const float*>(dy);
  const float* y_ = static_cast<const float*>(y);
  const float* dc_ = static_cast<const float*>(dcarry);
  const float* w_ = static_cast<const float*>(w);
  float* dpre_ = static_cast<float*>(dpre);
  float* dh0_ = static_cast<float*>(dh0);
  void* args[] = {&dy_, &y_, &dc_, &w_, &dpre_, &dh0_, &batch, &seq, &hidden, &cols, &vec, &vec_w};
  return launch(rnn_relu_bwd_kernel, blocks, smem, args, stream);
}
