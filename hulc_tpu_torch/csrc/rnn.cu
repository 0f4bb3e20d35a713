// The RNN recurrences, forward and backward, one chain a launch: the
// decoder's relu cell (B.6), the tanh cell (B.8), which the MCIL plan
// recognition's bidirectional layers (B.9) run once a direction, and the
// relu cell's chain of a bidirectional layer (B.13, birnn_cell = "rnn").
//
// Replaces hulc_tpu/models/layers.py ScanRNN.__call__'s lax.scan for the
// "rnn" and "rnn_tanh" cells (lines 233-238 and 265-267): with the input
// projection xp (B, S, H) already computed (b_ih in it) and W = W_hh in
// torch nn.RNN layout (H_out, H_in),
//   y_t = act(xp_t + h_{t-1} W^T + b_hh),   h_{-1} = h0,   t = 0 .. S-1,
// act = relu or tanhf (the libdevice tanhf that PyTorch's CUDA tanh calls),
// and its backward with the activation's derivative from the saved output
// (relu: the custom-VJP mask of layers.py:25-56, g * (y > 0); tanh:
// 1 - y^2): with dh_{S-1} = dcarry and g_t = dy_t + dh_t,
//   dpre_t = g_t * act'(y_t),   dh_{t-1} = dpre_t W,   dh0 = dh_{-1}.
// The caller forms dW_hh = dpre^T [h0, y_{:-1}] as one matrix product over
// all S * B rows and db_hh as dpre's sum: no per-step weight gradients.
//
// A bidirectional layer (layers.py:284-313 ScanBiRNN: a forward chain and
// a chain over the time-reversed input, flipped back and concatenated to
// (B, S, 2H)) is two launches of the tanh (or relu) kernels, one a
// direction, into one (B, S, 2H) output: a chain's Layout gives y's row width (2H) and its
// columns (the caller's pointer already at column 0 or H), and `reverse`
// has step t read xp[:, S-1-t] and write y[:, S-1-t]. No flip and no
// concatenation is copied; the backward reads dy and y through the same
// layout and writes each chain's dpre (B, S, H) in xp's time order. The
// two chains run one after the other: each takes 120 SMs at H = 2048, and
// the two W_hh (2 x 16.8 MB) are more than the card's shared memory.
// The kernels are templates on the activation and on kLaid, whether the
// layout is the launch's or the constant (H, forward) of a chain that owns
// its y: the decoder's relu chain (B.6) compiles with the constant layout
// (with the layout as kernel arguments its forward ran 2.3-2.8% slower),
// the bidirectional relu chain (B.13) with the launch's, as the tanh's.
//
// Bound on the H100 (either cell, each chain): operations. Each time step is 2 B H^2 fp32 FLOP that
// cannot start before every column of the step before is done; at the
// training step's B = 64, S = 32, H = 2048 that is 17.2 GFLOP a layer,
// 0.256 ms at 67 TFLOP/s. At one serving lane (B = S = 1) it is the read
// of W, 16.8 MB, 0.005 ms at 3.35 TB/s.
//
// The launch plan (which kernel, cluster size, k-split, columns, shared
// memory) is made in Python (ops/recurrence.py recurrence_plan), checked
// once against this file's geometry and the card (hulc_rnn_check), and
// handed to the entry points, which derive the grid from it and refuse a
// plan that does not cover the problem.
//
// Sequence kernels (S > 1, the backward at any S, the forward at S = 1 with
// more than kStepRows rows): split-K over thread-block clusters.
//   * Cluster c owns the kCols = 144 output columns [c kCols, (c + 1)
//     kCols); its block of rank j owns the k-slice [j ks, (j + 1) ks).
//     Every cluster must be resident at once, and a cluster's blocks share a
//     GPC: the H100 measured holds 15 clusters of 8 at one block per SM, not
//     the 16 that H = 2048 in 128-column clusters would need, so H = 2048
//     takes 15 clusters of 144 columns (the last holds 32), ks = 256, on 120
//     SMs. A smaller H takes clusters of 4 or of 1, where it is too small
//     to give each of 8 (or 4) blocks some k.
//     The block keeps its cols x ks block of W (forward: W[cols, ks];
//     backward: W[ks, cols] transposed, as dh = dpre W reduces over W's
//     rows) in shared memory for the whole sequence (146 KB at H = 2048).
//   * At every step the block stages only its k-slice of the previous state
//     (h_{t-1}[:, ks], or dpre_t[:, ks] backward; 64 KB at B = 64) in
//     kChunk-wide chunks, double-buffered with 16-byte cp.async.cg (L2 only:
//     other blocks wrote it), and computes a 64 x cols partial product in
//     fp32 FMA: eight warps, each lane an 8 x 9 register tile over
//     half of every chunk's k (the loop unrolled, so the next k's loads issue
//     under this one's FMAs), the halves folded by shuffles. Rows are
//     skewed by 4 floats so the 16-byte loads do not conflict.
//   * The cluster's partials are summed through distributed shared memory:
//     block j adds, in rank order (deterministic), the 64 x kCols / cluster
//     column slice j of every block's partial, then runs the epilogue (+ xp
//     + b_hh, the activation, the h_last store forward; (dy + dh) *
//     act'(y), or dh0, backward) on inputs it staged beside chunk 0, and
//     stores its tile.
//   * One grid-wide barrier per step (cooperative launch with a cluster
//     dimension).
//   Per SM and step the state coming in is 64 KB of L2 reads plus 7 x 4.5 KB
//   of DSMEM reads, where the first design (each block all of h_{t-1} for 16
//   whole columns) read 512 KB.
//
// The one-step kernel (forward, S = 1, at most kStepRows rows: a serving
// lane): a GEMV over many blocks, not cooperative. Each warp owns one output
// column, reads its row of W straight from device memory with 16-byte loads
// (each element of W is read once), and dots it with the B rows of h0 (L1);
// a butterfly of shuffles sums the lanes, and the same epilogue follows.
// No TF32 and no tensor cores: the port computes in fp32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                // a block of the sequence kernels
constexpr int kWarps = kThreads / 32;
constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kRows = 64;                    // batch rows per tile
constexpr int kChunk = 64;                   // k values staged at a time
constexpr int kMaxCluster = 8;               // the portable cluster size
constexpr int kSkew = 4;                     // floats of bank skew per row
constexpr int kHStride = kChunk + kSkew;     // floats per staged row
constexpr int kStepRows = 8;                 // most rows of the one-step kernel
// Lane tiles: warp w owns the columns [18 w, 18 (w + 1)) of the block's
// 64 x kCols partial. kSliceLanes lanes cover them once, each an 8 x
// kTileCols register tile (rows l / 2 + 8 r, columns l % 2 + 2 q of lane l
// of the slice); the warp's two slices take the two halves of every chunk's
// k. Eight warps, so each of an SM's four schedulers gets two.
constexpr int kTileRows = 8;
constexpr int kTileCols = 9;
constexpr int kColGroups = 2;
constexpr int kSliceLanes = kRows / kTileRows * kColGroups;    // 16
constexpr int kParts = 32 / kSliceLanes;                       // 2
constexpr int kPartQuads = kChunk / 4 / kParts;                // quads of a chunk per part
static_assert(kSliceLanes <= 32 && kPartQuads * kParts * 4 == kChunk, "slices split warps and chunks");
constexpr int kCols = 144;                                     // output columns of a cluster
static_assert(kCols == kWarps * kColGroups * kTileCols, "the warps' tiles cover a cluster's columns");

enum Launch { kSequence = 0, kStep = 1 };

// The activation and its derivative from the saved output.
template <bool kTanh>
__device__ __forceinline__ float activate(float pre) {
  return kTanh ? tanhf(pre) : fmaxf(pre, 0.0f);
}

template <bool kTanh>
__device__ __forceinline__ float activation_grad(float y) {
  return kTanh ? 1.0f - y * y : (y > 0.0f ? 1.0f : 0.0f);
}

// Where a chain's y (and, backward, dy) lives: rows of `width` floats a
// time step (H alone, 2H in a bidirectional layer), the chain's columns
// from the pointer the kernel is given; time step t of the chain at row
// time(t), which runs backwards for the reverse chain. xp, h0, dpre, dh0
// and h_last are the chain's own (B, S, H) / (B, H) tensors, in xp's time
// order.
struct Layout {
  int width;
  int reverse;
  __device__ __forceinline__ long long time(int t, int seq) const { return reverse ? seq - 1 - t : t; }
};

// Floats per row of the block's W slice: whole chunks plus the skew.
__host__ __device__ __forceinline__ int weight_stride(int k_slice) {
  return (k_slice + kChunk - 1) / kChunk * kChunk + kSkew;
}

// Floats per row of the partial product.
constexpr int kPartStride = kCols + kSkew;

// Dynamic shared memory of a sequence kernel: the W slice, two chunk
// buffers, the partial product, and the epilogue's inputs for the block's
// reduce slice (xp forward; dy and y backward).
int sequence_smem_bytes(int k_slice, int cluster, bool backward) {
  return static_cast<int>(sizeof(float)) * (kCols * weight_stride(k_slice) + 2 * kRows * kHStride +
                                            kRows * kPartStride + (backward ? 2 : 1) * kRows * (kCols / cluster));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// 4 bytes, through L1: for inputs no block of the launch writes.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Where a block of a sequence kernel works.
struct Geometry {
  int c0;       // first output column of the cluster
  int c_valid;  // its columns below hidden
  int k0;       // first k of the block's slice
  int k_valid;  // its k below hidden
  int r0;       // first output column of the block's reduce slice
  int r_valid;  // its columns below hidden
  int nred;     // columns of a reduce slice, kCols / cluster
  int rank;
  int cluster;
};

__device__ __forceinline__ Geometry geometry(const cg::cluster_group& cluster, int hidden, int k_slice) {
  Geometry g;
  g.cluster = static_cast<int>(cluster.num_blocks());
  g.rank = static_cast<int>(cluster.block_rank());
  g.c0 = static_cast<int>(blockIdx.x) / g.cluster * kCols;
  g.c_valid = min(kCols, hidden - g.c0);
  g.k0 = g.rank * k_slice;
  g.k_valid = max(0, min(k_slice, hidden - g.k0));
  g.nred = kCols / g.cluster;
  g.r0 = g.c0 + g.rank * g.nred;
  g.r_valid = max(0, min(g.nred, hidden - g.r0));
  return g;
}

// ws[jj * wst + kk] = W[c0 + jj, k0 + kk] (kTransposed: W[k0 + kk, c0 + jj])
// for the block's valid columns and k, zero elsewhere up to whole chunks. W
// is never written by these kernels, so read-only loads are safe. With vec
// (hidden a multiple of 4, W 16-byte aligned; the plan keeps k0 and c0
// multiples of 4) the rows go by 16-byte cp.async, committed as one group
// that the first chunk's wait covers, and the transposed rows by batches of
// eight 16-byte loads in flight per thread.
template <bool kTransposed>
__device__ void load_weight_slice(float* ws, const float* __restrict__ w, int hidden, const Geometry& g,
                                  int wst, bool vec) {
  const int kpad = wst - kSkew;
  if (vec && !kTransposed) {
    const int quads = kpad / 4;
    for (int idx = threadIdx.x; idx < kCols * quads; idx += kThreads) {
      const int jj = idx / quads, kk = 4 * (idx % quads);
      float* dst = ws + jj * wst + kk;
      if (jj < g.c_valid && kk < g.k_valid) {
        cp_async16(dst, w + static_cast<long long>(g.c0 + jj) * hidden + g.k0 + kk);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    cp_async_commit();
    return;
  }
  if (vec) {
    // item (kk, column quad): a warp reads 4 quads (64 bytes) of 8 rows of
    // W, so its transposed stores fall on 16 banks, not 2
    constexpr int kBatch = 8;
    constexpr int kGroups = kCols / 16;  // of 4 column quads
    const int items = kpad * 4 * kGroups;
    auto at = [](int idx, int& kk, int& jq) {
      kk = (idx >> 5) / kGroups * 8 + ((idx >> 2) & 7);
      jq = 4 * ((idx >> 5) % kGroups * 4 + (idx & 3));
    };
    for (int base = threadIdx.x; base < items; base += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        int kk, jq;
        const int idx = base + i * kThreads;
        at(idx, kk, jq);
        v[i] = idx < items && kk < g.k_valid && jq < g.c_valid
                   ? __ldg(reinterpret_cast<const float4*>(w + static_cast<long long>(g.k0 + kk) * hidden + g.c0 + jq))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        int kk, jq;
        const int idx = base + i * kThreads;
        at(idx, kk, jq);
        if (idx < items) {
          ws[jq * wst + kk] = v[i].x;
          ws[(jq + 1) * wst + kk] = v[i].y;
          ws[(jq + 2) * wst + kk] = v[i].z;
          ws[(jq + 3) * wst + kk] = v[i].w;
        }
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kCols * kpad; idx += kThreads) {
    // transposed: the columns of one W row are neighbours in memory
    const int jj = kTransposed ? idx % kCols : idx / kpad;
    const int kk = kTransposed ? idx / kCols : idx % kpad;
    float v = 0.0f;
    if (jj < g.c_valid && kk < g.k_valid)
      v = kTransposed ? w[static_cast<long long>(g.k0 + kk) * hidden + g.c0 + jj]
                      : w[static_cast<long long>(g.c0 + jj) * hidden + g.k0 + kk];
    ws[jj * wst + kk] = v;
  }
}

// Stage rows [0, rows) of src (row stride `stride` floats), k in
// [kc, kc + kChunk) of the block's slice, into hs (kRows x kHStride); k past
// the slice and rows past `rows` are zero. With vec every source row starts
// 16-byte aligned and the slice holds whole quads, so quads go by cp.async;
// else by L2 loads. Does not commit.
__device__ __forceinline__ void stage_chunk(float* hs, const float* src, long long stride, int rows, int kc,
                                            const Geometry& g, bool vec) {
  constexpr int kQuads = kChunk / 4;
  for (int i = threadIdx.x; i < kRows * kQuads; i += kThreads) {
    const int r = i / kQuads, kk = kc + 4 * (i % kQuads);
    float* dst = hs + r * kHStride + 4 * (i % kQuads);
    if (r >= rows || kk >= g.k_valid) {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float* s = src + r * stride + g.k0 + kk;
    if (vec) {
      cp_async16(dst, s);
    } else {
      for (int e = 0; e < 4; ++e) dst[e] = kk + e < g.k_valid ? __ldcg(s + e) : 0.0f;
    }
  }
}

// Stage rows [0, rows) of src's reduce-slice columns [r0, r0 + r_valid)
// into dst (kRows x nred) by 4-byte cp.async (a slice of 18 columns starts
// at any float); the rest is left as it is (never read). src is not written
// during the launch. Does not commit.
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long long stride, int rows,
                                           const Geometry& g) {
  for (int i = threadIdx.x; i < rows * g.nred; i += kThreads) {
    const int r = i / g.nred, cc = i % g.nred;
    if (cc < g.r_valid) cp_async4(dst + i, src + r * stride + g.r0 + cc);
  }
}

// The block's 64 x kCols partial product src[0:rows, slice] ws^T, written to
// part (kRows x kPartStride). The epilogue's inputs, staged by the caller
// before this call and not yet committed, land with chunk 0.
__device__ void partial_product(float* part, const float* src, long long stride, int rows, const float* ws, int wst,
                                float* stage, const Geometry& g, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part_k = lane / kSliceLanes, ls = lane % kSliceLanes;
  const int rg = ls / kColGroups, cgp = ls % kColGroups;
  const int col0 = warp * kColGroups * kTileCols + cgp;  // columns col0 + kColGroups q
  float acc[kTileRows][kTileCols];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r)
#pragma unroll
    for (int q = 0; q < kTileCols; ++q) acc[r][q] = 0.0f;

  const int chunks = (wst - kSkew) / kChunk;
  stage_chunk(stage, src, stride, rows, 0, g, vec);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_chunk(stage + ((c + 1) & 1) * kRows * kHStride, src, stride, rows, (c + 1) * kChunk, g, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* hs = stage + (c & 1) * kRows * kHStride;
    const float* wc = ws + c * kChunk;
#pragma unroll
    for (int i = 0; i < kPartQuads; ++i) {
      const int kk = 4 * (part_k * kPartQuads + i);
      float4 h[kTileRows];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) h[r] = *reinterpret_cast<const float4*>(hs + (rg + 8 * r) * kHStride + kk);
#pragma unroll
      for (int q = 0; q < kTileCols; ++q) {
        const float4 wv = *reinterpret_cast<const float4*>(wc + (col0 + kColGroups * q) * wst + kk);
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          float a = acc[r][q];
          a = fmaf(h[r].x, wv.x, a);
          a = fmaf(h[r].y, wv.y, a);
          a = fmaf(h[r].z, wv.z, a);
          acc[r][q] = fmaf(h[r].w, wv.w, a);
        }
      }
    }
    __syncthreads();  // the buffer is refilled two chunks on
  }
  // the k parts folded into the first slice's lanes, which write the partial
#pragma unroll
  for (int offset = kSliceLanes; offset < 32; offset *= 2)
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
#pragma unroll
      for (int q = 0; q < kTileCols; ++q) acc[r][q] += __shfl_down_sync(0xffffffffu, acc[r][q], offset);
  if (part_k == 0) {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
#pragma unroll
      for (int q = 0; q < kTileCols; ++q) part[(rg + 8 * r) * kPartStride + col0 + kColGroups * q] = acc[r][q];
  }
}

// The sum, in rank order, of the cluster's partials at (row, column `col` of
// the cluster's), read through distributed shared memory.
__device__ __forceinline__ float cluster_sum(const cg::cluster_group& cluster, float* part, int n, int row, int col) {
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) v[r] = r < n ? cluster.map_shared_rank(part, r)[row * kPartStride + col] : 0.0f;
  float s = v[0];
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r) s += v[r];
  return s;
}

// The block's reduce slice of the cluster's partials for rows [0, rows):
// epilogue(i, row, cc, sum) for each valid output, i = row * nred + cc.
// The DSMEM loads of kReduceBatch outputs a thread are all issued before
// the first epilogue's stores (which the compiler cannot move them past).
constexpr int kReduceBatch = 5;  // ceil(64 x 18 / kThreads): every output of a 144-column cluster of 8
template <typename Epilogue>
__device__ __forceinline__ void reduce_partials(const cg::cluster_group& cluster, float* part, int rows,
                                                const Geometry& g, Epilogue epilogue) {
  const int n = rows * g.nred;
  for (int i0 = threadIdx.x; i0 < n; i0 += kReduceBatch * kThreads) {
    float s[kReduceBatch];
#pragma unroll
    for (int m = 0; m < kReduceBatch; ++m) {
      const int i = i0 + m * kThreads, cc = i % g.nred;
      s[m] = i < n && cc < g.r_valid ? cluster_sum(cluster, part, g.cluster, i / g.nred, g.r0 - g.c0 + cc) : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < kReduceBatch; ++m) {
      const int i = i0 + m * kThreads, cc = i % g.nred;
      if (i < n && cc < g.r_valid) epilogue(i, i / g.nred, cc, s[m]);
    }
  }
}

template <bool kTanh, bool kLaid>
__global__ void __launch_bounds__(kThreads, 1)
    rnn_fwd_kernel(const float* __restrict__ xp, const float* h0, const float* __restrict__ w,
                   const float* __restrict__ bias, float* y, float* h_last, int batch, int seq, int hidden,
                   int k_slice, int vec, int vec_w, Layout layout) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Geometry g = geometry(cluster, hidden, k_slice);
  const int wst = weight_stride(k_slice);
  float* ws = smem;
  float* stage = ws + kCols * wst;
  float* part = stage + 2 * kRows * kHStride;
  float* xt = part + kRows * kPartStride;  // xp at the block's reduce slice
  // the decoder's relu chain always runs forward in time into its own
  // (B, S, H) y: a constant layout, so its instance compiles to B.6's code
  const Layout out = kLaid ? layout : Layout{hidden, 0};
  load_weight_slice<false>(ws, w, hidden, g, wst, vec_w);

  const long long x_stride = static_cast<long long>(seq) * hidden;     // xp's rows
  const long long y_stride = static_cast<long long>(seq) * out.width;  // y's rows
  for (int t = 0; t < seq; ++t) {
    if (t > 0) cg::this_grid().sync();  // y[:, t - 1] is complete, in every column
    const long long tp = out.time(t, seq);
    const float* src = t == 0 ? h0 : y + out.time(t - 1, seq) * out.width;
    float* const y_t = y + tp * out.width + g.r0;  // step t's row, the block's reduce slice
    const long long stride = t == 0 ? hidden : y_stride;
    for (int r0 = 0; r0 < batch; r0 += kRows) {
      const int rows = min(kRows, batch - r0);
      stage_tile(xt, xp + r0 * x_stride + tp * hidden, x_stride, rows, g);
      partial_product(part, src + r0 * stride, stride, rows, ws, wst, stage, g, vec);
      cluster.sync();  // every partial of the cluster is written
      reduce_partials(cluster, part, rows, g, [&](int i, int row, int cc, float s) {
        const float v = activate<kTanh>(xt[i] + (s + __ldg(bias + g.r0 + cc)));
        y_t[static_cast<long long>(r0 + row) * y_stride + cc] = v;
        if (h_last && t == seq - 1) h_last[static_cast<long long>(r0 + row) * hidden + g.r0 + cc] = v;
      });
      if (r0 + kRows < batch) cluster.sync();  // the partials are read before the next tile's
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <bool kTanh, bool kLaid>
__global__ void __launch_bounds__(kThreads, 1)
    rnn_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ y, const float* __restrict__ dcarry,
                   const float* __restrict__ w, float* dpre, float* dh0, int batch, int seq, int hidden,
                   int k_slice, int vec, int vec_w, Layout layout) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Geometry g = geometry(cluster, hidden, k_slice);
  const int wst = weight_stride(k_slice);
  float* ws = smem;
  float* stage = ws + kCols * wst;
  float* part = stage + 2 * kRows * kHStride;
  float* dyt = part + kRows * kPartStride;  // dy and y at step t - 1, the block's reduce slice
  const Layout out = kLaid ? layout : Layout{hidden, 0};  // as in the forward
  float* yt = dyt + kRows * g.nred;
  load_weight_slice<true>(ws, w, hidden, g, wst, vec_w);
  const long long x_stride = static_cast<long long>(seq) * hidden;     // dpre's rows
  const long long y_stride = static_cast<long long>(seq) * out.width;  // dy's and y's rows

  // dpre_{S-1} = (dy_{S-1} + dcarry) * act'(y_{S-1}), in the block's reduce slice
  const long long last = out.time(seq - 1, seq);
  for (int i = threadIdx.x; i < batch * g.nred; i += kThreads) {
    const int row = i / g.nred, cc = i % g.nred;
    if (cc >= g.r_valid) continue;
    const long long o = static_cast<long long>(row) * y_stride + last * out.width + g.r0 + cc;
    const float gr = dy[o] + (dcarry ? dcarry[static_cast<long long>(row) * hidden + g.r0 + cc] : 0.0f);
    dpre[static_cast<long long>(row) * x_stride + last * hidden + g.r0 + cc] = gr * activation_grad<kTanh>(y[o]);
  }

  for (int t = seq - 1; t >= 0; --t) {
    cg::this_grid().sync();  // dpre[:, t] is complete, in every column
    const float* src = dpre + out.time(t, seq) * hidden;
    const long long prev = t > 0 ? out.time(t - 1, seq) : 0;
    float* const dpre_prev = dpre + prev * hidden + g.r0;  // step t - 1's row, the block's reduce slice
    for (int r0 = 0; r0 < batch; r0 += kRows) {
      const int rows = min(kRows, batch - r0);
      if (t > 0) {
        const long long at = r0 * y_stride + prev * out.width;
        stage_tile(dyt, dy + at, y_stride, rows, g);
        stage_tile(yt, y + at, y_stride, rows, g);
      }
      partial_product(part, src + r0 * x_stride, x_stride, rows, ws, wst, stage, g, vec);
      cluster.sync();
      reduce_partials(cluster, part, rows, g, [&](int i, int row, int cc, float s) {
        if (t > 0) {
          // where dh_{t-1} goes: into dpre[:, t - 1]
          const float m = activation_grad<kTanh>(yt[i]);
          dpre_prev[static_cast<long long>(r0 + row) * x_stride + cc] = (dyt[i] + s) * m;
        } else {
          dh0[static_cast<long long>(r0 + row) * hidden + g.r0 + cc] = s;
        }
      });
      if (r0 + kRows < batch) cluster.sync();
    }
  }
  cluster.sync();
}

// y[r, j] = act(xp[r, j] + h0[r, :] . W[j, :] + b[j]) for r < batch <=
// kStepRows, y's rows y_width floats apart: warp (blockIdx.x, w) owns
// column j = kStepWarps blockIdx.x + w.
template <bool kTanh>
__global__ void __launch_bounds__(kStepThreads)
    rnn_step_kernel(const float* __restrict__ xp, const float* __restrict__ h0, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y, float* __restrict__ h_last, int batch,
                    int hidden, int y_width, int vec) {
  const int lane = threadIdx.x & 31;
  const int j = static_cast<int>(blockIdx.x) * kStepWarps + (threadIdx.x >> 5);
  if (j >= hidden) return;
  const float xv = lane < batch ? xp[static_cast<long long>(lane) * hidden + j] : 0.0f;
  const float b = bias[j];
  const float* wr = w + static_cast<long long>(j) * hidden;
  float acc[kStepRows];
#pragma unroll
  for (int r = 0; r < kStepRows; ++r) acc[r] = 0.0f;
  if (vec) {
    const int quads = hidden / 4;
#pragma unroll 4
    for (int q = lane; q < quads; q += 32) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(wr) + q);
#pragma unroll
      for (int r = 0; r < kStepRows; ++r) {
        if (r < batch) {
          const float4 hv = __ldg(reinterpret_cast<const float4*>(h0 + static_cast<long long>(r) * hidden) + q);
          acc[r] = fmaf(hv.w, wv.w, fmaf(hv.z, wv.z, fmaf(hv.y, wv.y, fmaf(hv.x, wv.x, acc[r]))));
        }
      }
    }
  } else {
    for (int k = lane; k < hidden; k += 32) {
      const float wv = __ldg(wr + k);
#pragma unroll
      for (int r = 0; r < kStepRows; ++r)
        if (r < batch) acc[r] = fmaf(__ldg(h0 + static_cast<long long>(r) * hidden + k), wv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kStepRows; ++r) {
    if (r < batch) {
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], offset);
      if (lane == r) {
        const float v = activate<kTanh>(xv + (acc[r] + b));
        y[static_cast<long long>(r) * y_width + j] = v;
        if (h_last) h_last[static_cast<long long>(r) * hidden + j] = v;
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

// The plan as the wrapper made it (ops/recurrence.py RecurrencePlan).
struct Plan {
  int launch, cluster, k_slice, cols, smem;
};

int clusters_of(int hidden) { return (hidden + kCols - 1) / kCols; }

// Every cluster resident at once and one grid barrier a step: any launch
// but a forward of one step.
bool cooperative(int seq, bool backward) { return backward || seq > 1; }

// Whether the plan covers the problem with this file's geometry: the
// one-step kernel only for a forward of one step at a few rows; a sequence
// kernel's blocks of a cluster each some k and all of it together, with the
// shared memory they need.
bool plan_fits(const Plan& p, int batch, int seq, int hidden, bool backward) {
  if (p.launch == kStep)
    return !backward && seq == 1 && batch <= kStepRows && p.cluster == 1 && p.k_slice == hidden &&
           p.cols == kStepWarps && p.smem == 0;
  return p.launch == kSequence && p.cols == kCols && p.cluster >= 1 && p.cluster <= kMaxCluster &&
         kCols % p.cluster == 0 && p.k_slice > 0 && p.k_slice % 4 == 0 &&
         static_cast<long long>(p.cluster) * p.k_slice >= hidden && (p.cluster - 1) * p.k_slice < hidden &&
         p.smem >= sequence_smem_bytes(p.k_slice, p.cluster, backward);
}

// The launch configuration of a sequence kernel: a 1-D grid of clusters of
// `cluster` blocks of kThreads; cooperative (every cluster resident, grid
// barriers allowed) on request.
struct SequenceLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];

  SequenceLaunch(int blocks, int cluster, int smem, bool cooperative, cudaStream_t stream) : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = cooperative ? 2 : 1;
  }
};

// Lets `kernel` use all the shared memory a block of the current device may
// opt in to (*optin bytes).
cudaError_t allow_optin_smem(const void* kernel, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
  return err;
}

int launch_sequence(const void* kernel, const Plan& p, int hidden, bool cooperative, void** args,
                    cudaStream_t stream) {
  SequenceLaunch l(clusters_of(hidden) * p.cluster, p.cluster, p.smem, cooperative, stream);
  const cudaError_t err = cudaLaunchKernelExC(&l.cfg, kernel, args);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The cells' sequence kernels: the decoder's relu chain (B.6), the tanh
// chain (B.8), the relu chain with a layout (B.13).
enum Cell { kRelu = 0, kTanhChain = 1, kReluChain = 2 };

template <bool kTanh, bool kLaid>
const void* sequence_kernel_of(bool backward) {
  return backward ? reinterpret_cast<const void*>(rnn_bwd_kernel<kTanh, kLaid>)
                  : reinterpret_cast<const void*>(rnn_fwd_kernel<kTanh, kLaid>);
}

const void* sequence_kernel(int cell, bool backward) {
  if (cell == kTanhChain) return sequence_kernel_of<true, true>(backward);
  if (cell == kReluChain) return sequence_kernel_of<false, true>(backward);
  return cell == kRelu ? sequence_kernel_of<false, false>(backward) : nullptr;
}

// Whether a chain's layout holds its H columns: y's rows of `width` floats,
// the chain's columns [offset, offset + H) of them.
bool layout_fits(int hidden, int reverse, int width, int offset) {
  return (reverse == 0 || reverse == 1) && offset >= 0 && static_cast<long long>(offset) + hidden <= width;
}

template <bool kTanh, bool kLaid>
int forward(const void* xp, const void* h0, const void* w, const void* bias, void* y, void* h_last, int batch,
            int seq, int hidden, Layout out, int y_offset, const Plan& p, void* stream) {
  if (batch <= 0 || seq <= 0 || hidden <= 0) return static_cast<int>(cudaGetLastError());
  if (!plan_fits(p, batch, seq, hidden, false) || !layout_fits(hidden, out.reverse, out.width, y_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp_ = static_cast<const float*>(xp);
  const float* h0_ = static_cast<const float*>(h0);
  const float* w_ = static_cast<const float*>(w);
  const float* b_ = static_cast<const float*>(bias);
  float* y_ = static_cast<float*>(y) + y_offset;
  float* hl_ = static_cast<float*>(h_last);
  if (p.launch == kStep) {
    const int vec = hidden % 4 == 0 && aligned16(h0) && aligned16(w);
    const int blocks = (hidden + kStepWarps - 1) / kStepWarps;
    rnn_step_kernel<kTanh><<<blocks, kStepThreads, 0, s>>>(xp_, h0_, w_, b_, y_, hl_, batch, hidden, out.width, vec);
    return static_cast<int>(cudaGetLastError());
  }
  int vec = hidden % 4 == 0 && out.width % 4 == 0 && aligned16(h0) && aligned16(y_);
  int vec_w = hidden % 4 == 0 && aligned16(w);
  int k_slice = p.k_slice;
  void* args[] = {&xp_, &h0_, &w_, &b_, &y_, &hl_, &batch, &seq, &hidden, &k_slice, &vec, &vec_w, &out};
  return launch_sequence(reinterpret_cast<const void*>(rnn_fwd_kernel<kTanh, kLaid>), p, hidden,
                         cooperative(seq, false), args, s);
}

template <bool kTanh, bool kLaid>
int backward(const void* dy, const void* y, const void* dcarry, const void* w, void* dpre, void* dh0, int batch,
             int seq, int hidden, Layout out, int y_offset, const Plan& p, void* stream) {
  if (batch <= 0 || seq <= 0 || hidden <= 0) return static_cast<int>(cudaGetLastError());
  if (!plan_fits(p, batch, seq, hidden, true) || !layout_fits(hidden, out.reverse, out.width, y_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  int vec = hidden % 4 == 0 && aligned16(dpre);
  int vec_w = hidden % 4 == 0 && aligned16(w);
  const float* dy_ = static_cast<const float*>(dy) + y_offset;
  const float* y_ = static_cast<const float*>(y) + y_offset;
  const float* dc_ = static_cast<const float*>(dcarry);
  const float* w_ = static_cast<const float*>(w);
  float* dpre_ = static_cast<float*>(dpre);
  float* dh0_ = static_cast<float*>(dh0);
  int k_slice = p.k_slice;
  void* args[] = {&dy_, &y_, &dc_, &w_, &dpre_, &dh0_, &batch, &seq, &hidden, &k_slice, &vec, &vec_w, &out};
  return launch_sequence(reinterpret_cast<const void*>(rnn_bwd_kernel<kTanh, kLaid>), p, hidden, true, args,
                         static_cast<cudaStream_t>(stream));
}

}  // namespace

// SMs and the shared memory a block may opt in to, for the launch plan.
extern "C" int hulc_device_limits(int device, int* sms, int* smem_optin) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(err);
}

// How many clusters of `cluster` blocks the current device holds at once at
// one block per SM (all the shared memory a block may have): a cluster's
// blocks share a GPC, so this is below SMs / cluster where the GPCs' SM
// counts are not multiples of the cluster size. For the launch plan.
extern "C" int hulc_rnn_cluster_limit(int cluster, int* clusters) {
  const void* kernel = sequence_kernel(kRelu, false);
  int optin = 0;
  cudaError_t err = allow_optin_smem(kernel, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  SequenceLaunch l(cluster, cluster, optin, false, nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg);
  return static_cast<int>(err);
}

// Checks a plan once, when the wrapper makes it, against this file's
// geometry and the current device: the shared memory a block may opt in to,
// and every cluster resident at once where the launch is cooperative. Lets
// the cell's sequence kernel (relu 0, tanh 1, the relu chain with a layout
// 2) take all the shared memory a block may opt in to, so any plan that
// passed here launches.
extern "C" int hulc_rnn_check(int cell, int backward, int batch, int seq, int hidden, int launch, int cluster,
                              int k_slice, int cols, int smem) {
  const Plan p{launch, cluster, k_slice, cols, smem};
  if (batch <= 0 || seq <= 0 || hidden <= 0 || !plan_fits(p, batch, seq, hidden, backward != 0) ||
      !sequence_kernel(cell, backward != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.launch == kStep) return static_cast<int>(cudaSuccess);
  const void* kernel = sequence_kernel(cell, backward != 0);
  int optin = 0;
  cudaError_t err = allow_optin_smem(kernel, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  const int clusters = clusters_of(hidden);
  SequenceLaunch l(clusters * p.cluster, p.cluster, p.smem, false, nullptr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &l.cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1 || (cooperative(seq, backward != 0) && active < clusters))
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return static_cast<int>(cudaSuccess);
}

// The relu cell (B.6). y (B, S, H) and, when h_last is not null, y[:, S - 1]
// again as (B, H). The plan's fields follow the sizes.
extern "C" int hulc_rnn_relu_fwd(const void* xp, const void* h0, const void* w, const void* bias, void* y,
                                 void* h_last, int batch, int seq, int hidden, int launch, int cluster, int k_slice,
                                 int cols, int smem, void* stream) {
  return forward<false, false>(xp, h0, w, bias, y, h_last, batch, seq, hidden, Layout{hidden, 0}, 0,
                               Plan{launch, cluster, k_slice, cols, smem}, stream);
}

// dpre (B, S, H) and dh0 (B, H); dcarry (B, H) may be null (no gradient
// reaches the final carry). Always a cooperative sequence launch.
extern "C" int hulc_rnn_relu_bwd(const void* dy, const void* y, const void* dcarry, const void* w, void* dpre,
                                 void* dh0, int batch, int seq, int hidden, int launch, int cluster, int k_slice,
                                 int cols, int smem, void* stream) {
  return backward<false, false>(dy, y, dcarry, w, dpre, dh0, batch, seq, hidden, Layout{hidden, 0}, 0,
                                Plan{launch, cluster, k_slice, cols, smem}, stream);
}

// The tanh cell (B.8), one chain: y's rows are y_width floats a time step,
// the chain's columns [y_offset, y_offset + H) of them; reverse = 1 runs the
// chain from t = S - 1 down (B.9's reverse direction). h_last may be null.
extern "C" int hulc_rnn_tanh_fwd(const void* xp, const void* h0, const void* w, const void* bias, void* y,
                                 void* h_last, int batch, int seq, int hidden, int reverse, int y_width, int y_offset,
                                 int launch, int cluster, int k_slice, int cols, int smem, void* stream) {
  return forward<true, true>(xp, h0, w, bias, y, h_last, batch, seq, hidden, Layout{y_width, reverse}, y_offset,
                             Plan{launch, cluster, k_slice, cols, smem}, stream);
}

// The tanh chain's dh chain: dy and y in the forward's layout, dpre (B, S, H)
// in xp's time order, dh0 (B, H); dcarry may be null.
extern "C" int hulc_rnn_tanh_bwd(const void* dy, const void* y, const void* dcarry, const void* w, void* dpre,
                                 void* dh0, int batch, int seq, int hidden, int reverse, int y_width, int y_offset,
                                 int launch, int cluster, int k_slice, int cols, int smem, void* stream) {
  return backward<true, true>(dy, y, dcarry, w, dpre, dh0, batch, seq, hidden, Layout{y_width, reverse}, y_offset,
                              Plan{launch, cluster, k_slice, cols, smem}, stream);
}

// The relu cell's chain of a bidirectional layer (B.13, birnn_cell =
// "rnn"): B.6's arithmetic with the tanh chain's layout (y_width, y_offset,
// reverse) as kernel arguments. h_last may be null.
extern "C" int hulc_rnn_relu_chain_fwd(const void* xp, const void* h0, const void* w, const void* bias, void* y,
                                       void* h_last, int batch, int seq, int hidden, int reverse, int y_width,
                                       int y_offset, int launch, int cluster, int k_slice, int cols, int smem,
                                       void* stream) {
  return forward<false, true>(xp, h0, w, bias, y, h_last, batch, seq, hidden, Layout{y_width, reverse}, y_offset,
                              Plan{launch, cluster, k_slice, cols, smem}, stream);
}

// Its dh chain: dy and y in the forward's layout, dpre (B, S, H) in xp's
// time order, dh0 (B, H); dcarry may be null.
extern "C" int hulc_rnn_relu_chain_bwd(const void* dy, const void* y, const void* dcarry, const void* w, void* dpre,
                                       void* dh0, int batch, int seq, int hidden, int reverse, int y_width,
                                       int y_offset, int launch, int cluster, int k_slice, int cols, int smem,
                                       void* stream) {
  return backward<false, true>(dy, y, dcarry, w, dpre, dh0, batch, seq, hidden, Layout{y_width, reverse}, y_offset,
                               Plan{launch, cluster, k_slice, cols, smem}, stream);
}
