// The gated RNN cells of the decoder, forward and dh chain, one layer a
// launch: the gru cell (B.11) and the lstm cell (B.12).
//
// Replaces hulc_tpu/models/layers.py ScanRNN.__call__'s lax.scan for the
// "gru" and "lstm" cells (lines 239-260, scanned at :265). With the input
// projection xp (B, S, G H) already computed (b_ih in it), W = W_hh in torch
// nn.GRU / nn.LSTM layout (G H, H) and hp_t = h_{t-1} W^T + b_hh (G H):
//   gru  (G = 3, gates r, z, n):  r = sigmoid(xr + hr), z = sigmoid(xz + hz),
//        n = tanh(xn + r hn),  h_t = (1 - z) n + z h_{t-1};
//   lstm (G = 4, gates i, f, g, o):  i, f, o = sigmoid(x. + h.),
//        g = tanh(xg + hg),  c_t = f c_{t-1} + i g,  h_t = o tanh(c_t);
// from h_{-1} = h0 (and c_{-1} = c0), t = 0 .. S-1. sigmoid(x) is
// 1 / (1 + expf(-x)); tanh is the libdevice tanhf that PyTorch's CUDA tanh
// calls. No fast math.
//
// In training mode the forward also saves what the dh chain reads, per
// (b, t) a row of width kSaved H: gru [r | z | n | hn] (hn with b_hn, inside
// r * (...)), lstm [i | f | g | o | c]. The dh chain, with dh_{S-1} = dcarry
// (and dc_{S-1} = dc_carry) and gh_t = dy_t + dh_t:
//   gru:  dn = gh (1 - z), dz = gh (h_{t-1} - n), dxp_n = dn (1 - n^2),
//         dxp_r = dxp_n hn r (1 - r), dxp_z = dz z (1 - z);
//         dhp = [dxp_r, dxp_z, dxp_n r];  dh_{t-1} = gh z + dhp_t W;
//   lstm: dc = dc_t + gh o (1 - tanh^2 c_t), dxp = dhp = [dc g i (1 - i),
//         dc c_{t-1} f (1 - f), dc i (1 - g^2), gh tanh(c_t) o (1 - o)];
//         dh_{t-1} = dhp_t W, dc_{t-1} = dc f.
// The caller forms dW_hh = dhp^T [h0, y_{:-1}] as one matrix product over
// all S * B rows and db_hh as dhp's sum: no per-step weight gradients.
//
// Bound on the H100: operations. Each step is 2 B H G H fp32 FLOP that
// cannot start before every column of the step before is done; at the
// training step's B = 64, S = 32, H = 2048 that is 51.5 GFLOP a layer for
// gru (0.769 ms at 67 TFLOP/s) and 68.7 GFLOP for lstm (1.026 ms), forward
// and dh chain alike. At one serving lane it is the read of W: 50.3 MB
// (gru), 67.1 MB (lstm), 0.015 / 0.020 ms at 3.35 TB/s.
//
// W does not fit in the card's shared memory (gru 48 MiB, lstm 64 MiB; 132
// SMs x 227 KB is 29 MiB), so unlike csrc/rnn.cu's relu and tanh kernels,
// which keep a slice of W resident, these stream W through shared memory
// every step (from L2, and from HBM where it does not stay in the 50 MB L2).
//
// Sequence kernels: one persistent launch a layer, cooperative (every block
// resident, one grid-wide barrier a step) unless it is a forward of one
// step. Block c owns the kCols = 16 hidden columns [16 c, 16 c + 16) and all
// G gate columns of each, so the gate epilogue and the state update stay in
// the block, in registers.
//   * Forward: for each tile of 64 rows the block computes the 64 x 16 G
//     product h_{t-1} W[rows of its columns]^T over k in kChunk-wide chunks,
//     double-buffered with 16-byte cp.async.cg (L2 only: other blocks wrote
//     h_{t-1}); thread (tr, tc) holds rows tr + 16 i (i < 4), the G gates of
//     column tc, so its epilogue reads xp, b_hh and h_{t-1} (its own earlier
//     output) and writes y (and c, which stays the thread's own, in the
//     c_last buffer) without another exchange.
//   * dh chain: the 64 x 16 product dhp_t[rows, :] W[:, columns] over the G H
//     gate dimension, W's chunk transposed into shared memory through
//     registers, dhp_t's rows by cp.async.cg; four k-parts of 64 threads,
//     each a 4 x 4 register tile, summed in shared memory; then the same
//     (tr, tc) epilogue, which carries gh z (gru, in dh0) or dc (lstm, in
//     dc0) from step to step.
// The one-step kernel (forward, S = 1, at most kStepRows rows, no saved
// gates: a serving lane): a GEMV, not cooperative. Each warp owns one hidden
// column, reads its G rows of W with 16-byte loads (each element of W once),
// dots them with the B rows of h0, sums the lanes by shuffles and runs the
// epilogue. No TF32 and no tensor cores: the port computes in fp32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;            // a block of the sequence kernels
constexpr int kCols = 16;                // hidden columns of a block
constexpr int kRows = 64;                // batch rows per tile
constexpr int kRowGroups = 16;           // thread tr owns rows tr + 16 i
constexpr int kRowsPerThread = kRows / kRowGroups;
constexpr int kChunk = 64;               // k values staged at a time
constexpr int kStride = kChunk + 4;      // floats per staged row (bank skew)
constexpr int kParts = 4;                // k-parts of the dh chain's product
constexpr int kPartThreads = kThreads / kParts;
constexpr int kColGroups = 4;            // dh chain: thread column group cg owns columns cg + 4 c
constexpr int kColsPerThread = kCols / kColGroups;
constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kStepRows = 8;             // most rows of the one-step kernel
static_assert(kRowGroups * kCols == kThreads, "the epilogue's threads cover a 64 x 16 tile");
static_assert(kRowGroups * kColGroups * kParts == kThreads, "the dh chain's threads cover the tile k-part by k-part");
static_assert(kChunk / 4 % kParts == 0, "each k-part takes whole quads of a chunk");

enum Launch { kSequence = 0, kStep = 1 };

template <bool kLstm>
struct Cell {
  static constexpr int kGates = kLstm ? 4 : 3;
  static constexpr int kSaved = kLstm ? 5 : 4;  // gru r z n hn; lstm i f g o c
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage `n` rows of a k-major matrix (row r at src + row_of(r), k values
// [k0, k0 + kChunk) of k_total) into dst (n x kStride); rows past `valid`
// and k past k_total are zero. With vec (k_total a multiple of 4, every row
// 16-byte aligned) by 16-byte cp.async.cg, else by L2 loads. Does not commit.
template <typename RowOf>
__device__ __forceinline__ void stage_rows(float* dst, int n, int valid, int k0, int k_total, bool vec,
                                           RowOf row_of) {
  constexpr int kQuads = kChunk / 4;
  for (int i = threadIdx.x; i < n * kQuads; i += kThreads) {
    const int r = i / kQuads, kk = k0 + 4 * (i % kQuads);
    float* d = dst + r * kStride + 4 * (i % kQuads);
    if (r >= valid || kk >= k_total) {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float* s = row_of(r) + kk;
    if (vec) {
      cp_async16(d, s);
    } else {
      for (int e = 0; e < 4; ++e) d[e] = kk + e < k_total ? __ldcg(s + e) : 0.0f;
    }
  }
}

// Forward product: acc[i][g] = sum_k h[r0 + tr + 16 i, k] W[g H + c0 + tc, k]
// over k < H, for the tile's `rows` rows; h's row r at h + r * h_stride.
template <int kGates>
__device__ void forward_product(float (&acc)[kRowsPerThread][kGates], const float* h, long long h_stride, int rows,
                                const float* __restrict__ w, int hidden, int c0, bool vec_h, bool vec_w,
                                float* hs, float* ws) {
  const int tr = threadIdx.x / kCols, tc = threadIdx.x % kCols;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int g = 0; g < kGates; ++g) acc[i][g] = 0.0f;
  const int c_valid = min(kCols, hidden - c0);
  auto h_row = [&](int r) { return h + r * h_stride; };
  const int chunks = (hidden + kChunk - 1) / kChunk;
  // staged W row gg = g kCols + jj is W's row g H + c0 + jj; rows of columns
  // past hidden are zero
  auto stage_w = [&](int c, int buf) {
    float* dst = ws + buf * kGates * kCols * kStride;
    constexpr int kQuads = kChunk / 4;
    for (int i = threadIdx.x; i < kGates * kCols * kQuads; i += kThreads) {
      const int gg = i / kQuads, kk = c * kChunk + 4 * (i % kQuads);
      float* d = dst + gg * kStride + 4 * (i % kQuads);
      if (gg % kCols >= c_valid || kk >= hidden) {
        *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        continue;
      }
      const float* s = w + static_cast<long long>(gg / kCols * hidden + c0 + gg % kCols) * hidden + kk;
      if (vec_w) {
        cp_async16(d, s);
      } else {
        for (int e = 0; e < 4; ++e) d[e] = kk + e < hidden ? __ldg(s + e) : 0.0f;
      }
    }
  };
  stage_rows(hs, kRows, rows, 0, hidden, vec_h, h_row);
  stage_w(0, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      const int nb = (c + 1) & 1;
      stage_rows(hs + nb * kRows * kStride, kRows, rows, (c + 1) * kChunk, hidden, vec_h, h_row);
      stage_w(c + 1, nb);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* hc = hs + (c & 1) * kRows * kStride;
    const float* wc = ws + (c & 1) * kGates * kCols * kStride;
#pragma unroll 4
    for (int kk = 0; kk < kChunk; kk += 4) {
      float4 hv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        hv[i] = *reinterpret_cast<const float4*>(hc + (tr + kRowGroups * i) * kStride + kk);
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        const float4 wv = *reinterpret_cast<const float4*>(wc + (g * kCols + tc) * kStride + kk);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          float a = acc[i][g];
          a = fmaf(hv[i].x, wv.x, a);
          a = fmaf(hv[i].y, wv.y, a);
          a = fmaf(hv[i].z, wv.z, a);
          acc[i][g] = fmaf(hv[i].w, wv.w, a);
        }
      }
    }
    __syncthreads();  // the buffer is refilled two chunks on
  }
}

// The dh chain's product: out[r][tc] (r < 64, in red_out after the call) =
// sum_m dhp[r0 + r, m] W[m, c0 + tc] over m < G H; dhp's row r at dhp +
// r * stride. W's chunk goes through registers, transposed, into ws
// (kCols x kStride); dhp's chunk into hs by cp.async.
__device__ void backward_product(float* red, const float* dhp, long long stride, int rows, const float* __restrict__ w,
                                 int hidden, int gate_width, int c0, bool vec_h, bool vec_w, float* hs, float* ws) {
  const int part = threadIdx.x / kPartThreads, q = threadIdx.x % kPartThreads;
  const int rg = q / kColGroups, cgp = q % kColGroups;
  const int c_valid = min(kCols, hidden - c0);
  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[i][c] = 0.0f;
  auto a_row = [&](int r) { return dhp + r * stride; };
  // one quad of W's chunk a thread: row m = k0 + idx / 4, columns c0 + 4 (idx % 4) + e
  const int wk = threadIdx.x / 4, wq = threadIdx.x % 4;
  static_assert(kChunk * kCols / 4 == kThreads, "one quad of W's chunk a thread");
  auto load_w = [&](int c) {
    const int m = c * kChunk + wk, j = 4 * wq;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m < gate_width) {
      const float* s = w + static_cast<long long>(m) * hidden + c0 + j;
      if (vec_w) {
        if (j < c_valid) v = __ldg(reinterpret_cast<const float4*>(s));
      } else {
        v.x = j < c_valid ? __ldg(s) : 0.0f;
        v.y = j + 1 < c_valid ? __ldg(s + 1) : 0.0f;
        v.z = j + 2 < c_valid ? __ldg(s + 2) : 0.0f;
        v.w = j + 3 < c_valid ? __ldg(s + 3) : 0.0f;
      }
    }
    return v;
  };
  auto store_w = [&](float4 v, int buf) {
    float* d = ws + buf * kCols * kStride + 4 * wq * kStride + wk;
    d[0] = v.x;
    d[kStride] = v.y;
    d[2 * kStride] = v.z;
    d[3 * kStride] = v.w;
  };
  const int chunks = (gate_width + kChunk - 1) / kChunk;
  stage_rows(hs, kRows, rows, 0, gate_width, vec_h, a_row);
  cp_async_commit();
  store_w(load_w(0), 0);
  for (int c = 0; c < chunks; ++c) {
    float4 next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c + 1 < chunks) {
      stage_rows(hs + ((c + 1) & 1) * kRows * kStride, kRows, rows, (c + 1) * kChunk, gate_width, vec_h, a_row);
      cp_async_commit();
      next = load_w(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ac = hs + (c & 1) * kRows * kStride;
    const float* bc = ws + (c & 1) * kCols * kStride;
#pragma unroll
    for (int qq = 0; qq < kChunk / 4 / kParts; ++qq) {
      const int kk = 4 * (part * (kChunk / 4 / kParts) + qq);
      float4 av[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        av[i] = *reinterpret_cast<const float4*>(ac + (rg + kRowGroups * i) * kStride + kk);
#pragma unroll
      for (int cc = 0; cc < kColsPerThread; ++cc) {
        const float4 bv = *reinterpret_cast<const float4*>(bc + (cgp + kColGroups * cc) * kStride + kk);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          float a = acc[i][cc];
          a = fmaf(av[i].x, bv.x, a);
          a = fmaf(av[i].y, bv.y, a);
          a = fmaf(av[i].z, bv.z, a);
          acc[i][cc] = fmaf(av[i].w, bv.w, a);
        }
      }
    }
    if (c + 1 < chunks) store_w(next, (c + 1) & 1);  // that buffer's last reader finished a barrier ago
    __syncthreads();
  }
  // the k-parts' partials, summed in a fixed order by the caller
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int cc = 0; cc < kColsPerThread; ++cc)
      red[(part * kRows + rg + kRowGroups * i) * kCols + cgp + kColGroups * cc] = acc[i][cc];
  __syncthreads();
}

__device__ __forceinline__ float part_sum(const float* red, int row, int col) {
  float s = red[row * kCols + col];
#pragma unroll
  for (int p = 1; p < kParts; ++p) s += red[(p * kRows + row) * kCols + col];
  return s;
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

// Dynamic shared memory of a sequence kernel: forward, two chunk buffers of
// h and of the G kCols rows of W; dh chain, two of dhp and of W's
// transposed chunk, and the k-parts' partial sums.
template <bool kLstm>
int sequence_smem_bytes(bool backward) {
  constexpr int g = Cell<kLstm>::kGates;
  const int floats = backward ? 2 * kRows * kStride + 2 * kCols * kStride + kParts * kRows * kCols
                              : 2 * kRows * kStride + 2 * g * kCols * kStride;
  return static_cast<int>(sizeof(float)) * floats;
}

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float* xp;    // (B, S, G H)
  const float* h0;    // (B, H)
  const float* c0;    // (B, H), lstm
  const float* w;     // (G H, H)
  const float* bias;  // (G H)
  float* y;           // (B, S, H)
  float* h_last;      // (B, H)
  float* c_last;      // (B, H), lstm: also the running c
  float* saved;       // (B, S, kSaved H) or null
  int batch, seq, hidden, vec_h, vec_w;
};

// The gate math of one (row, column): x, hp the G pre-activations' two
// halves (hp with b_hh); returns h_t, writes c_t and the saved row.
template <bool kLstm>
__device__ __forceinline__ float cell_step(const float (&x)[Cell<kLstm>::kGates], const float (&hp)[Cell<kLstm>::kGates],
                                           float h_prev, float c_prev, float* c_out, float* saved, int hidden) {
  if constexpr (kLstm) {
    const float i = sigmoid(x[0] + hp[0]);
    const float f = sigmoid(x[1] + hp[1]);
    const float g = tanhf(x[2] + hp[2]);
    const float o = sigmoid(x[3] + hp[3]);
    const float c = f * c_prev + i * g;
    *c_out = c;
    if (saved) {
      saved[0] = i;
      saved[hidden] = f;
      saved[2 * hidden] = g;
      saved[3 * hidden] = o;
      saved[4 * hidden] = c;
    }
    return o * tanhf(c);
  } else {
    const float r = sigmoid(x[0] + hp[0]);
    const float z = sigmoid(x[1] + hp[1]);
    const float n = tanhf(x[2] + r * hp[2]);
    if (saved) {
      saved[0] = r;
      saved[hidden] = z;
      saved[2 * hidden] = n;
      saved[3 * hidden] = hp[2];
    }
    return (1.0f - z) * n + z * h_prev;
  }
}

template <bool kLstm>
__global__ void __launch_bounds__(kThreads, 1) gated_fwd_kernel(FwdArgs a) {
  using C = Cell<kLstm>;
  constexpr int G = C::kGates;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;
  float* ws = hs + 2 * kRows * kStride;
  const int H = a.hidden, S = a.seq;
  const int c0 = static_cast<int>(blockIdx.x) * kCols;
  const int tr = threadIdx.x / kCols, tc = threadIdx.x % kCols;
  const int j = c0 + tc;
  const long long gh = static_cast<long long>(G) * H;
  for (int t = 0; t < S; ++t) {
    if (t > 0) cg::this_grid().sync();  // y[:, t - 1] is complete, in every column
    for (int r0 = 0; r0 < a.batch; r0 += kRows) {
      const int rows = min(kRows, a.batch - r0);
      const float* h = t == 0 ? a.h0 + static_cast<long long>(r0) * H
                              : a.y + (static_cast<long long>(r0) * S + t - 1) * H;
      const long long h_stride = t == 0 ? H : static_cast<long long>(S) * H;
      float acc[kRowsPerThread][G];
      forward_product<G>(acc, h, h_stride, rows, a.w, H, c0, a.vec_h, a.vec_w, hs, ws);
      if (j >= H) continue;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int b = r0 + tr + kRowGroups * i;
        if (b >= a.batch) continue;
        const long long bt = static_cast<long long>(b) * S + t;
        float x[G], hp[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          x[g] = a.xp[bt * gh + g * H + j];
          hp[g] = acc[i][g] + __ldg(a.bias + g * H + j);
        }
        const float h_prev = t == 0 ? a.h0[static_cast<long long>(b) * H + j] : a.y[(bt - 1) * H + j];
        float c_prev = 0.0f;
        if (kLstm) c_prev = t == 0 ? a.c0[static_cast<long long>(b) * H + j] : a.c_last[static_cast<long long>(b) * H + j];
        float c = 0.0f;
        float* sv = a.saved ? a.saved + bt * C::kSaved * H + j : nullptr;
        const float v = cell_step<kLstm>(x, hp, h_prev, c_prev, &c, sv, H);
        a.y[bt * H + j] = v;
        if (kLstm) a.c_last[static_cast<long long>(b) * H + j] = c;
        if (t == S - 1) a.h_last[static_cast<long long>(b) * H + j] = v;
      }
    }
  }
}

// One step (S = 1) at batch <= kStepRows, no saved gates: warp (blockIdx.x,
// w) owns hidden column j = kStepWarps blockIdx.x + w and its G rows of W.
template <bool kLstm>
__global__ void __launch_bounds__(kStepThreads) gated_step_kernel(FwdArgs a) {
  constexpr int G = Cell<kLstm>::kGates;
  const int lane = threadIdx.x & 31;
  const int H = a.hidden;
  const int j = static_cast<int>(blockIdx.x) * kStepWarps + (threadIdx.x >> 5);
  if (j >= H) return;
  float acc[G][kStepRows];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int r = 0; r < kStepRows; ++r) acc[g][r] = 0.0f;
  if (a.vec_h && a.vec_w) {
    const int quads = H / 4;
    for (int q = lane; q < quads; q += 32) {
      float4 hv[kStepRows];
#pragma unroll
      for (int r = 0; r < kStepRows; ++r)
        hv[r] = r < a.batch ? __ldg(reinterpret_cast<const float4*>(a.h0 + static_cast<long long>(r) * H) + q)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(a.w + static_cast<long long>(g * H + j) * H) + q);
#pragma unroll
        for (int r = 0; r < kStepRows; ++r)
          acc[g][r] = fmaf(hv[r].w, wv.w, fmaf(hv[r].z, wv.z, fmaf(hv[r].y, wv.y, fmaf(hv[r].x, wv.x, acc[g][r]))));
      }
    }
  } else {
    for (int k = lane; k < H; k += 32) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float wv = __ldg(a.w + static_cast<long long>(g * H + j) * H + k);
#pragma unroll
        for (int r = 0; r < kStepRows; ++r)
          if (r < a.batch) acc[g][r] = fmaf(__ldg(a.h0 + static_cast<long long>(r) * H + k), wv, acc[g][r]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int r = 0; r < kStepRows; ++r)
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], offset);
#pragma unroll
  for (int r = 0; r < kStepRows; ++r) {
    if (r < a.batch && lane == r) {
      const long long gh = static_cast<long long>(G) * H;
      float x[G], hp[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        x[g] = a.xp[r * gh + g * H + j];
        hp[g] = acc[g][r] + a.bias[g * H + j];
      }
      const long long o = static_cast<long long>(r) * H + j;
      float c = 0.0f;
      const float v = cell_step<kLstm>(x, hp, a.h0[o], kLstm ? a.c0[o] : 0.0f, &c, nullptr, H);
      a.y[o] = v;
      a.h_last[o] = v;
      if (kLstm) a.c_last[o] = c;
    }
  }
}

// ---------------------------------------------------------------------------
// the dh chain
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float* dy;        // (B, S, H)
  const float* dh_last;   // (B, H) or null
  const float* dc_last;   // (B, H) or null, lstm
  const float* y;         // (B, S, H), gru
  const float* h0;        // (B, H), gru
  const float* c0;        // (B, H), lstm
  const float* saved;     // (B, S, kSaved H)
  const float* w;         // (G H, H)
  float* dxp;             // (B, S, G H)
  float* dhp;             // (B, S, G H); gru only (lstm: dhp is dxp)
  float* dh0;             // (B, H); gru: carries gh z between steps
  float* dc0;             // (B, H), lstm: carries dc between steps
  int batch, seq, hidden, vec_h, vec_w;
};

// Step t's gate gradients at (b, j) from gh = dy_t + dh_t: writes dxp and
// dhp at (b, t) and the carry to step t - 1 (gru: gh z into dh0; lstm: dc f
// into dc0, from dc_in).
template <bool kLstm>
__device__ __forceinline__ void cell_grad(const BwdArgs& a, int b, int t, int j, float gh_) {
  using C = Cell<kLstm>;
  const int H = a.hidden, S = a.seq;
  const long long bt = static_cast<long long>(b) * S + t;
  const long long o = bt * C::kGates * H + j;
  const float* sv = a.saved + bt * C::kSaved * H + j;
  const long long bj = static_cast<long long>(b) * H + j;
  if constexpr (kLstm) {
    const float i = sv[0], f = sv[H], g = sv[2 * H], og = sv[3 * H], c = sv[4 * H];
    const float c_prev = t > 0 ? sv[4 * H - static_cast<long long>(C::kSaved) * H] : a.c0[bj];
    const float tc = tanhf(c);
    const float dc = a.dc0[bj] + gh_ * og * (1.0f - tc * tc);
    a.dxp[o] = dc * g * (i * (1.0f - i));
    a.dxp[o + H] = dc * c_prev * (f * (1.0f - f));
    a.dxp[o + 2 * H] = dc * i * (1.0f - g * g);
    a.dxp[o + 3 * H] = gh_ * tc * (og * (1.0f - og));
    a.dc0[bj] = dc * f;
  } else {
    const float r = sv[0], z = sv[H], n = sv[2 * H], hn = sv[3 * H];
    const float h_prev = t > 0 ? a.y[(bt - 1) * H + j] : a.h0[bj];
    const float dn = gh_ * (1.0f - z);
    const float dz = gh_ * (h_prev - n);
    const float dpn = dn * (1.0f - n * n);
    const float dpr = dpn * hn * (r * (1.0f - r));
    const float dpz = dz * (z * (1.0f - z));
    a.dxp[o] = dpr;
    a.dxp[o + H] = dpz;
    a.dxp[o + 2 * H] = dpn;
    a.dhp[o] = dpr;
    a.dhp[o + H] = dpz;
    a.dhp[o + 2 * H] = dpn * r;
    a.dh0[bj] = gh_ * z;
  }
}

template <bool kLstm>
__global__ void __launch_bounds__(kThreads, 1) gated_bwd_kernel(BwdArgs a) {
  using C = Cell<kLstm>;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;
  float* ws = hs + 2 * kRows * kStride;
  float* red = ws + 2 * kCols * kStride;
  const int H = a.hidden, S = a.seq;
  const int gate_width = C::kGates * H;
  const int c0 = static_cast<int>(blockIdx.x) * kCols;
  const int tr = threadIdx.x / kCols, tc = threadIdx.x % kCols;
  const int j = c0 + tc;
  const float* dhp = kLstm ? a.dxp : a.dhp;

  // step S - 1 from the carry's gradients
  if (j < H) {
    for (int b = tr; b < a.batch; b += kRowGroups) {
      const long long bj = static_cast<long long>(b) * H + j;
      if (kLstm) a.dc0[bj] = a.dc_last ? a.dc_last[bj] : 0.0f;
      const float gh_ = a.dy[(static_cast<long long>(b) * S + S - 1) * H + j] + (a.dh_last ? a.dh_last[bj] : 0.0f);
      cell_grad<kLstm>(a, b, S - 1, j, gh_);
    }
  }
  for (int t = S - 1; t >= 0; --t) {
    cg::this_grid().sync();  // dhp[:, t] is complete, in every column
    for (int r0 = 0; r0 < a.batch; r0 += kRows) {
      const int rows = min(kRows, a.batch - r0);
      backward_product(red, dhp + (static_cast<long long>(r0) * S + t) * gate_width,
                       static_cast<long long>(S) * gate_width, rows, a.w, H, gate_width, c0, a.vec_h, a.vec_w, hs,
                       ws);
      if (j < H) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int b = r0 + tr + kRowGroups * i;
          if (b >= a.batch) continue;
          const long long bj = static_cast<long long>(b) * H + j;
          // gru: dh_{t-1} = gh_t z_t (carried in dh0) + dhp_t W; lstm: dhp_t W
          const float dh = part_sum(red, tr + kRowGroups * i, tc) + (kLstm ? 0.0f : a.dh0[bj]);
          if (t > 0) {
            cell_grad<kLstm>(a, b, t - 1, j, a.dy[(static_cast<long long>(b) * S + t - 1) * H + j] + dh);
          } else {
            a.dh0[bj] = dh;
          }
        }
      }
      __syncthreads();  // red is rewritten by the next tile's product
    }
  }
}

// ---------------------------------------------------------------------------
// plans and entry points
// ---------------------------------------------------------------------------

// The plan as the wrapper made it (ops/recurrence.py GatedPlan).
struct Plan {
  int launch, cols, smem;
};

int blocks_of(const Plan& p, int hidden) { return (hidden + p.cols - 1) / p.cols; }

// Every block resident at once and one grid barrier a step: any launch but
// a forward of one step.
bool cooperative(int seq, bool backward) { return backward || seq > 1; }

template <bool kLstm>
bool plan_fits(const Plan& p, int batch, int seq, int hidden, bool backward, bool saves) {
  if (p.launch == kStep)
    return !backward && !saves && seq == 1 && batch <= kStepRows && p.cols == kStepWarps && p.smem == 0;
  return p.launch == kSequence && p.cols == kCols && p.smem >= sequence_smem_bytes<kLstm>(backward);
}

template <bool kLstm>
const void* kernel_of(int launch, bool backward) {
  if (backward) return reinterpret_cast<const void*>(gated_bwd_kernel<kLstm>);
  return launch == kStep ? reinterpret_cast<const void*>(gated_step_kernel<kLstm>)
                         : reinterpret_cast<const void*>(gated_fwd_kernel<kLstm>);
}

template <bool kLstm>
int check(int backward, int saves, int batch, int seq, int hidden, const Plan& p) {
  if (batch <= 0 || seq <= 0 || hidden <= 0 || !plan_fits<kLstm>(p, batch, seq, hidden, backward != 0, saves != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.launch == kStep) return static_cast<int>(cudaSuccess);
  const void* kernel = kernel_of<kLstm>(p.launch, backward != 0);
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1 || (cooperative(seq, backward != 0) && per_sm * sms < blocks_of(p, hidden)))
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return static_cast<int>(cudaSuccess);
}

int launch(const void* kernel, const Plan& p, int hidden, bool coop, void* arg, cudaStream_t stream) {
  void* args[] = {arg};
  const dim3 grid(static_cast<unsigned>(blocks_of(p, hidden)));
  const dim3 block(static_cast<unsigned>(p.launch == kStep ? kStepThreads : kThreads));
  const cudaError_t err = coop ? cudaLaunchCooperativeKernel(kernel, grid, block, args, p.smem, stream)
                               : cudaLaunchKernel(kernel, grid, block, args, p.smem, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <bool kLstm>
int forward(FwdArgs a, const Plan& p, void* stream) {
  if (a.batch <= 0 || a.seq <= 0 || a.hidden <= 0) return static_cast<int>(cudaGetLastError());
  if (!plan_fits<kLstm>(p, a.batch, a.seq, a.hidden, false, a.saved != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.vec_h = a.hidden % 4 == 0 && aligned16(a.h0) && aligned16(a.y);
  a.vec_w = a.hidden % 4 == 0 && aligned16(a.w);
  return launch(kernel_of<kLstm>(p.launch, false), p, a.hidden, p.launch == kSequence && cooperative(a.seq, false),
                &a, static_cast<cudaStream_t>(stream));
}

template <bool kLstm>
int backward(BwdArgs a, const Plan& p, void* stream) {
  if (a.batch <= 0 || a.seq <= 0 || a.hidden <= 0) return static_cast<int>(cudaGetLastError());
  if (!plan_fits<kLstm>(p, a.batch, a.seq, a.hidden, true, false)) return static_cast<int>(cudaErrorInvalidValue);
  a.vec_h = a.hidden % 4 == 0 && aligned16(kLstm ? a.dxp : a.dhp);
  a.vec_w = a.hidden % 4 == 0 && aligned16(a.w);
  return launch(kernel_of<kLstm>(p.launch, true), p, a.hidden, true, &a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Checks a plan once, when the wrapper makes it, against this file's
// geometry and the current device (every block resident at once where the
// launch is cooperative), and lets the sequence kernel take the shared
// memory the plan gives it. lstm 1 for B.12, 0 for B.11; saves 1 for a
// training forward.
extern "C" int hulc_rnn_gated_check(int lstm, int backward, int saves, int batch, int seq, int hidden, int launch,
                                    int cols, int smem) {
  const Plan p{launch, cols, smem};
  return lstm ? check<true>(backward, saves, batch, seq, hidden, p) : check<false>(backward, saves, batch, seq, hidden, p);
}

// B.11 forward: y (B, S, H), h_last (B, H); saved (B, S, 4 H) [r | z | n | hn]
// in training mode, else null.
extern "C" int hulc_rnn_gru_fwd(const void* xp, const void* h0, const void* w, const void* bias, void* y,
                                void* h_last, void* saved, int batch, int seq, int hidden, int launch, int cols,
                                int smem, void* stream) {
  FwdArgs a{static_cast<const float*>(xp), static_cast<const float*>(h0), nullptr, static_cast<const float*>(w),
            static_cast<const float*>(bias), static_cast<float*>(y), static_cast<float*>(h_last), nullptr,
            static_cast<float*>(saved), batch, seq, hidden, 0, 0};
  return forward<false>(a, Plan{launch, cols, smem}, stream);
}

// B.11 dh chain: dxp and dhp (B, S, 3 H), dh0 (B, H); dh_last may be null.
extern "C" int hulc_rnn_gru_bwd(const void* dy, const void* dh_last, const void* y, const void* h0, const void* saved,
                                const void* w, void* dxp, void* dhp, void* dh0, int batch, int seq, int hidden,
                                int launch, int cols, int smem, void* stream) {
  BwdArgs a{static_cast<const float*>(dy), static_cast<const float*>(dh_last), nullptr, static_cast<const float*>(y),
            static_cast<const float*>(h0), nullptr, static_cast<const float*>(saved), static_cast<const float*>(w),
            static_cast<float*>(dxp), static_cast<float*>(dhp), static_cast<float*>(dh0), nullptr,
            batch, seq, hidden, 0, 0};
  return backward<false>(a, Plan{launch, cols, smem}, stream);
}

// B.12 forward: y (B, S, H), h_last and c_last (B, H); saved (B, S, 5 H)
// [i | f | g | o | c] in training mode, else null.
extern "C" int hulc_rnn_lstm_fwd(const void* xp, const void* h0, const void* c0, const void* w, const void* bias,
                                 void* y, void* h_last, void* c_last, void* saved, int batch, int seq, int hidden,
                                 int launch, int cols, int smem, void* stream) {
  FwdArgs a{static_cast<const float*>(xp), static_cast<const float*>(h0), static_cast<const float*>(c0),
            static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(y),
            static_cast<float*>(h_last), static_cast<float*>(c_last), static_cast<float*>(saved),
            batch, seq, hidden, 0, 0};
  return forward<true>(a, Plan{launch, cols, smem}, stream);
}

// B.12 dh / dc chain: dpre (B, S, 4 H) (the gradient of xp and of hp alike),
// dh0 and dc0 (B, H); dh_last and dc_last may be null.
extern "C" int hulc_rnn_lstm_bwd(const void* dy, const void* dh_last, const void* dc_last, const void* saved,
                                 const void* c0, const void* w, void* dpre, void* dh0, void* dc0, int batch, int seq,
                                 int hidden, int launch, int cols, int smem, void* stream) {
  BwdArgs a{static_cast<const float*>(dy), static_cast<const float*>(dh_last), static_cast<const float*>(dc_last),
            nullptr, nullptr, static_cast<const float*>(c0), static_cast<const float*>(saved),
            static_cast<const float*>(w), static_cast<float*>(dpre), nullptr, static_cast<float*>(dh0),
            static_cast<float*>(dc0), batch, seq, hidden, 0, 0};
  return backward<true>(a, Plan{launch, cols, smem}, stream);
}
