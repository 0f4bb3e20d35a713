// The gated RNN cells, forward and dh chain, one chain a launch: the
// decoder's gru cell (B.11) and lstm cell (B.12), and the gru chain of a
// bidirectional layer (B.13, the plan recognition's birnn_cell = "gru").
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
// A bidirectional gru layer (layers.py:284-313 ScanBiRNN) is two launches
// of the gru kernels into one (B, S, 2H) output, as csrc/rnn.cu's tanh and
// relu chains: the kernels are templates on kLaid, and a laid chain's y
// (and dy) rows are y_width floats a time step, its columns from the
// pointer it is given (y_offset), its step t at row time(t) = S - 1 - t
// for the reverse chain. Its xp, saved gates, dxp and dhp are its own
// (B, S, G H) / (B, S, 4H) tensors in xp's time order, row time(t) too;
// h_{t-1} is y's row time(t - 1), staged by the TMA unit from a 3-D view
// of y with the time stride y_width and the batch stride S y_width. The
// decoder's instances (kLaid false) compile with the constant layout (H,
// forward). A laid chain never takes the one-step launch.
//
// Bound on the H100: operations. Each step is 2 B H G H fp32 FLOP that
// cannot start before every column of the step before is done; at the
// training step's B = 64, S = 32, H = 2048 that is 51.5 GFLOP a layer for
// gru (0.769 ms at 67 TFLOP/s) and 68.7 GFLOP for lstm (1.026 ms), forward
// and dh chain alike. At one serving lane it is the read of W: 50.3 MB
// (gru), 67.1 MB (lstm), 0.015 / 0.020 ms at 3.35 TB/s.
//
// The launch plan (which kernel, cluster size, k-slice, columns, ring
// stages, shared memory) is made in Python (ops/recurrence.py gated_plan),
// checked once against this file's geometry and the card
// (hulc_rnn_gated_check), and handed to the entry points, which derive the
// grid from it and refuse a plan that does not cover the problem.
//
// Sequence kernels (any launch but a forward of one step at a few rows):
// split-K over thread-block clusters, as csrc/rnn.cu's relu and tanh
// kernels, with W streamed instead of resident.
//   * A cluster owns a run of hidden columns and all G gate columns of
//     each; its block of rank r owns a k-slice, a whole number of chunks: in
//     the forward [r ks, (r + 1) ks) of H (h_{t-1}'s columns, W's), in the
//     dh chain of the gate dimension G H (dhp_t's columns, W's rows). At H
//     = 2048 the plan takes for the forward clusters of 2 over kFwdCols =
//     32 columns (64 of them on 128 SMs; the H100 holds 66 clusters of 2 at
//     one block per SM), ks = 1024, in chunks of 128 (gru) / 64 (lstm) k;
//     for the dh chain clusters of 4 over kCols = 72 columns (29 on 116 SMs;
//     30 fit), ks = 1536 (gru) / 2048 (lstm), in chunks of 128. Per step a
//     block stages only its slice of h_{t-1} (256 KiB at B = 64) or of dhp_t
//     (384 / 512 KiB), where a block of the first design staged all of it
//     (512 KiB, 1.5 / 2 MiB).
//   * W does not fit in the card's shared memory (gru 48 MiB, lstm 64 MiB;
//     132 SMs x 227 KB is 29 MiB), so each block streams its tile of W (G 32
//     x 1024 forward: 384 / 512 KiB; 72 x 1536 / 2048 backward: 432 / 576
//     KiB) every step, through a ring of chunk buffers kStages - 1 chunks
//     ahead of the FMAs.
//     The dh chain reads W^T (H, G H), which the launch writes first into
//     a scratch the caller gives (gated_transpose_kernel, 64 x 64 tiles
//     through shared memory: 2 x 48 / 64 MiB of traffic, some 0.04 ms), so
//     that both of its operands, like the forward's, run along k. One
//     thread fills the ring by the Tensor Memory Accelerator: per chunk one
//     2-D box of W a gate (forward; one of W^T backward) and a box
//     of the state (3-D views of y and dhp: k, time step, batch row),
//     completing on the stage's mbarriers; boxes past a tensor's end read
//     as zeros. The tile is the same every step, so the ring runs on across
//     the step's end: the next step's first chunks of W are in flight while
//     the block reduces its partials and waits at the grid barrier; only
//     their share of the state (which the barrier guards) is issued after
//     it. A box row is 4 floats wider than the chunk (the next chunk's first
//     quad, never read), so the staged rows are skewed by 4 banks and the
//     FMA loop's 16-byte loads fall on distinct banks. Only where rows are
//     not 16-byte aligned (H not a multiple of 4, a misaligned view) does
//     every thread fill the same layout by plain loads instead; a map the
//     driver refuses elsewhere fails the launch.
//   * The FMAs, fp32: lane (rg, cgp) of a warp a register tile of the
//     block's 64-row partial (rows rg + 8 i, columns cgp + 4 q of the
//     warp's), both operands read as float4 along k (eight lanes share a
//     row of each: broadcast loads). Forward: 8 x 8 tiles, 32 gate columns
//     a warp, G warps over the block's G 32; backward: 8 x 9, 36 hidden
//     columns a warp, 2 over the 72. The warps are k-groups that take equal
//     parts of each chunk, their tiles summed in shared memory in a fixed
//     order: gru's forward four groups of three warps, lstm's two of four,
//     the dh chain four of two (8 or 12 warps: each of an SM's four
//     schedulers gets the same number).
//   * The cluster's partials are summed through distributed shared memory:
//     block r adds, in rank order (deterministic), the partials of its
//     reduce slice, the quads of 4 hidden columns [Q r / n, Q (r + 1) / n)
//     of the cluster's Q with all their G gates, so the gate math
//     (cell_step, cell_grad4) and lstm's c stay in one thread: forward + xp
//     + b_hh, the cell, y (and c, the saved gates, h_last); backward the
//     gate gradients of step t - 1 (dxp, dhp, the carries). A thread takes
//     a quad at a time, every load and store 16 bytes (where H is a
//     multiple of 4 and the tensors aligned; else element by element), and
//     loads the inputs of a batch of its quads before the first store.
//   * One grid-wide barrier per step (cooperative launch with a cluster
//     dimension); a forward of one step at more rows is not cooperative.
// The one-step kernel (forward, S = 1, at most kStepRows rows, no saved
// gates: a serving lane): a GEMV, not cooperative. Each warp owns one hidden
// column, reads its G rows of W with 16-byte loads (each element of W once),
// dots them with the B rows of h0, sums the lanes by shuffles and runs the
// epilogue. No TF32 and no tensor cores: the port computes in fp32.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;          // batch rows per tile
constexpr int kCols = 72;          // hidden columns of a cluster of the dh chain
constexpr int kFwdCols = 32;       // of the forward
constexpr int kMaxCluster = 4;     // the largest cluster the plan takes
constexpr int kTileRows = 8;       // a lane's rows: rg + 8 i
constexpr int kSkew = 4;           // floats a staged row is wider than its data: bank skew
constexpr int kAlign = 128;        // a box's alignment in shared memory, bytes
// the forward: chunks of h's k-slice (Cell::kFwdChunk k values at a time)
constexpr int kColGroups = 4;                   // cgp: a lane's columns cgp + 4 q of its warp's
constexpr int kFwdTileCols = 8;                 // the forward's lanes: 8 columns, 32 a warp
constexpr int kTileCols = 9;                    // the dh chain's: 9 columns, 36 a warp
constexpr int kWarpCols = kColGroups * kTileCols;  // partial columns of a warp of the dh chain
// the dh chain: chunks of the gate dimension's k-slice
constexpr int kBwdChunk = 128;                  // k values staged at a time
constexpr int kBwdStride = kBwdChunk + kSkew;   // floats per staged row (dhp and W^T)
constexpr int kBwdGroups = 4;                   // k-groups of warps
constexpr int kBwdGroupWarps = kCols / kWarpCols;
constexpr int kBwdThreads = 32 * kBwdGroupWarps * kBwdGroups;
constexpr int kBwdStages = 2;
constexpr int kBwdDhpFloats = kRows * kBwdStride;
constexpr int kBwdStageFloats = kBwdDhpFloats + kCols * kBwdStride;  // dhp's box, then W^T's
constexpr int kBwdPartStride = kCols + kSkew;
constexpr int kBwdBatch = (kRows * ((kCols / 4 + kMaxCluster - 1) / kMaxCluster) + kBwdThreads - 1) / kBwdThreads;
// the one-step GEMV
constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kStepRows = 8;             // most rows of the one-step kernel
static_assert(kBwdDhpFloats * 4 % kAlign == 0 && kCols * kBwdStride * 4 % kAlign == 0, "every box starts aligned");
static_assert(kCols % kWarpCols == 0 && kFwdCols % (kColGroups * kFwdTileCols) == 0,
              "warps tile a cluster's columns");
static_assert(kTileRows * 8 == kRows, "lane (rg, .) covers the tile's rows");
static_assert(kBwdChunk / 4 % kBwdGroups == 0, "each k-group takes whole quads of a chunk");

enum Launch { kSequence = 0, kStep = 1 };

template <bool kLstm>
struct Cell {
  static constexpr int kGates = kLstm ? 4 : 3;
  static constexpr int kSaved = kLstm ? 5 : 4;  // gru r z n hn; lstm i f g o c
  static constexpr int kGateCols = kGates * kFwdCols;        // the forward's partial columns
  static constexpr int kGroupWarps = kGateCols / (kColGroups * kFwdTileCols);  // warps of a k-group
  static constexpr int kGroups = kLstm ? 2 : 4;              // k-groups of the forward
  static constexpr int kFwdThreads = 32 * kGroupWarps * kGroups;
  // k values staged at a time and ring stages: as many as shared memory holds beside the partial
  static constexpr int kFwdChunk = kLstm ? 64 : 128;
  static constexpr int kFwdStages = kLstm ? 3 : 2;
  static constexpr int kFwdStride = kFwdChunk + kSkew;  // floats per staged row (h and W)
  static constexpr int kFwdStageFloats = (kRows + kGateCols) * kFwdStride;  // h's box, then W's, a gate each
  static constexpr int kPartStride = kGateCols + kSkew;
  static constexpr int kFwdBatch = (kRows * kFwdCols / 4 / 2 + kFwdThreads - 1) / kFwdThreads;  // at clusters of 2
  static_assert(kRows * kFwdStride * 4 % kAlign == 0 && kFwdCols * kFwdStride * 4 % kAlign == 0,
                "boxes stay aligned");
  static_assert(kFwdChunk / 4 % kGroups == 0, "each k-group takes whole quads of a chunk");
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(float4& v, int e, float x) {
  if (e == 0) v.x = x;
  if (e == 1) v.y = x;
  if (e == 2) v.z = x;
  if (e == 3) v.w = x;
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The n (<= 4) floats from p: one 16-byte load where vec and n == 4, else
// element by element; the lanes past n zero.
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n == 4) return *reinterpret_cast<const float4*>(p);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = 0; e < n; ++e) set_lane(v, e, p[e]);
  return v;
}

__device__ __forceinline__ void store4(float* p, const float4& v, int n, bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  for (int e = 0; e < n; ++e) p[e] = lane_of(v, e);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Arrives on bar, announcing `bytes` of copies that complete on it.
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Waits until bar's phase of parity `parity` has completed. A phase that
// never completes is a fault of the ring's protocol: the kernel traps after
// 2^32 clocks (about two seconds) instead of holding the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  for (const long long start = clock64(); !done;) {
    if (clock64() - start > (1ll << 32)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A box of `map` at coordinates (x, y[, z]) into shared memory at dst
// (128-byte aligned), completing on bar.
__device__ __forceinline__ void tma_2d(float* dst, const CUtensorMap& map, int x, int y, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(&map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_3d(float* dst, const CUtensorMap& map, int x, int y, int z,
                                       unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(&map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}

// Orders the state the block's barrier-synchronized threads stored (which
// the next boxes read) before the async proxy's copies that this thread
// issues next.
__device__ __forceinline__ void fence_proxy_global() { asm volatile("fence.proxy.async.global;\n" ::: "memory"); }

// Fills `rows` staged rows of `width` floats, `stride` apart, by plain
// loads through L2: row r from src_of(r) (null: zeros), from k_end on zero;
// by every thread of the block (nt threads).
template <typename SrcOf>
__device__ __forceinline__ void fill_rows(float* box, int nt, int rows, int width, int stride, int k_end,
                                          SrcOf src_of) {
  for (int i = threadIdx.x; i < rows * width; i += nt) {
    const int r = i / width, k = i % width;
    const float* src = src_of(r);
    box[r * stride + k] = src && k < k_end ? __ldcg(src + k) : 0.0f;
  }
}

// Where a block of a sequence kernel works.
struct Geometry {
  int c0;       // first hidden column of the cluster
  int c_valid;  // its columns below hidden
  int k0;       // first k of the block's slice
  int k_valid;  // its k below k_total
  int q0;       // first quad of 4 columns of the block's reduce slice, within the cluster's
  int nq;       // its quads
  int rank;
  int cluster;
};

__device__ __forceinline__ Geometry geometry(const cg::cluster_group& cluster, int cols, int hidden, int k_total,
                                             int k_slice) {
  Geometry g;
  g.cluster = static_cast<int>(cluster.num_blocks());
  g.rank = static_cast<int>(cluster.block_rank());
  g.c0 = static_cast<int>(blockIdx.x) / g.cluster * cols;
  g.c_valid = min(cols, hidden - g.c0);
  g.k0 = g.rank * k_slice;
  g.k_valid = max(0, min(k_slice, k_total - g.k0));
  g.q0 = g.rank * (cols / 4) / g.cluster;
  g.nq = (g.rank + 1) * (cols / 4) / g.cluster - g.q0;
  return g;
}

// The chunks a sequence kernel's ring streams, in order: position p is
// step p / per_step (the forward's t, the dh chain's S - 1 - t), row tile
// (p % per_step) / chunks, chunk p % chunks of the block's k-slice; it
// goes to stage p % stages, whose barriers complete their (p / stages)-th
// phase when it has landed.
struct Stream {
  int chunks, tiles, per_step, total;
  __device__ __forceinline__ int step(int p) const { return p / per_step; }
  __device__ __forceinline__ int tile(int p) const { return p % per_step / chunks; }
  __device__ __forceinline__ int chunk(int p) const { return p % chunks; }
};

__device__ __forceinline__ Stream stream_of(int k_valid, int chunk, int batch, int seq) {
  Stream s;
  s.chunks = max(1, (k_valid + chunk - 1) / chunk);
  s.tiles = (batch + kRows - 1) / kRows;
  s.per_step = s.chunks * s.tiles;
  s.total = seq * s.per_step;
  return s;
}

// The ring's barriers: stage s's W share completes on w[s], its state
// share on state[s], once a use each; thread 0 arrives on each once a use
// (with the boxes' bytes, or none where every thread staged by plain loads).
template <int kStages>
struct RingBarriers {
  unsigned long long w[kStages], state[kStages];

  __device__ __forceinline__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&w[s], 1);
        mbar_init(&state[s], 1);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // both shares of position p have landed
  __device__ __forceinline__ void wait(int p) {
    const unsigned parity = static_cast<unsigned>(p / kStages) & 1u;
    mbar_wait(&w[p % kStages], parity);
    mbar_wait(&state[p % kStages], parity);
  }
};

// The cluster's blocks' partial buffers, rank by rank (DSMEM).
struct Partials {
  const float* rank[kMaxCluster];
  __device__ __forceinline__ Partials(const cg::cluster_group& cluster, float* part, int n) {
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) rank[q] = q < n ? cluster.map_shared_rank(part, q) : part;
  }
  // the sums in rank order at float offsets o .. o + 3 (o a multiple of 4):
  // every rank's load issued at once (the ranks past n read this block's
  // own buffer, and are not added), not one behind another's branch
  __device__ __forceinline__ float4 sum4(int o, int n) const {
    float4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) v[q] = *reinterpret_cast<const float4*>(rank[q] + o);
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) s = q < n ? add4(s, v[q]) : s;
    return s;
  }
};

// The dynamic shared memory from its first kAlign-byte boundary on (the
// same offset in every block, so the partials line up across the cluster).
__device__ __forceinline__ float* aligned_smem(float* smem) {
  return smem + (kAlign - smem_addr(smem) % kAlign) % kAlign / 4;
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

// Dynamic shared memory of a sequence kernel: the ring's stages and the
// block's partial product, and room to align the ring.
template <bool kLstm>
int sequence_smem_bytes(bool backward) {
  using C = Cell<kLstm>;
  const int floats = backward ? kBwdStages * kBwdStageFloats + kRows * kBwdPartStride
                              : C::kFwdStages * C::kFwdStageFloats + kRows * C::kPartStride;
  return static_cast<int>(sizeof(float)) * floats + kAlign;
}

template <bool kLstm>
int stages_of(bool backward) {
  return backward ? kBwdStages : Cell<kLstm>::kFwdStages;
}

template <bool kLstm>
int chunk_of(bool backward) {
  return backward ? kBwdChunk : Cell<kLstm>::kFwdChunk;
}

// The tensor maps of a launch: W (backward W^T), and the state the steps
// read (forward: y as (H, S, B) and h0 as (H, B); backward: dhp as (G H, S,
// B), or as (G H, B) in state0 for one step). Unused where the launch
// stages by plain loads.
struct Maps {
  CUtensorMap w, state, state0;
};

// One chunk's FMAs of a lane's tile: acc[i][q] += sum over the quads [q0,
// q0 + kQuads) of the chunk of a[rg + 8 i][k] b[col0 + 4 q][k], the rows of
// a (the state) and b (W, W^T) kStride floats apart.
template <int kStride, int kQuads, int kTC>
__device__ __forceinline__ void chunk_fma(float (&acc)[kTileRows][kTC], const float* a, const float* b, int rg,
                                          int col0, int q0) {
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int kk = 4 * (q0 + i);
    float4 h[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) h[r] = *reinterpret_cast<const float4*>(a + (rg + 8 * r) * kStride + kk);
#pragma unroll
    for (int q = 0; q < kTC; ++q) {
      const float4 wv = *reinterpret_cast<const float4*>(b + (col0 + 4 * q) * kStride + kk);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        float v = acc[r][q];
        v = fmaf(h[r].x, wv.x, v);
        v = fmaf(h[r].y, wv.y, v);
        v = fmaf(h[r].z, wv.z, v);
        acc[r][q] = fmaf(h[r].w, wv.w, v);
      }
    }
  }
}

// The block's partial product (rows kStride floats apart) from its k-groups'
// tiles: the last group stores, the others add in order (deterministic).
template <int kGroups, int kStride, int kTC>
__device__ __forceinline__ void store_partial(float* part, const float (&acc)[kTileRows][kTC], int group, int rg,
                                              int col0) {
  for (int gi = kGroups - 1; gi >= 0; --gi) {
    if (group == gi) {
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
#pragma unroll
        for (int q = 0; q < kTC; ++q) {
          float* o = part + (rg + 8 * r) * kStride + col0 + 4 * q;
          *o = gi == kGroups - 1 ? acc[r][q] : *o + acc[r][q];
        }
    }
    if (gi > 0) __syncthreads();
  }
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
  int batch, seq, hidden, k_slice;
  int vec;  // 16-byte loads and stores of the tensors' rows (H a multiple of 4, all aligned)
  int tma;  // the sequence kernel: the ring filled by the TMA unit
  int y_width, reverse;  // a laid chain's layout: y's row width, time running backwards
};

// Row of a chain's step t in its tensors: t, or S - 1 - t for a laid
// reverse chain (a constant forward layout where kLaid is false).
template <bool kLaid, typename Args>
__device__ __forceinline__ int time_of(const Args& a, int t) {
  return kLaid && a.reverse ? a.seq - 1 - t : t;
}

template <bool kLaid, typename Args>
__device__ __forceinline__ int y_width_of(const Args& a) {
  return kLaid ? a.y_width : a.hidden;
}

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

template <bool kLstm, bool kLaid>
__global__ void __launch_bounds__(Cell<kLstm>::kFwdThreads, 1) gated_fwd_kernel(const __grid_constant__ FwdArgs a,
                                                                                const __grid_constant__ Maps maps) {
  using C = Cell<kLstm>;
  constexpr int G = C::kGates, NT = C::kFwdThreads, NS = C::kFwdStages, kAhead = NS - 1;
  constexpr int kGroupQuads = C::kFwdChunk / 4 / C::kGroups;
  constexpr int kBatch = C::kFwdBatch;
  extern __shared__ __align__(16) float smem_raw[];
  __shared__ RingBarriers<NS> bars;
  float* ring = aligned_smem(smem_raw);
  float* part = ring + NS * C::kFwdStageFloats;
  cg::cluster_group cluster = cg::this_cluster();
  const int H = a.hidden, S = a.seq, YW = y_width_of<kLaid>(a);
  const Geometry geo = geometry(cluster, kFwdCols, H, H, a.k_slice);
  const Stream str = stream_of(geo.k_valid, C::kFwdChunk, a.batch, S);
  const long long gh = static_cast<long long>(G) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / C::kGroupWarps;
  const int rg = lane & 7;
  const int col0 = warp % C::kGroupWarps * kColGroups * kFwdTileCols + (lane >> 3);  // gate columns col0 + 4 q

  // chunk p: a box of W's rows g H + c0 .. (kFwdCols of them) a gate and one of h's 64 rows, k
  // from k0 + kc; rows of the next gate (or past G H: zeros) in W's boxes and rows past the batch
  // in h's feed only partial sums no block reads
  auto issue_w = [&](int p) {
    float* ws = ring + p % NS * C::kFwdStageFloats + kRows * C::kFwdStride;
    const int kc = str.chunk(p) * C::kFwdChunk;
    if (a.tma) {
      if (threadIdx.x == 0) {
        mbar_arrive_tx(&bars.w[p % NS], sizeof(float) * C::kGateCols * C::kFwdStride);
        for (int g = 0; g < G; ++g)
          tma_2d(ws + g * kFwdCols * C::kFwdStride, maps.w, geo.k0 + kc, g * H + geo.c0, &bars.w[p % NS]);
      }
      return;
    }
    fill_rows(ws, NT, C::kGateCols, C::kFwdChunk, C::kFwdStride, geo.k_valid - kc, [&](int pc) {
      const int g = pc / kFwdCols, jj = pc - g * kFwdCols;
      return jj < geo.c_valid ? a.w + static_cast<long long>(g * H + geo.c0 + jj) * H + geo.k0 + kc : nullptr;
    });
    if (threadIdx.x == 0) mbar_arrive_tx(&bars.w[p % NS], 0);
  };
  auto issue_h = [&](int p) {
    float* hs = ring + p % NS * C::kFwdStageFloats;
    const int t = str.step(p), r0 = str.tile(p) * kRows, kc = str.chunk(p) * C::kFwdChunk;
    if (a.tma) {
      if (threadIdx.x == 0) {
        mbar_arrive_tx(&bars.state[p % NS], sizeof(float) * kRows * C::kFwdStride);
        if (t == 0) {
          tma_2d(hs, maps.state0, geo.k0 + kc, r0, &bars.state[p % NS]);
        } else {
          tma_3d(hs, maps.state, geo.k0 + kc, time_of<kLaid>(a, t - 1), r0, &bars.state[p % NS]);
        }
      }
      return;
    }
    const int rows = min(kRows, a.batch - r0);
    const float* h = t == 0 ? a.h0 + static_cast<long long>(r0) * H
                            : a.y + (static_cast<long long>(r0) * S + time_of<kLaid>(a, t - 1)) * YW;
    const long long stride = t == 0 ? H : static_cast<long long>(S) * YW;
    fill_rows(hs, NT, kRows, C::kFwdChunk, C::kFwdStride, geo.k_valid - kc,
              [&](int r) { return r < rows ? h + r * stride + geo.k0 + kc : nullptr; });
    if (threadIdx.x == 0) mbar_arrive_tx(&bars.state[p % NS], 0);
  };

  const Partials parts(cluster, part, geo.cluster);
  bars.init();
  for (int p = 0; p < kAhead && p < str.total; ++p) issue_w(p);  // W runs ahead of the state from the start
  int p = 0;
  for (int t = 0; t < S; ++t) {
    if (t > 0) {
      cg::this_grid().sync();  // y[:, t - 1] is complete, in every column
      if (a.tma && threadIdx.x == 0) fence_proxy_global();
    }
    // the state's share of the chunks already in flight
    for (int q = p; q < p + kAhead && q < str.total; ++q)
      if (str.step(q) == t) issue_h(q);
    const int tp = time_of<kLaid>(a, t), tq = t > 0 ? time_of<kLaid>(a, t - 1) : 0;  // step t's row, t - 1's
    for (int tile = 0; tile < str.tiles; ++tile) {
      const int r0 = tile * kRows, rows = min(kRows, a.batch - r0);
      float acc[kTileRows][kFwdTileCols];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
#pragma unroll
        for (int q = 0; q < kFwdTileCols; ++q) acc[r][q] = 0.0f;
      for (int c = 0; c < str.chunks; ++c, ++p) {
        if (threadIdx.x == 0) bars.wait(p);
        __syncthreads();  // chunk p landed; every thread is done with chunk p - 1, whose stage p + kAhead takes
        const int next = p + kAhead;
        if (next < str.total) {
          issue_w(next);
          if (str.step(next) == t) issue_h(next);
        }
        const float* hs = ring + p % NS * C::kFwdStageFloats;
        chunk_fma<C::kFwdStride, kGroupQuads, kFwdTileCols>(acc, hs, hs + kRows * C::kFwdStride, rg, col0,
                                                            group * kGroupQuads);
      }
      store_partial<C::kGroups, C::kPartStride, kFwdTileCols>(part, acc, group, rg, col0);
      cluster.sync();  // every partial of the cluster is written

      // the reduce slice: hp of all G gates of the block's quads of columns, then the cell
      const int n_items = rows * geo.nq;
      for (int i0 = threadIdx.x; i0 < n_items; i0 += kBatch * NT) {
        float4 hp[kBatch][G], x[kBatch][G], h_prev[kBatch], c_prev[kBatch];
#pragma unroll
        for (int m = 0; m < kBatch; ++m) {
          const int i = i0 + m * NT, row = i / geo.nq, jj = 4 * (geo.q0 + i % geo.nq);
          const int j = geo.c0 + jj, b = r0 + row, n = i < n_items ? min(4, H - j) : 0;
          const long long bt = static_cast<long long>(b) * S + tp, bj = static_cast<long long>(b) * H + j;
          const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            hp[m][g] = n > 0 ? add4(parts.sum4(row * C::kPartStride + g * kFwdCols + jj, geo.cluster),
                                    load4(a.bias + g * H + j, n, a.vec))
                             : zero;
            x[m][g] = n > 0 ? load4(a.xp + bt * gh + g * H + j, n, a.vec) : zero;
          }
          h_prev[m] = n > 0 ? load4(t == 0 ? a.h0 + bj : a.y + (static_cast<long long>(b) * S + tq) * YW + j, n, a.vec)
                            : zero;
          c_prev[m] = kLstm && n > 0 ? load4(t == 0 ? a.c0 + bj : a.c_last + bj, n, a.vec) : zero;
        }
#pragma unroll
        for (int m = 0; m < kBatch; ++m) {
          const int i = i0 + m * NT, row = i / geo.nq, j = geo.c0 + 4 * (geo.q0 + i % geo.nq), b = r0 + row;
          const int n = i < n_items ? min(4, H - j) : 0;
          if (n <= 0) continue;
          const long long bt = static_cast<long long>(b) * S + tp, bj = static_cast<long long>(b) * H + j;
          float4 y4, c4, sv4[C::kSaved];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float xe[G], he[G], c = 0.0f, sv[C::kSaved];
#pragma unroll
            for (int g = 0; g < G; ++g) {
              xe[g] = lane_of(x[m][g], e);
              he[g] = lane_of(hp[m][g], e);
            }
            set_lane(y4, e, cell_step<kLstm>(xe, he, lane_of(h_prev[m], e), lane_of(c_prev[m], e), &c, sv, 1));
            set_lane(c4, e, c);
#pragma unroll
            for (int k = 0; k < C::kSaved; ++k) set_lane(sv4[k], e, sv[k]);
          }
          store4(a.y + bt * YW + j, y4, n, a.vec);
          if (kLstm) store4(a.c_last + bj, c4, n, a.vec);
          if (t == S - 1 && (!kLaid || a.h_last)) store4(a.h_last + bj, y4, n, a.vec);
          if (a.saved)
#pragma unroll
            for (int k = 0; k < C::kSaved; ++k) store4(a.saved + bt * C::kSaved * H + k * H + j, sv4[k], n, a.vec);
        }
      }
      if (tile + 1 < str.tiles) cluster.sync();  // the partials are read before the next tile's
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
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
  if (a.vec) {
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
  float* w_t;             // (H, G H): W^T, written by the launch's gated_transpose_kernel
  float* dxp;             // (B, S, G H)
  float* dhp;             // (B, S, G H); gru only (lstm: dhp is dxp)
  float* dh0;             // (B, H); gru: carries gh z between steps
  float* dc0;             // (B, H), lstm: carries dc between steps
  int batch, seq, hidden, k_slice;
  int vec;  // 16-byte loads and stores of the tensors' rows (H a multiple of 4, all aligned)
  int tma;  // the ring filled by the TMA unit
  int y_width, reverse;  // a laid chain's layout of dy and y, as the forward's
};

// Step t's gate gradients at (b, j .. j + n - 1), n <= 4, from gh = dy_t +
// dh_t and (lstm) the dc carried from step t + 1: writes dxp and dhp at
// (b, t) and the carry to step t - 1 (gru: gh z into dh0; lstm: dc f into
// dc0).
template <bool kLstm, bool kLaid>
__device__ __forceinline__ void cell_grad4(const BwdArgs& a, int b, int t, int j, int n, const float4& gh,
                                           const float4& dc_in) {
  using C = Cell<kLstm>;
  constexpr int G = C::kGates;
  const int H = a.hidden, S = a.seq;
  const bool vec = a.vec;
  const long long bt = static_cast<long long>(b) * S + time_of<kLaid>(a, t);
  const long long bq = static_cast<long long>(b) * S + (t > 0 ? time_of<kLaid>(a, t - 1) : 0);  // step t - 1's row
  const long long o = bt * G * H + j, bj = static_cast<long long>(b) * H + j;
  const float* sv = a.saved + bt * C::kSaved * H + j;
  float4 s[C::kSaved];
#pragma unroll
  for (int k = 0; k < C::kSaved; ++k) s[k] = load4(sv + k * H, n, vec);
  // lstm: c_{t-1}; gru: h_{t-1}
  const float4 prev = kLstm ? (t > 0 ? load4(a.saved + bq * C::kSaved * H + 4 * H + j, n, vec)
                                     : load4(a.c0 + bj, n, vec))
                            : (t > 0 ? load4(a.y + bq * y_width_of<kLaid>(a) + j, n, vec) : load4(a.h0 + bj, n, vec));
  float4 dx[G], dhp_n, carry;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ghe = lane_of(gh, e);
    if constexpr (kLstm) {
      const float i = lane_of(s[0], e), f = lane_of(s[1], e), g = lane_of(s[2], e), og = lane_of(s[3], e);
      const float tc = tanhf(lane_of(s[4], e));
      const float dc = lane_of(dc_in, e) + ghe * og * (1.0f - tc * tc);
      set_lane(dx[0], e, dc * g * (i * (1.0f - i)));
      set_lane(dx[1], e, dc * lane_of(prev, e) * (f * (1.0f - f)));
      set_lane(dx[2], e, dc * i * (1.0f - g * g));
      set_lane(dx[3], e, ghe * tc * (og * (1.0f - og)));
      set_lane(carry, e, dc * f);
    } else {
      const float r = lane_of(s[0], e), z = lane_of(s[1], e), nn = lane_of(s[2], e), hn = lane_of(s[3], e);
      const float dn = ghe * (1.0f - z);
      const float dz = ghe * (lane_of(prev, e) - nn);
      const float dpn = dn * (1.0f - nn * nn);
      set_lane(dx[0], e, dpn * hn * (r * (1.0f - r)));
      set_lane(dx[1], e, dz * (z * (1.0f - z)));
      set_lane(dx[2], e, dpn);
      set_lane(dhp_n, e, dpn * r);
      set_lane(carry, e, ghe * z);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) store4(a.dxp + o + g * H, dx[g], n, vec);
  if constexpr (kLstm) {
    store4(a.dc0 + bj, carry, n, vec);
  } else {
    store4(a.dhp + o, dx[0], n, vec);
    store4(a.dhp + o + H, dx[1], n, vec);
    store4(a.dhp + o + 2 * H, dhp_n, n, vec);
    store4(a.dh0 + bj, carry, n, vec);
  }
}

template <bool kLstm, bool kLaid>
__global__ void __launch_bounds__(kBwdThreads, 1) gated_bwd_kernel(const __grid_constant__ BwdArgs a,
                                                                   const __grid_constant__ Maps maps) {
  using C = Cell<kLstm>;
  constexpr int NT = kBwdThreads, NS = kBwdStages, kAhead = NS - 1;
  constexpr int kGroupQuads = kBwdChunk / 4 / kBwdGroups;
  extern __shared__ __align__(16) float smem_raw[];
  __shared__ RingBarriers<NS> bars;
  float* ring = aligned_smem(smem_raw);
  float* part = ring + NS * kBwdStageFloats;
  cg::cluster_group cluster = cg::this_cluster();
  const int H = a.hidden, S = a.seq, YW = y_width_of<kLaid>(a);
  const int gate_width = C::kGates * H;
  const Geometry geo = geometry(cluster, kCols, H, gate_width, a.k_slice);
  const Stream str = stream_of(geo.k_valid, kBwdChunk, a.batch, S);
  const float* dhp = kLstm ? a.dxp : a.dhp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 7;
  const int group = warp / kBwdGroupWarps;                                      // k-group
  const int col0 = warp % kBwdGroupWarps * kWarpCols + (lane >> 3);  // hidden columns col0 + 4 q

  // chunk p: W^T's rows c0 .. (the cluster's 72 hidden columns) and dhp_t's 64 rows, k from
  // k0 + kc; k past G H is zero, W^T's rows past H and dhp's rows past the batch feed only
  // partial sums no block reads
  auto issue_w = [&](int p) {
    float* ws = ring + p % NS * kBwdStageFloats + kBwdDhpFloats;
    const int kc = str.chunk(p) * kBwdChunk;
    if (a.tma) {
      if (threadIdx.x == 0) {
        mbar_arrive_tx(&bars.w[p % NS], sizeof(float) * kCols * kBwdStride);
        tma_2d(ws, maps.w, geo.k0 + kc, geo.c0, &bars.w[p % NS]);
      }
      return;
    }
    fill_rows(ws, NT, kCols, kBwdChunk, kBwdStride, geo.k_valid - kc, [&](int jj) {
      return jj < geo.c_valid ? a.w_t + static_cast<long long>(geo.c0 + jj) * gate_width + geo.k0 + kc : nullptr;
    });
    if (threadIdx.x == 0) mbar_arrive_tx(&bars.w[p % NS], 0);
  };
  auto issue_h = [&](int p) {
    float* ds = ring + p % NS * kBwdStageFloats;
    const int t = time_of<kLaid>(a, S - 1 - str.step(p));  // dhp's row of the chain's step
    const int r0 = str.tile(p) * kRows, kc = str.chunk(p) * kBwdChunk;
    if (a.tma) {
      if (threadIdx.x == 0) {
        mbar_arrive_tx(&bars.state[p % NS], sizeof(float) * kBwdDhpFloats);
        if (S == 1) {
          tma_2d(ds, maps.state0, geo.k0 + kc, r0, &bars.state[p % NS]);
        } else {
          tma_3d(ds, maps.state, geo.k0 + kc, t, r0, &bars.state[p % NS]);
        }
      }
      return;
    }
    const int rows = min(kRows, a.batch - r0);
    const long long stride = static_cast<long long>(S) * gate_width;
    const float* src0 = dhp + (static_cast<long long>(r0) * S + t) * gate_width + geo.k0 + kc;
    fill_rows(ds, NT, kRows, kBwdChunk, kBwdStride, geo.k_valid - kc,
              [&](int r) { return r < rows ? src0 + r * stride : nullptr; });
    if (threadIdx.x == 0) mbar_arrive_tx(&bars.state[p % NS], 0);
  };

  // step S - 1 from the carry's gradients, in the block's reduce slice
  for (int i = threadIdx.x; i < a.batch * geo.nq; i += NT) {
    const int b = i / geo.nq, j = geo.c0 + 4 * (geo.q0 + i % geo.nq), n = min(4, H - j);
    if (n <= 0) continue;
    const long long bj = static_cast<long long>(b) * H + j;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const long long last = (static_cast<long long>(b) * S + time_of<kLaid>(a, S - 1)) * YW;  // dy's row of step S - 1
    const float4 gh = add4(load4(a.dy + last + j, n, a.vec), a.dh_last ? load4(a.dh_last + bj, n, a.vec) : zero);
    cell_grad4<kLstm, kLaid>(a, b, S - 1, j, n, gh, kLstm && a.dc_last ? load4(a.dc_last + bj, n, a.vec) : zero);
  }

  const Partials parts(cluster, part, geo.cluster);
  bars.init();
  for (int p = 0; p < kAhead && p < str.total; ++p) issue_w(p);  // W runs ahead of dhp from the start
  int p = 0;
  for (int step = 0; step < S; ++step) {
    const int t = S - 1 - step;
    cg::this_grid().sync();  // dhp[:, t] is complete, in every column
    if (a.tma && threadIdx.x == 0) fence_proxy_global();
    for (int q = p; q < p + kAhead && q < str.total; ++q)
      if (str.step(q) == step) issue_h(q);
    const int tq = t > 0 ? time_of<kLaid>(a, t - 1) : 0;  // step t - 1's row of dy
    for (int tile = 0; tile < str.tiles; ++tile) {
      const int r0 = tile * kRows, rows = min(kRows, a.batch - r0);
      float acc[kTileRows][kTileCols];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
#pragma unroll
        for (int q = 0; q < kTileCols; ++q) acc[r][q] = 0.0f;
      for (int c = 0; c < str.chunks; ++c, ++p) {
        if (threadIdx.x == 0) bars.wait(p);
        __syncthreads();  // chunk p landed; every thread is done with chunk p - 1, whose stage p + kAhead takes
        const int next = p + kAhead;
        if (next < str.total) {
          issue_w(next);
          if (str.step(next) == step) issue_h(next);
        }
        const float* ds = ring + p % NS * kBwdStageFloats;
        chunk_fma<kBwdStride, kGroupQuads, kTileCols>(acc, ds, ds + kBwdDhpFloats, rg, col0, group * kGroupQuads);
      }
      store_partial<kBwdGroups, kBwdPartStride, kTileCols>(part, acc, group, rg, col0);
      cluster.sync();  // every partial of the cluster is written

      // the reduce slice: dh_{t-1} at the block's quads of columns, then step t - 1's gate gradients
      const int n_items = rows * geo.nq;
      constexpr int kBatch = kBwdBatch;
      for (int i0 = threadIdx.x; i0 < n_items; i0 += kBatch * NT) {
        float4 dh[kBatch], dy[kBatch], dc[kBatch];
#pragma unroll
        for (int m = 0; m < kBatch; ++m) {
          const int i = i0 + m * NT, row = i / geo.nq, jj = 4 * (geo.q0 + i % geo.nq);
          const int j = geo.c0 + jj, b = r0 + row, n = i < n_items ? min(4, H - j) : 0;
          const long long bj = static_cast<long long>(b) * H + j;
          const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          // gru: dh_{t-1} = gh_t z_t (carried in dh0) + dhp_t W; lstm: dhp_t W
          dh[m] = n > 0 ? parts.sum4(row * kBwdPartStride + jj, geo.cluster) : zero;
          if (!kLstm && n > 0) dh[m] = add4(dh[m], load4(a.dh0 + bj, n, a.vec));
          dy[m] = n > 0 && t > 0 ? load4(a.dy + (static_cast<long long>(b) * S + tq) * YW + j, n, a.vec) : zero;
          dc[m] = kLstm && n > 0 && t > 0 ? load4(a.dc0 + bj, n, a.vec) : zero;
        }
#pragma unroll
        for (int m = 0; m < kBatch; ++m) {
          const int i = i0 + m * NT, row = i / geo.nq, j = geo.c0 + 4 * (geo.q0 + i % geo.nq), b = r0 + row;
          const int n = i < n_items ? min(4, H - j) : 0;
          if (n <= 0) continue;
          if (t > 0) {
            cell_grad4<kLstm, kLaid>(a, b, t - 1, j, n, add4(dy[m], dh[m]), dc[m]);
          } else {
            store4(a.dh0 + static_cast<long long>(b) * H + j, dh[m], n, a.vec);
          }
        }
      }
      if (tile + 1 < str.tiles) cluster.sync();  // the partials are read before the next tile's
    }
  }
  cluster.sync();
}

// w_t = W^T for W (rows x cols, both multiples of 4 and 16-byte aligned),
// a 64 x 64 tile a block through shared memory (one column of padding
// against bank conflicts), read and written 16 bytes a thread. Bound by its
// bytes: 2 x 48 / 64 MiB at H = 2048, 0.030 / 0.040 ms at 3.35 TB/s.
// Elsewhere element by element (the plain-load path's sizes).
constexpr int kTransposeTile = 64, kTransposeThreads = 256;
__global__ void __launch_bounds__(kTransposeThreads) gated_transpose_kernel(const float* __restrict__ w,
                                                                             float* __restrict__ w_t, int rows,
                                                                             int cols, int vec) {
  __shared__ float tile[kTransposeTile][kTransposeTile + 1];
  constexpr int kQuads = kTransposeTile / 4;  // float4 of a tile row
  const int r0 = static_cast<int>(blockIdx.y) * kTransposeTile, c0 = static_cast<int>(blockIdx.x) * kTransposeTile;
  const int q = threadIdx.x % kQuads, i0 = threadIdx.x / kQuads;
  constexpr int kStep = kTransposeThreads / kQuads;
#pragma unroll
  for (int i = i0; i < kTransposeTile; i += kStep) {
    const int r = r0 + i, c = c0 + 4 * q;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows && vec && c < cols) {
      v = __ldg(reinterpret_cast<const float4*>(w + static_cast<long long>(r) * cols + c));
    } else if (r < rows) {
      v.x = c < cols ? w[static_cast<long long>(r) * cols + c] : 0.0f;
      v.y = c + 1 < cols ? w[static_cast<long long>(r) * cols + c + 1] : 0.0f;
      v.z = c + 2 < cols ? w[static_cast<long long>(r) * cols + c + 2] : 0.0f;
      v.w = c + 3 < cols ? w[static_cast<long long>(r) * cols + c + 3] : 0.0f;
    }
    tile[i][4 * q] = v.x;
    tile[i][4 * q + 1] = v.y;
    tile[i][4 * q + 2] = v.z;
    tile[i][4 * q + 3] = v.w;
  }
  __syncthreads();
#pragma unroll
  for (int i = i0; i < kTransposeTile; i += kStep) {
    const int c = c0 + i, r = r0 + 4 * q;  // w_t's row c, its columns r .. r + 3
    if (c >= cols) continue;
    const float4 v = make_float4(tile[4 * q][i], tile[4 * q + 1][i], tile[4 * q + 2][i], tile[4 * q + 3][i]);
    float* o = w_t + static_cast<long long>(c) * rows + r;
    if (vec && r < rows) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      if (r < rows) o[0] = v.x;
      if (r + 1 < rows) o[1] = v.y;
      if (r + 2 < rows) o[2] = v.z;
      if (r + 3 < rows) o[3] = v.w;
    }
  }
}

// ---------------------------------------------------------------------------
// plans and entry points
// ---------------------------------------------------------------------------

// The plan as the wrapper made it (ops/recurrence.py GatedPlan).
struct Plan {
  int launch, cluster, k_slice, cols, stages, smem;
};

int cols_of(bool backward) { return backward ? kCols : kFwdCols; }

int clusters_of(int hidden, bool backward) { return (hidden + cols_of(backward) - 1) / cols_of(backward); }

// Every cluster resident at once and one grid barrier a step: any launch
// but a forward of one step.
bool cooperative(int seq, bool backward) { return backward || seq > 1; }

// Whether the plan covers the problem with this file's geometry: the
// one-step kernel only for a forward of one step at a few rows that saves
// nothing, of a chain that owns its y; a sequence kernel's blocks of a
// cluster each a whole number of chunks of the forward's H or the dh
// chain's G H and all of it together, with the ring and the shared memory
// they need.
template <bool kLstm, bool kLaid>
bool plan_fits(const Plan& p, int batch, int seq, int hidden, bool backward, bool saves) {
  if (p.launch == kStep)
    return !kLaid && !backward && !saves && seq == 1 && batch <= kStepRows && p.cluster == 1 && p.k_slice == hidden &&
           p.cols == kStepWarps && p.stages == 0 && p.smem == 0;
  const long long k_total = backward ? static_cast<long long>(Cell<kLstm>::kGates) * hidden : hidden;
  return p.launch == kSequence && p.cols == cols_of(backward) && p.cluster >= 1 && p.cluster <= kMaxCluster &&
         p.cluster <= p.cols / 4 && p.k_slice > 0 && p.k_slice % chunk_of<kLstm>(backward) == 0 &&
         static_cast<long long>(p.cluster) * p.k_slice >= k_total &&
         static_cast<long long>(p.cluster - 1) * p.k_slice < k_total && p.stages == stages_of<kLstm>(backward) &&
         p.smem >= sequence_smem_bytes<kLstm>(backward);
}

template <bool kLstm, bool kLaid>
const void* kernel_of(int launch, bool backward) {
  if (backward) return reinterpret_cast<const void*>(gated_bwd_kernel<kLstm, kLaid>);
  return launch == kStep ? reinterpret_cast<const void*>(gated_step_kernel<kLstm>)
                         : reinterpret_cast<const void*>(gated_fwd_kernel<kLstm, kLaid>);
}

template <bool kLstm>
int threads_of(bool backward) {
  return backward ? kBwdThreads : Cell<kLstm>::kFwdThreads;
}

// The launch configuration of a sequence kernel: a 1-D grid of clusters of
// `cluster` blocks; cooperative (every cluster resident, grid barriers
// allowed) on request.
struct SequenceLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];

  SequenceLaunch(int blocks, int cluster, int threads, int smem, bool cooperative, cudaStream_t stream) : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = cooperative ? 2 : 1;
  }
};

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// lookup (no link to libcuda); null where libcuda lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A float32 map of a `rank`-D tensor at base (dims innermost first, the
// outer dims' strides in floats), read in boxes of `box` (dense in shared
// memory), past its ends as zeros. False where it cannot be made (base or a
// stride not 16-byte aligned, no cuTensorMapEncodeTiled, a map the driver
// refuses).
bool encode(CUtensorMap* map, const float* base, int rank, const long long* dims, const long long* strides,
            const int* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn || !aligned16(base)) return false;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t bdim[3], estride[3];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bdim[i] = static_cast<cuuint32_t>(box[i]);
    estride[i] = 1;
  }
  for (int i = 0; i + 1 < rank; ++i) {
    gstride[i] = static_cast<cuuint64_t>(strides[i]) * sizeof(float);
    if (gstride[i] % 16) return false;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, static_cast<cuuint32_t>(rank), const_cast<float*>(base), gdim,
            gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kLstm, bool kLaid>
int check(int backward, int saves, int batch, int seq, int hidden, const Plan& p) {
  if (batch <= 0 || seq <= 0 || hidden <= 0 ||
      !plan_fits<kLstm, kLaid>(p, batch, seq, hidden, backward != 0, saves != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.launch == kStep) return static_cast<int>(cudaSuccess);
  const void* kernel = kernel_of<kLstm, kLaid>(p.launch, backward != 0);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int clusters = clusters_of(hidden, backward != 0);
  SequenceLaunch l(clusters * p.cluster, p.cluster, threads_of<kLstm>(backward != 0), p.smem, false, nullptr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &l.cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1 || (cooperative(seq, backward != 0) && active < clusters))
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return static_cast<int>(cudaSuccess);
}

template <bool kLstm, bool kLaid>
int launch_sequence(const Plan& p, bool backward, int seq, int hidden, void* arg, Maps* maps, cudaStream_t stream) {
  void* args[] = {arg, maps};
  SequenceLaunch l(clusters_of(hidden, backward) * p.cluster, p.cluster, threads_of<kLstm>(backward), p.smem,
                   cooperative(seq, backward), stream);
  const cudaError_t err = cudaLaunchKernelExC(&l.cfg, kernel_of<kLstm, kLaid>(p.launch, backward), args);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Whether a chain's layout holds its H columns: y's rows of `width` floats,
// the chain's columns [offset, offset + H) of them.
bool layout_fits(int hidden, int reverse, int width, int offset) {
  return (reverse == 0 || reverse == 1) && offset >= 0 && static_cast<long long>(offset) + hidden <= width;
}

template <bool kLstm, bool kLaid>
int forward(FwdArgs a, const Plan& p, void* stream) {
  if (a.batch <= 0 || a.seq <= 0 || a.hidden <= 0) return static_cast<int>(cudaGetLastError());
  if (!plan_fits<kLstm, kLaid>(p, a.batch, a.seq, a.hidden, false, a.saved != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long H = a.hidden, S = a.seq, B = a.batch, G = Cell<kLstm>::kGates, YW = a.y_width;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  a.k_slice = p.k_slice;
  a.vec = H % 4 == 0 && YW % 4 == 0 && aligned16(a.xp) && aligned16(a.h0) && aligned16(a.c0) && aligned16(a.w) &&
          aligned16(a.bias) && aligned16(a.y) && aligned16(a.h_last) && aligned16(a.c_last) && aligned16(a.saved);
  if (p.launch == kStep) {
    void* args[] = {&a};
    const dim3 grid(static_cast<unsigned>((H + kStepWarps - 1) / kStepWarps));
    const void* kernel = kernel_of<kLstm, kLaid>(p.launch, false);
    const cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(kStepThreads), args, 0, s);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : last);
  }
  Maps maps{};
  // y as (H, S, B) with its rows YW floats apart: a laid chain's columns of the (B, S, YW) output
  const long long w_dims[] = {H, G * H}, y_dims[] = {H, S, B}, h0_dims[] = {H, B};
  const long long w_strides[] = {H}, y_strides[] = {YW, S * YW};
  constexpr int kStride = Cell<kLstm>::kFwdStride;
  const int w_box[] = {kStride, kFwdCols}, y_box[] = {kStride, 1, kRows}, h0_box[] = {kStride, kRows};
  // the TMA unit fills the ring wherever the rows are 16-byte aligned, and then a map that
  // cannot be made is an error, not a quiet switch to plain loads; y's map is read from step 1
  // on: none for one step
  a.tma = H % 4 == 0 && YW % 4 == 0 && aligned16(a.w) && aligned16(a.y) && aligned16(a.h0);
  if (a.tma && !(encode(&maps.w, a.w, 2, w_dims, w_strides, w_box) &&
                 (S == 1 || encode(&maps.state, a.y, 3, y_dims, y_strides, y_box)) &&
                 encode(&maps.state0, a.h0, 2, h0_dims, w_strides, h0_box)))
    return static_cast<int>(cudaErrorNotSupported);
  return launch_sequence<kLstm, kLaid>(p, false, a.seq, a.hidden, &a, &maps, s);
}

template <bool kLstm, bool kLaid>
int backward(BwdArgs a, const Plan& p, void* stream) {
  if (a.batch <= 0 || a.seq <= 0 || a.hidden <= 0) return static_cast<int>(cudaGetLastError());
  if (!plan_fits<kLstm, kLaid>(p, a.batch, a.seq, a.hidden, true, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long H = a.hidden, S = a.seq, B = a.batch, GH = Cell<kLstm>::kGates * H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  a.k_slice = p.k_slice;
  a.vec = H % 4 == 0 && a.y_width % 4 == 0 && aligned16(a.dy) && aligned16(a.dh_last) && aligned16(a.dc_last) &&
          aligned16(a.y) && aligned16(a.h0) && aligned16(a.c0) && aligned16(a.saved) && aligned16(a.dxp) &&
          aligned16(a.dhp) && aligned16(a.dh0) && aligned16(a.dc0);
  if (!a.w_t) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 tiles(static_cast<unsigned>((H + kTransposeTile - 1) / kTransposeTile),
                   static_cast<unsigned>((GH + kTransposeTile - 1) / kTransposeTile));
  const int vec = H % 4 == 0 && aligned16(a.w) && aligned16(a.w_t);
  gated_transpose_kernel<<<tiles, kTransposeThreads, 0, s>>>(a.w, a.w_t, static_cast<int>(GH), a.hidden, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps maps{};
  // W^T (G H, H) in boxes of 72 rows, each a chunk's k; dhp as (G H, S, B), or for one step
  // as (G H, B)
  const long long wt_dims[] = {GH, H}, dhp_dims[] = {GH, S, B}, dhp1_dims[] = {GH, B};
  const long long wt_strides[] = {GH}, dhp_strides[] = {GH, S * GH};
  const int wt_box[] = {kBwdStride, kCols}, dhp_box[] = {kBwdStride, 1, kRows}, dhp1_box[] = {kBwdStride, kRows};
  const float* dhp = kLstm ? a.dxp : a.dhp;
  // as the forward: the TMA unit wherever the rows are 16-byte aligned, a map it cannot make an error
  a.tma = H % 4 == 0 && aligned16(a.w_t) && aligned16(dhp);
  if (a.tma && !(encode(&maps.w, a.w_t, 2, wt_dims, wt_strides, wt_box) &&
                 (S == 1 ? encode(&maps.state0, dhp, 2, dhp1_dims, dhp_strides, dhp1_box)
                         : encode(&maps.state, dhp, 3, dhp_dims, dhp_strides, dhp_box))))
    return static_cast<int>(cudaErrorNotSupported);
  return launch_sequence<kLstm, kLaid>(p, true, a.seq, a.hidden, &a, &maps, s);
}

}  // namespace

// Checks a plan once, when the wrapper makes it, against this file's
// geometry and the current device (every cluster resident at once where
// the launch is cooperative), and lets the sequence kernel take the shared
// memory the plan gives it. lstm 1 for B.12, 0 for B.11; laid 1 for a gru
// chain with a layout (B.13); saves 1 for a training forward; then the
// sizes and GatedPlan's six fields.
extern "C" int hulc_rnn_gated_check(int lstm, int laid, int backward, int saves, int batch, int seq, int hidden,
                                    int launch, int cluster, int k_slice, int cols, int stages, int smem) {
  const Plan p{launch, cluster, k_slice, cols, stages, smem};
  if (laid)
    return lstm ? static_cast<int>(cudaErrorInvalidValue) : check<false, true>(backward, saves, batch, seq, hidden, p);
  return lstm ? check<true, false>(backward, saves, batch, seq, hidden, p)
              : check<false, false>(backward, saves, batch, seq, hidden, p);
}

// B.11 forward: y (B, S, H), h_last (B, H); saved (B, S, 4 H) [r | z | n | hn]
// in training mode, else null.
extern "C" int hulc_rnn_gru_fwd(const void* xp, const void* h0, const void* w, const void* bias, void* y,
                                void* h_last, void* saved, int batch, int seq, int hidden, int launch, int cluster,
                                int k_slice, int cols, int stages, int smem, void* stream) {
  FwdArgs a{static_cast<const float*>(xp), static_cast<const float*>(h0), nullptr, static_cast<const float*>(w),
            static_cast<const float*>(bias), static_cast<float*>(y), static_cast<float*>(h_last), nullptr,
            static_cast<float*>(saved), batch, seq, hidden, 0, 0, 0, hidden, 0};
  return forward<false, false>(a, Plan{launch, cluster, k_slice, cols, stages, smem}, stream);
}

// B.11 dh chain: dxp and dhp (B, S, 3 H), dh0 (B, H); dh_last may be null;
// w_t (H, 3 H) is scratch for W^T.
extern "C" int hulc_rnn_gru_bwd(const void* dy, const void* dh_last, const void* y, const void* h0, const void* saved,
                                const void* w, void* w_t, void* dxp, void* dhp, void* dh0, int batch, int seq,
                                int hidden, int launch, int cluster, int k_slice, int cols, int stages, int smem,
                                void* stream) {
  BwdArgs a{static_cast<const float*>(dy), static_cast<const float*>(dh_last), nullptr, static_cast<const float*>(y),
            static_cast<const float*>(h0), nullptr, static_cast<const float*>(saved), static_cast<const float*>(w),
            static_cast<float*>(w_t), static_cast<float*>(dxp), static_cast<float*>(dhp), static_cast<float*>(dh0),
            nullptr, batch, seq, hidden, 0, 0, 0, hidden, 0};
  return backward<false, false>(a, Plan{launch, cluster, k_slice, cols, stages, smem}, stream);
}

// B.13 gru chain forward: as hulc_rnn_gru_fwd, y's rows y_width floats a
// time step and the chain's columns [y_offset, y_offset + H) of them, run
// from t = S - 1 down when reverse = 1; xp and saved (B, S, 4 H) in xp's
// time order. h_last may be null.
extern "C" int hulc_rnn_gru_chain_fwd(const void* xp, const void* h0, const void* w, const void* bias, void* y,
                                      void* h_last, void* saved, int batch, int seq, int hidden, int reverse,
                                      int y_width, int y_offset, int launch, int cluster, int k_slice, int cols,
                                      int stages, int smem, void* stream) {
  if (!layout_fits(hidden, reverse, y_width, y_offset)) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{static_cast<const float*>(xp), static_cast<const float*>(h0), nullptr, static_cast<const float*>(w),
            static_cast<const float*>(bias), static_cast<float*>(y) + y_offset, static_cast<float*>(h_last), nullptr,
            static_cast<float*>(saved), batch, seq, hidden, 0, 0, 0, y_width, reverse};
  return forward<false, true>(a, Plan{launch, cluster, k_slice, cols, stages, smem}, stream);
}

// B.13 gru chain dh chain: dy and y in the forward's layout, dxp and dhp
// (B, S, 3 H) in xp's time order, dh0 (B, H); dh_last may be null; w_t (H,
// 3 H) is scratch for W^T.
extern "C" int hulc_rnn_gru_chain_bwd(const void* dy, const void* dh_last, const void* y, const void* h0,
                                      const void* saved, const void* w, void* w_t, void* dxp, void* dhp, void* dh0,
                                      int batch, int seq, int hidden, int reverse, int y_width, int y_offset,
                                      int launch, int cluster, int k_slice, int cols, int stages, int smem,
                                      void* stream) {
  if (!layout_fits(hidden, reverse, y_width, y_offset)) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{static_cast<const float*>(dy) + y_offset, static_cast<const float*>(dh_last), nullptr,
            static_cast<const float*>(y) + y_offset, static_cast<const float*>(h0), nullptr,
            static_cast<const float*>(saved), static_cast<const float*>(w), static_cast<float*>(w_t),
            static_cast<float*>(dxp), static_cast<float*>(dhp), static_cast<float*>(dh0), nullptr, batch, seq,
            hidden, 0, 0, 0, y_width, reverse};
  return backward<false, true>(a, Plan{launch, cluster, k_slice, cols, stages, smem}, stream);
}

// B.12 forward: y (B, S, H), h_last and c_last (B, H); saved (B, S, 5 H)
// [i | f | g | o | c] in training mode, else null.
extern "C" int hulc_rnn_lstm_fwd(const void* xp, const void* h0, const void* c0, const void* w, const void* bias,
                                 void* y, void* h_last, void* c_last, void* saved, int batch, int seq, int hidden,
                                 int launch, int cluster, int k_slice, int cols, int stages, int smem, void* stream) {
  FwdArgs a{static_cast<const float*>(xp), static_cast<const float*>(h0), static_cast<const float*>(c0),
            static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(y),
            static_cast<float*>(h_last), static_cast<float*>(c_last), static_cast<float*>(saved),
            batch, seq, hidden, 0, 0, 0, hidden, 0};
  return forward<true, false>(a, Plan{launch, cluster, k_slice, cols, stages, smem}, stream);
}

// B.12 dh / dc chain: dpre (B, S, 4 H) (the gradient of xp and of hp alike),
// dh0 and dc0 (B, H); dh_last and dc_last may be null; w_t (H, 4 H) is
// scratch for W^T.
extern "C" int hulc_rnn_lstm_bwd(const void* dy, const void* dh_last, const void* dc_last, const void* saved,
                                 const void* c0, const void* w, void* w_t, void* dpre, void* dh0, void* dc0,
                                 int batch, int seq, int hidden, int launch, int cluster, int k_slice, int cols,
                                 int stages, int smem, void* stream) {
  BwdArgs a{static_cast<const float*>(dy), static_cast<const float*>(dh_last), static_cast<const float*>(dc_last),
            nullptr, nullptr, static_cast<const float*>(c0), static_cast<const float*>(saved),
            static_cast<const float*>(w), static_cast<float*>(w_t), static_cast<float*>(dpre), nullptr,
            static_cast<float*>(dh0), static_cast<float*>(dc0), batch, seq, hidden, 0, 0, 0, hidden, 0};
  return backward<true, false>(a, Plan{launch, cluster, k_slice, cols, stages, smem}, stream);
}
