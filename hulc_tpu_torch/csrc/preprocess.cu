// uint8 camera frames -> normalized fp32 in the layout nn.Conv2d reads.
//
// Replaces the eval branch of hulc_tpu/ops/image_ops.py preprocess_rgb /
// preprocess_rgb_seq (lines 85-154): v -> (v * (1/255) - mean) / std, which
// the JAX package leaves to an XLA fusion. This kernel also moves the
// channel axis, reading NHWC (what the camera gives) and writing NCHW (what
// the first convolution reads), so the transpose costs no extra pass.
//
// Bound on the H100: bytes. Each element is one byte read and four written,
// so at 3.35 TB/s the policy's 64-lane static frame (64x200x200x3) needs
// 0.0115 ms; at one lane (0.6 MB) the launch latency is the bound, and the
// time is the latency of one thread's chain of loads and stores. The first
// design (one thread per output element on a flat grid, six 64-bit div/mod
// per element to recover (n, ch, y, x), one byte load and one 4-byte store
// per thread, an IEEE divide per element) reached a quarter of the bound at
// 64 lanes. This design:
//   * grid: one thread per quad of 4 consecutive pixels of a frame, counted
//     over the frame's H * W pixels: the NCHW planes are contiguous, so a
//     quad is 4 consecutive floats of each channel's plane whatever row it
//     is in, and no index is divided. Blocks of kEvalThreads = 128 cover a
//     frame (79 for 200 px, 14 for 84 px) and grid.y walks the frames, so
//     one lane already spreads over as many SMs (smaller blocks measured
//     slower at one lane, larger ones no faster);
//   * loads: a quad is 12 consecutive bytes, three 4-byte loads where the
//     frames start 4-byte aligned (neighbouring threads on neighbouring
//     words), byte loads otherwise;
//   * stores: one 16-byte streaming store per channel where H * W % 4 == 0
//     (then every quad of every plane is 16-byte aligned), else element by
//     element;
//   * normalize: the 256-entry table the shift kernel reads (built on the
//     host by the plain version's own ops), in shared memory, so the result
//     is bit-equal to the plain version for every (mean, std).
//
// hulc_preprocess_rgb_shift is the train-time variant. It replaces
// hulc_tpu/ops/image_ops.py random_shift / _shift_matmul (lines 27-82): a
// per-frame integer crop of the replicate-padded frame, which the JAX
// package computes as two one-hot selection matmuls on the TPU's matrix
// unit. Here it is what it is, a clamped gather: output pixel (y, x) of
// frame n reads source pixel (clip(s_r + y - pad), clip(s_c + x - pad)),
// with (s_r, s_c) = shifts[n] in [0, 2 * pad], then the normalize.
//
// Bound on the H100: bytes. The training batch, 2048 frames of 200 px and
// 2048 of 84 px, is 1.4456 GB of u8 in and fp32 out, 0.4315 ms at
// 3.35 TB/s. The first design (one thread per output element on a flat
// grid, six 64-bit div/mod per element to recover (n, ch, y, x), one
// strided byte load and one 4-byte store per thread) reached a quarter of
// that. This design:
//   * grid: one block per frame, 32-bit index arithmetic, no division per
//     element. The block walks the frame in bands of kBand output rows, one
//     warp per row;
//   * loads: a band needs a contiguous, clamped range of source rows. The
//     block copies it into shared memory with 16-byte cp.async, double
//     buffered, so the next band's loads are in flight while this band is
//     stored. A frame of 200 px (120,000 B) or 84 px (21,168 B) starts
//     16-byte aligned, but a source row (600 B, 252 B) does not: the
//     range's unaligned head and tail are copied byte by byte;
//   * stores: each lane writes 4 consecutive x of one channel as one
//     16-byte streaming store (an output row is a multiple of 16 bytes when
//     w % 4 == 0; other widths store element by element). The channel
//     de-interleave happens in shared memory;
//   * normalize: a 256-entry table, built on the host by the plain
//     version's own ops on every byte value, so the result is bit-equal to
//     preprocess_rgb_seq_shift_plain.
//
// bf16 instances (B.14): a bf16 model trains and validates on bf16 frames
// (hulc_tpu/training/preprocess.py:23 passes the compute dtype; off the TPU
// the JAX package normalizes in fp32 and rounds once,
// hulc_tpu/ops/image_ops.py:133-135). Both kernels are templates on the
// output's element type, float or __nv_bfloat16, with an extern "C"
// launcher for each instance (the _bf16 ones). The bf16 instances read the
// same table rounded once to bf16 on the host, so they store the plain
// version's bits; only the epilogue differs: 8-byte stores of 4 bf16 where
// an fp32 instance stores 16 bytes of 4 floats. The shift kernel's cp.async
// staging of the u8 rows is the same. The bound shrinks with the bytes
// written: the training batch is 289.1 MB read and 578.2 MB written,
// 0.259 ms at 3.35 TB/s; the 64-lane policy's static frame 0.0057 ms.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kEvalThreads = 128;  // quads per block
constexpr int kMaxFrameBlocks = 65535;  // grid.y; a block walks frames beyond it

// The 12 bytes of pixels [p, p + count) of an RGB frame (count <= 4), as
// three little-endian words; four-byte loads when the frame is word aligned.
__device__ __forceinline__ void load_quad(unsigned (&q)[3], const uint8_t* frame, int p, int count,
                                          bool words) {
  const uint8_t* b = frame + 3 * p;
  if (words && count == 4) {
    const unsigned* w = reinterpret_cast<const unsigned*>(b);
#pragma unroll
    for (int i = 0; i < 3; ++i) q[i] = __ldg(w + i);
    return;
  }
  q[0] = q[1] = q[2] = 0;
  for (int i = 0; i < 3 * count; ++i) q[i >> 2] |= static_cast<unsigned>(b[i]) << (8 * (i & 3));
}

// Streaming stores of one element, and of 4 consecutive elements (16 bytes
// of floats, 8 of bf16) at an address aligned to their size.
__device__ __forceinline__ void store1(float* o, float v) { __stcs(o, v); }
__device__ __forceinline__ void store1(__nv_bfloat16* o, __nv_bfloat16 v) {
  __stcs(reinterpret_cast<unsigned short*>(o), __bfloat16_as_ushort(v));
}
__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ unsigned bf16_bits(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) | (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const __nv_bfloat16 (&v)[4]) {
  __stcs(reinterpret_cast<uint2*>(o), make_uint2(bf16_bits(v[0], v[1]), bf16_bits(v[2], v[3])));
}

// Pixels [p, p + count) of the frame's three planes from their bytes.
template <typename E>
__device__ __forceinline__ void store_quad(E* out, int plane, int p, int count, const unsigned (&q)[3],
                                           const E* lut, bool vec4) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    E v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 3 * j + ch;
      v[j] = lut[(q[i >> 2] >> (8 * (i & 3))) & 0xffu];
    }
    E* o = out + ch * plane + p;
    if (vec4) {
      store4(o, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < count) store1(o + j, v[j]);
    }
  }
}

// grid (quads of a frame / kEvalThreads, min(frames, kMaxFrameBlocks));
// table 16-byte aligned, read as 16-byte words (64 of floats, 32 of bf16;
// one load each for as many threads: at one lane a thread's chain of loads
// is the kernel's time).
template <typename E>
__global__ void __launch_bounds__(kEvalThreads)
    preprocess_rgb_kernel(const uint8_t* __restrict__ src, const uint4* __restrict__ table,
                          E* __restrict__ dst, long long frames, int plane, bool words, bool vec4) {
  constexpr int kTableWords = 256 * sizeof(E) / 16;
  __shared__ __align__(16) E lut[256];
  if (threadIdx.x < kTableWords) reinterpret_cast<uint4*>(lut)[threadIdx.x] = table[threadIdx.x];
  const int p = 4 * (blockIdx.x * kEvalThreads + threadIdx.x);
  const int count = min(4, plane - p);
  const long long frame_elems = 3ll * plane;
  long long n = blockIdx.y;
  unsigned q[3];
  if (count > 0) load_quad(q, src + n * frame_elems, p, count, words);
  __syncthreads();
  if (count <= 0) return;
  for (;;) {
    store_quad(dst + n * frame_elems, plane, p, count, q, lut, vec4);
    n += gridDim.y;
    if (n >= frames) return;
    load_quad(q, src + n * frame_elems, p, count, words);
  }
}

constexpr int kBand = 8;  // output rows per band, one warp each
constexpr int kShiftThreads = 32 * kBand;

__device__ __forceinline__ int clamp_index(int v, int hi) { return min(max(v, 0), hi); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Copy the bytes [lo, hi) into buf so that the byte at address a lands at
// buf[a - align16(lo)], with 16-byte cp.async for the aligned body and
// byte copies for the unaligned head and tail; commits one cp.async group.
// Returns lo's offset in buf.
__device__ __forceinline__ int stage_bytes(uint8_t* buf, const uint8_t* lo, const uint8_t* hi) {
  using u64 = unsigned long long;
  const u64 a = reinterpret_cast<u64>(lo), b = reinterpret_cast<u64>(hi);
  const u64 base = a & ~15ull;
  const u64 up = (a + 15) & ~15ull;
  const u64 body_lo = up < b ? up : b;
  const u64 down = b & ~15ull;
  const u64 body_hi = down > body_lo ? down : body_lo;
  for (u64 p = a + threadIdx.x; p < body_lo; p += kShiftThreads)
    buf[p - base] = *reinterpret_cast<const uint8_t*>(p);
  const int chunks = static_cast<int>((body_hi - body_lo) >> 4);
  uint8_t* body = buf + (body_lo - base);
  for (int i = threadIdx.x; i < chunks; i += kShiftThreads)
    cp_async16(body + 16 * i, reinterpret_cast<const void*>(body_lo + 16ull * i));
  for (u64 p = body_hi + threadIdx.x; p < b; p += kShiftThreads)
    buf[p - base] = *reinterpret_cast<const uint8_t*>(p);
  cp_async_commit();
  return static_cast<int>(a - base);
}

// Stage the source rows of output rows [y0, y0 + kBand) of a frame shifted
// by s_r; sets row_lo to the first of them and returns its offset in buf.
__device__ __forceinline__ int stage_band(uint8_t* buf, const uint8_t* frame, int y0, int h,
                                          int row_bytes, int s_r, int& row_lo) {
  row_lo = clamp_index(s_r + y0, h - 1);
  const int row_hi = clamp_index(s_r + min(y0 + kBand, h) - 1, h - 1);
  return stage_bytes(buf, frame + row_lo * row_bytes, frame + (row_hi + 1) * row_bytes);
}

// One block per frame; shared memory: the 256-entry table (kLutBytes,
// room for floats), then two band buffers of buf_bytes each.
constexpr int kLutBytes = 256 * sizeof(float);

template <typename E>
__global__ void __launch_bounds__(kShiftThreads)
    preprocess_rgb_shift_kernel(const uint8_t* __restrict__ src, const int* __restrict__ shifts,
                                const E* __restrict__ table, E* __restrict__ dst, int h,
                                int w, int c, int pad, int buf_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  E* lut = reinterpret_cast<E*>(smem);
  uint8_t* const bufs = smem + kLutBytes;
  const int n = blockIdx.x;
  const int row_bytes = w * c;
  const int plane = h * w;
  const uint8_t* frame = src + static_cast<long long>(n) * h * row_bytes;
  E* out = dst + static_cast<long long>(n) * c * plane;
  const int s_r = shifts[2 * n] - pad, s_c = shifts[2 * n + 1] - pad;
  for (int i = threadIdx.x; i < 256; i += kShiftThreads) lut[i] = table[i];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec4 = (w & 3) == 0;  // rows of whole quads: 4-element stores
  int lo = 0, lo_next = 0, off_next = 0;
  int off = stage_band(bufs, frame, 0, h, row_bytes, s_r, lo);
  for (int y0 = 0, k = 0; y0 < h; y0 += kBand, k ^= 1) {
    if (y0 + kBand < h) {
      off_next = stage_band(bufs + (k ^ 1) * buf_bytes, frame, y0 + kBand, h, row_bytes, s_r, lo_next);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int y = y0 + warp;
    if (y < h) {
      const uint8_t* srow = bufs + k * buf_bytes + off + (clamp_index(s_r + y, h - 1) - lo) * row_bytes;
      for (int ch = 0; ch < c; ++ch) {
        E* orow = out + ch * plane + y * w;
        for (int x0 = 4 * lane; x0 < w; x0 += 128) {
          E v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sx = clamp_index(s_c + x0 + j, w - 1);
            v[j] = lut[srow[sx * c + ch]];
          }
          if (vec4) {
            store4(orow + x0, v);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (x0 + j < w) store1(orow + x0 + j, v[j]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is staged again two bands on
    lo = lo_next;
    off = off_next;
  }
}

template <typename E>
int launch_eval(const void* src, const void* table, void* dst, long long n, int h, int w, int c, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  if (c != 3 || static_cast<long long>(h) * w > 0x7fffffffLL - 4) return static_cast<int>(cudaErrorInvalidValue);
  const int plane = h * w;
  const long long quads = (plane + 3) / 4;
  const dim3 grid(static_cast<unsigned int>((quads + kEvalThreads - 1) / kEvalThreads),
                  static_cast<unsigned int>(n < kMaxFrameBlocks ? n : kMaxFrameBlocks));
  const bool words = reinterpret_cast<unsigned long long>(src) % 4 == 0 && plane % 4 == 0;
  preprocess_rgb_kernel<E><<<grid, kEvalThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint4*>(table), static_cast<E*>(dst), n, plane,
      words, plane % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_shift(const void* src, const void* shifts, const void* table, void* dst, long long n, int h, int w,
                 int c, int pad, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (n > 0x7fffffffLL || static_cast<long long>(c) * h * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int buf_bytes = (kBand * w * c + 16 + 15) & ~15;  // a band's rows and the 16-byte slack
  const int smem = kLutBytes + 2 * buf_bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(preprocess_rgb_shift_kernel<E>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  preprocess_rgb_shift_kernel<E><<<static_cast<unsigned int>(n), kShiftThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int*>(shifts),
      static_cast<const E*>(table), static_cast<E*>(dst), h, w, c, pad, buf_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// RGB frames only (c == 3); table and dst 16-byte aligned. The table and
// dst hold floats here and bf16 in the _bf16 instance.
extern "C" int hulc_preprocess_rgb(const void* src, const void* table, void* dst, long long n, int h, int w,
                                   int c, void* stream) {
  return launch_eval<float>(src, table, dst, n, h, w, c, stream);
}

extern "C" int hulc_preprocess_rgb_bf16(const void* src, const void* table, void* dst, long long n, int h, int w,
                                        int c, void* stream) {
  return launch_eval<__nv_bfloat16>(src, table, dst, n, h, w, c, stream);
}

extern "C" int hulc_preprocess_rgb_shift(const void* src, const void* shifts, const void* table,
                                         void* dst, long long n, int h, int w, int c, int pad,
                                         void* stream) {
  return launch_shift<float>(src, shifts, table, dst, n, h, w, c, pad, stream);
}

extern "C" int hulc_preprocess_rgb_shift_bf16(const void* src, const void* shifts, const void* table,
                                              void* dst, long long n, int h, int w, int c, int pad,
                                              void* stream) {
  return launch_shift<__nv_bfloat16>(src, shifts, table, dst, n, h, w, c, pad, stream);
}

extern "C" const char* hulc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
