// The training noise on depth frames, from a standard-normal draw z: the
// caller's (the z mode) or one this launch makes itself (the draw mode).
//
// Replaces hulc_tpu/training/preprocess.py _prep_depth (lines 58-80), which
// the JAX package leaves to an XLA fusion: on the static camera the
// Wilson-Hilferty form of the reference's Gamma(1000) / 1000 noise,
//   y = x * m * m * m,  m = (1 - c) + z * sqrt(c),  c = 1 / 9000,
// and on the gripper camera y = x + std * z. The host passes the constants
// as fp32, rounded as JAX rounds them (ops/depth_noise.py): a = 1 - c and
// b = sqrt(c) for the gamma mode, a unused and b = std for the gaussian one.
// Every product and sum is its own __fmul_rn / __fadd_rn: nvcc would
// otherwise contract a + z * b into one FMA, and the result would no longer
// be the plain version's bit for bit. The cube is m * (m * m), as
// lax.integer_pow expands it.
//
// The draw mode. The train step used to draw z with torch.randn (96.3 M
// normals a hulc_depth step, 385.5 MB written) and this pass read it back.
// Here each group of four elements of the global (one-device) draw takes
// one Philox4x32-10 block: counter (group index, low and high words; the
// generator's offset, low and high words), key (the generator's seed, its
// high word xor kDomain, so no counter of this draw is one of torch's own on
// the same generator, whose key is the seed itself). Box-Muller turns the
// four words into four normals: u = w * 2^-32 + 2^-33 in (0, 1],
// r = sqrt(-2 log u0), (z0, z1) = r * (cos, sin)(2 pi u1), and z2, z3 the
// same from w2, w3. The wrapper then moves the generator's offset on by 4
// (each group used four values of its counter), so the next call draws
// afresh and a restored generator draws the same noise again. A rank of a
// data-parallel step computes only its rows: the launch covers `blocks`
// blocks of rows, block k starting at global element k * block_stride +
// base, so a rank's values are its rows of the one-device draw bit for bit.
// A debug launch also writes z and the raw words, for the checks.
//
// Bound on the H100: bytes. The z mode reads x and z and writes y, 12 bytes
// an element (the static camera, 64 x 32 x 200 x 200 fp32: 0.293 ms at
// 3.35 TB/s, the gripper camera at 84 px 0.052 ms), and the step's
// torch.randn wrote z before it; the draw mode reads x and writes y, 8
// bytes (0.1956 / 0.0345 ms). Its arithmetic (ten Philox rounds a group,
// one log, one sqrt and one sincospi a pair) is about 40 instructions an
// element, under the bytes' time at the card's issue rate. Both modes are
// the plain elementwise design: a grid-stride loop over groups of four
// elements, one 16-byte load of x (and of z) and one 16-byte store of y per
// group with streaming hints; the z mode's last n % 4 elements one by one.
// In the z mode y may be z's buffer (a fresh draw is read once, before its
// element is written), never x's.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;
constexpr unsigned kDomain = 0x48554C43u;  // "HULC": the draw's key differs from torch's on the same seed
constexpr float kTwoPow32Inv = 2.3283064365386963e-10f;  // 2^-32

template <int Mode>
__device__ __forceinline__ float noised(float x, float z, float a, float b) {
  if (Mode == 0) {
    const float m = __fadd_rn(a, __fmul_rn(z, b));
    return __fmul_rn(x, __fmul_rn(m, __fmul_rn(m, m)));
  }
  return __fadd_rn(x, __fmul_rn(b, z));
}

// Philox4x32-10 (Salmon et al., SC 2011): ten rounds, the key bumped between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, unsigned k0, unsigned k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned lo0 = kPhiloxM0 * ctr.x, hi0 = __umulhi(kPhiloxM0, ctr.x);
    const unsigned lo1 = kPhiloxM1 * ctr.z, hi1 = __umulhi(kPhiloxM1, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return ctr;
}

__device__ __forceinline__ float uniform(unsigned w) {  // (0, 1]
  return fmaf(__uint2float_rn(w), kTwoPow32Inv, 0.5f * kTwoPow32Inv);
}

__device__ __forceinline__ float2 box_muller(unsigned w0, unsigned w1) {
  const float r = sqrtf(-2.0f * logf(uniform(w0)));
  float s, c;
  sincospif(2.0f * uniform(w1), &s, &c);
  return make_float2(r * c, r * s);
}

template <int Mode>
__global__ void __launch_bounds__(kThreads)
    depth_noise_kernel(const float4* x, const float4* z, float4* y, long long groups, const float* x_tail,
                       const float* z_tail, float* y_tail, int tail, float a, float b) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < groups; i += stride) {
    const float4 xv = __ldcs(x + i), zv = __ldcs(z + i);
    __stcs(y + i, make_float4(noised<Mode>(xv.x, zv.x, a, b), noised<Mode>(xv.y, zv.y, a, b),
                              noised<Mode>(xv.z, zv.z, a, b), noised<Mode>(xv.w, zv.w, a, b)));
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail)
    y_tail[threadIdx.x] = noised<Mode>(x_tail[threadIdx.x], z_tail[threadIdx.x], a, b);
}

// Block of rows blockIdx.y: `groups` groups of four local elements, its first
// the global group blockIdx.y * stride_groups + base_groups.
template <int Mode, bool Debug>
__global__ void __launch_bounds__(kThreads)
    depth_noise_draw_kernel(const float4* x, float4* y, long long groups, long long stride_groups,
                            long long base_groups, unsigned k0, unsigned k1, unsigned off_lo, unsigned off_hi,
                            float a, float b, float4* z_out, uint4* words_out) {
  const long long local0 = static_cast<long long>(blockIdx.y) * groups;
  const long long global0 = static_cast<long long>(blockIdx.y) * stride_groups + base_groups;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < groups; i += stride) {
    const float4 xv = __ldcs(x + local0 + i);
    const unsigned long long g = static_cast<unsigned long long>(global0 + i);
    const uint4 w = philox4x32_10(make_uint4(static_cast<unsigned>(g), static_cast<unsigned>(g >> 32), off_lo, off_hi),
                                  k0, k1);
    const float2 z01 = box_muller(w.x, w.y), z23 = box_muller(w.z, w.w);
    __stcs(y + local0 + i, make_float4(noised<Mode>(xv.x, z01.x, a, b), noised<Mode>(xv.y, z01.y, a, b),
                                       noised<Mode>(xv.z, z23.x, a, b), noised<Mode>(xv.w, z23.y, a, b)));
    if (Debug) {
      z_out[local0 + i] = make_float4(z01.x, z01.y, z23.x, z23.y);
      words_out[local0 + i] = w;
    }
  }
}

unsigned grid_cap(long long want, long long per) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  // enough blocks to fill every SM several times over; each thread then
  // walks its rows with the grid's stride
  const long long cap = (8LL * sms + per - 1) / per;
  return static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
}

template <int Mode>
cudaError_t launch(const float* x, const float* z, float* y, long long n, float a, float b, cudaStream_t stream) {
  const long long groups = n / 4;
  const int tail = static_cast<int>(n % 4);
  const unsigned blocks = grid_cap((groups + kThreads - 1) / kThreads, 1);
  if (blocks == 0) return cudaGetLastError();
  depth_noise_kernel<Mode><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(z), reinterpret_cast<float4*>(y), groups,
      x + 4 * groups, z + 4 * groups, y + 4 * groups, tail, a, b);
  return cudaGetLastError();
}

template <int Mode, bool Debug>
cudaError_t launch_draw(const float* x, float* y, long long n, int row_blocks, long long block_stride,
                        long long base, unsigned long long seed, unsigned long long offset, float a, float b,
                        float* z_out, unsigned* words_out, cudaStream_t stream) {
  const long long groups = n / row_blocks / 4;
  const unsigned blocks = grid_cap((groups + kThreads - 1) / kThreads, row_blocks);
  if (blocks == 0) return cudaGetLastError();
  const dim3 grid(blocks, static_cast<unsigned>(row_blocks));
  depth_noise_draw_kernel<Mode, Debug><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), groups, block_stride / 4, base / 4,
      static_cast<unsigned>(seed), static_cast<unsigned>(seed >> 32) ^ kDomain, static_cast<unsigned>(offset),
      static_cast<unsigned>(offset >> 32), a, b, reinterpret_cast<float4*>(z_out), reinterpret_cast<uint4*>(words_out));
  return cudaGetLastError();
}

template <int Mode>
cudaError_t dispatch_draw(const float* x, float* y, long long n, int row_blocks, long long block_stride,
                          long long base, unsigned long long seed, unsigned long long offset, float a, float b,
                          float* z_out, unsigned* words_out, cudaStream_t stream) {
  if (z_out != nullptr)
    return launch_draw<Mode, true>(x, y, n, row_blocks, block_stride, base, seed, offset, a, b, z_out, words_out,
                                   stream);
  return launch_draw<Mode, false>(x, y, n, row_blocks, block_stride, base, seed, offset, a, b, nullptr, nullptr,
                                  stream);
}

}  // namespace

// x, y: n fp32 each, 16-byte aligned, y never x. mode 0: gamma (a = 1 - c,
// b = sqrt(c)), mode 1: gaussian (b = std).
// The z mode (z not null): z holds the n draws, 16-byte aligned, and y may
// be z; the draw's arguments are ignored.
// The draw mode (z null): x holds row_blocks blocks of n / row_blocks
// elements, each a multiple of 4; block k's first element is element
// k * block_stride + base of the global draw (both multiples of 4); seed and
// offset are the generator's initial_seed() and get_offset(). z_out and
// words_out are both null, or take the n normals (fp32) and the n raw Philox
// words (uint32), 16-byte aligned.
extern "C" int hulc_depth_noise(const void* x, const void* z, void* y, long long n, int mode, float a, float b,
                                int row_blocks, long long block_stride, long long base, unsigned long long seed,
                                unsigned long long offset, void* z_out, void* words_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto misaligned = [](const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(y) || x == y || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (z != nullptr) {
    if (misaligned(z)) return static_cast<int>(cudaErrorInvalidValue);
    const auto* zf = static_cast<const float*>(z);
    return static_cast<int>(mode == 0 ? launch<0>(xf, zf, yf, n, a, b, s) : launch<1>(xf, zf, yf, n, a, b, s));
  }
  if (row_blocks <= 0 || row_blocks > 65535 || n % (4LL * row_blocks) != 0 || block_stride % 4 != 0 ||
      base % 4 != 0 || block_stride < n / row_blocks || base < 0 || (z_out == nullptr) != (words_out == nullptr) ||
      (z_out != nullptr && (misaligned(z_out) || misaligned(words_out))))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* zo = static_cast<float*>(z_out);
  auto* wo = static_cast<unsigned*>(words_out);
  return static_cast<int>(mode == 0
                              ? dispatch_draw<0>(xf, yf, n, row_blocks, block_stride, base, seed, offset, a, b, zo, wo, s)
                              : dispatch_draw<1>(xf, yf, n, row_blocks, block_stride, base, seed, offset, a, b, zo, wo, s));
}
