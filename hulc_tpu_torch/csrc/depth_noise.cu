// The training noise on depth frames, from a raw standard-normal draw z.
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
// Bound on the H100: bytes. Each element reads x and z and writes y, 12
// bytes, so the train step's static camera (64 x 32 x 200 x 200 fp32, 983 MB
// moved) needs 0.293 ms at 3.35 TB/s and the gripper camera (84 px, 173 MB)
// 0.052 ms. The design is the plain one for such a pass: a grid-stride loop
// over groups of four elements, one 16-byte load of x and of z and one
// 16-byte store of y per group (the wrapper hands over 16-byte aligned
// bases), the last n % 4 elements one by one. y may be z's buffer (a fresh
// draw is read once, before its element is written), never x's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int Mode>
__device__ __forceinline__ float noised(float x, float z, float a, float b) {
  if (Mode == 0) {
    const float m = __fadd_rn(a, __fmul_rn(z, b));
    return __fmul_rn(x, __fmul_rn(m, __fmul_rn(m, m)));
  }
  return __fadd_rn(x, __fmul_rn(b, z));
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

template <int Mode>
cudaError_t launch(const float* x, const float* z, float* y, long long n, float a, float b, cudaStream_t stream) {
  const long long groups = n / 4;
  const int tail = static_cast<int>(n % 4);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // enough blocks to fill every SM several times over; each thread then
  // walks the array with the grid's stride
  const long long want = (groups + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  const unsigned int blocks = static_cast<unsigned int>(want < 1 ? 1 : (want < cap ? want : cap));
  depth_noise_kernel<Mode><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(z), reinterpret_cast<float4*>(y), groups,
      x + 4 * groups, z + 4 * groups, y + 4 * groups, tail, a, b);
  return cudaGetLastError();
}

}  // namespace

// x, z, y: n fp32 each, 16-byte aligned; y may be z, not x. mode 0: gamma
// (a = 1 - c, b = sqrt(c)), mode 1: gaussian (b = std).
extern "C" int hulc_depth_noise(const void* x, const void* z, void* y, long long n, int mode, float a, float b,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto misaligned = [](const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(z) || misaligned(y) || x == y) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* zf = static_cast<const float*>(z);
  auto* yf = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return static_cast<int>(launch<0>(xf, zf, yf, n, a, b, s));
  if (mode == 1) return static_cast<int>(launch<1>(xf, zf, yf, n, a, b, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
