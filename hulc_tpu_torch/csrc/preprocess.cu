// uint8 camera frames -> normalized fp32 in the layout nn.Conv2d reads.
//
// Replaces the eval branch of hulc_tpu/ops/image_ops.py preprocess_rgb /
// preprocess_rgb_seq (lines 85-154): v -> (v * (1/255) - mean) / std, which
// the JAX package leaves to an XLA fusion. This kernel also moves the
// channel axis, reading NHWC (what the camera gives) and writing NCHW (what
// the first convolution reads), so the transpose costs no extra pass.
//
// Bound on the H100: bytes. Each element is one byte read and four written
// for three flops, so at 3.35 TB/s the policy's 64-lane static frame
// (64x200x200x3) needs about 11.5 us; at one lane the launch latency (a few
// us) is the bound. Design: one thread per output element in NCHW order,
// so the fp32 stores of a warp are contiguous and its byte loads fall in
// one 96-byte span. The arithmetic uses the round-to-nearest intrinsics so
// nvcc does not contract it into an FMA: the result is bit-equal to the
// plain PyTorch version's separate multiply, subtract and divide.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void preprocess_rgb_kernel(const uint8_t* __restrict__ src, float* __restrict__ dst,
                                      long long total, int h, int w, int c, float mean,
                                      float std) {
  long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  // o indexes (n, ch, y, x) in NCHW order
  int x = static_cast<int>(o % w);
  long long t = o / w;
  int y = static_cast<int>(t % h);
  t /= h;
  int ch = static_cast<int>(t % c);
  long long n = t / c;
  uint8_t v = src[((n * h + y) * w + x) * c + ch];
  float scaled = __fmul_rn(static_cast<float>(v), 1.0f / 255.0f);
  dst[o] = __fdiv_rn(__fsub_rn(scaled, mean), std);
}

}  // namespace

extern "C" int hulc_preprocess_rgb(const void* src, void* dst, long long n, int h, int w, int c,
                                   float mean, float std, void* stream) {
  long long total = n * h * w * c;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    preprocess_rgb_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), static_cast<float*>(dst), total, h, w, c, mean, std);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hulc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
