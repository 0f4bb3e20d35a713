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
//
// hulc_preprocess_rgb_shift is the train-time variant. It replaces
// hulc_tpu/ops/image_ops.py random_shift / _shift_matmul (lines 27-82): a
// per-frame integer crop of the replicate-padded frame, which the JAX
// package computes as two one-hot selection matmuls on the TPU's matrix
// unit. Here it is what it is, a clamped gather: output pixel (y, x) of
// frame n reads source pixel (clip(s_r + y - pad), clip(s_c + x - pad)),
// with (s_r, s_c) = shifts[n] in [0, 2 * pad]. The gather is exact on
// uint8, and the normalize that follows is the same intrinsic sequence as
// above, so the result is bit-equal to the plain version. Bound: bytes, as
// above (the training batch, 2048 frames of 200 px and 84 px, is about
// 1.45 GB of u8 in and fp32 out, 0.43 ms at 3.35 TB/s). Design: one thread
// per output element, as above; the shifted reads of a warp stay within
// one or two source rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float normalize(uint8_t v, float mean, float std) {
  float scaled = __fmul_rn(static_cast<float>(v), 1.0f / 255.0f);
  return __fdiv_rn(__fsub_rn(scaled, mean), std);
}

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
  dst[o] = normalize(src[((n * h + y) * w + x) * c + ch], mean, std);
}

__global__ void preprocess_rgb_shift_kernel(const uint8_t* __restrict__ src,
                                            const int* __restrict__ shifts,
                                            float* __restrict__ dst, long long total, int h,
                                            int w, int c, int pad, float mean, float std) {
  long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int x = static_cast<int>(o % w);
  long long t = o / w;
  int y = static_cast<int>(t % h);
  t /= h;
  int ch = static_cast<int>(t % c);
  long long n = t / c;
  int sy = min(max(shifts[2 * n] + y - pad, 0), h - 1);
  int sx = min(max(shifts[2 * n + 1] + x - pad, 0), w - 1);
  dst[o] = normalize(src[((n * h + sy) * w + sx) * c + ch], mean, std);
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

extern "C" int hulc_preprocess_rgb_shift(const void* src, const void* shifts, void* dst,
                                         long long n, int h, int w, int c, int pad, float mean,
                                         float std, void* stream) {
  long long total = n * h * w * c;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    preprocess_rgb_shift_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), static_cast<const int*>(shifts),
        static_cast<float*>(dst), total, h, w, c, pad, mean, std);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hulc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
