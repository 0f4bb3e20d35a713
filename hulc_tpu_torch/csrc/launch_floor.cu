// An empty kernel: the device time of one launch that does no work, the
// practical floor under every kernel's time at small shapes. Measured beside
// the kernels of the path; no path launches it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int hulc_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
