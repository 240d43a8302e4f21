// An empty kernel: what one launch costs on the card, the floor under every
// kernel's time (chip_smoke.py reports it as launch_floor_ms beside the
// bounds of the small kernels).
#include <cuda_runtime.h>

namespace cake {
__global__ void empty_kernel() {}
}  // namespace cake

// One launch of one warp on `stream`; returns the launch's error.
extern "C" int cake_empty_kernel(void* stream) {
  cake::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
