// The e4m3 (f8) cache instantiations of the ring chunk kernel
// (ring_chunk_attention.cu), in a translation unit of their own so that
// they compile in parallel with it. Body, bound and design:
// chunk_prefill.cuh.
#include "chunk_prefill.cuh"

namespace cake {

cudaError_t ring_chunk_f8(int dtype, int head_dim, const ChunkArgs<RingLayout>& a) {
  switch (dtype) {
    case kF32: return chunk_by_head_dim<float, f8>(head_dim, a);
    case kF16: return chunk_by_head_dim<__half, f8>(head_dim, a);
    case kBF16: return chunk_by_head_dim<__nv_bfloat16, f8>(head_dim, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cake
