// The ring decode kernel (ring_decode_attention.cu) at head dims 128 and
// 256, in a translation unit of its own so that it compiles in parallel
// with the rest. Body, bound and design: decode_attention.cuh.
#include "decode_attention.cuh"

namespace cake {

cudaError_t decode_wide(int dtype, int head_dim, const DecodeArgs<RingLayout>& a) {
  return decode_by_dtype<void, true>(dtype, head_dim, a);
}

}  // namespace cake
