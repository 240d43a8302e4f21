// The e4m3 (f8) cache instantiations of the ring decode kernel
// (ring_decode_attention.cu) at head dims 64 and 96, in a translation unit
// of their own. Body, bound and design: decode_attention.cuh.
#include "decode_attention.cuh"

namespace cake {

cudaError_t decode_f8(int dtype, int head_dim, const DecodeArgs<RingLayout>& a) {
  return decode_by_dtype<f8, false>(dtype, head_dim, a);
}

}  // namespace cake
