// The e4m3 (f8) cache instantiations of the dense decode kernel
// (decode_attention.cu) at head dims 64 and 96, in a translation unit of
// their own so that they compile in parallel with it. Body, bound and
// design: decode_attention.cuh.
#include "decode_attention.cuh"

namespace cake {

cudaError_t decode_f8(int dtype, int head_dim, const DecodeArgs<DenseLayout>& a) {
  return decode_by_dtype<f8, false>(dtype, head_dim, a);
}

}  // namespace cake
