// The e4m3 (f8) cache instantiations of the paged decode kernel
// (paged_decode_attention.cu) at head dims 128 and 256, in a translation
// unit of their own so that they compile in parallel with the rest. Body,
// bound and design: decode_attention.cuh.
#include "decode_attention.cuh"

namespace cake {

cudaError_t decode_f8_wide(int dtype, int head_dim, const DecodeArgs<PagedLayout>& a) {
  return decode_by_dtype<f8, true>(dtype, head_dim, a);
}

}  // namespace cake
