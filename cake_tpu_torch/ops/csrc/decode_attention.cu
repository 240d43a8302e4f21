// One-query GQA attention over the dense head-major KV cache (decode).
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/decode_attention.py
// (decode_attention). The kernel body, its bound and its design are in
// decode_attention.cuh, shared with the paged kernel.
#include "decode_attention.cuh"

// q, out: [b, n_q, head_dim] of dtype; k, v: [b, n_kv, max_seq, head_dim] of
// kv_dtype (dtype, or kF8), all contiguous.
// lengths, starts: [b] int32 on the device (window already folded into starts).
// softcap <= 0 means no soft-cap. heads: query heads a block takes (the
// group, or a part of it; units = n_kv * ceil(group / heads)). part: f32
// scratch, acc [b, units, n_split, heads, head_dim] then (m, l) [b, units,
// n_split, heads, 2]; tickets: [b, units] int32, zero before the call and
// after it. n_split = ceil(max_seq / DEC_SPLIT), heads and z come from the
// shapes (ops/decode_attention.plan). Returns the CUDA error of the launch.
extern "C" int cake_decode_attention(const void* q, const void* k, const void* v, void* out,
                                     const void* lengths, const void* starts, void* part,
                                     void* tickets, int b, int n_kv, int group, int heads,
                                     int max_seq,
                                     int head_dim, int dtype, int kv_dtype, float scale,
                                     float softcap, int n_split, int z, void* stream) {
  using namespace cake;
  DecodeArgs<DenseLayout> a{q, k, v, out,
                           static_cast<const int*>(lengths), static_cast<const int*>(starts),
                           DenseLayout{n_kv, max_seq}, b, n_kv, group, heads, scale, softcap,
                           static_cast<float*>(part), static_cast<int*>(tickets), n_split, z,
                           static_cast<cudaStream_t>(stream)};
  return run_decode(dtype, kv_dtype, head_dim, max_seq, a);
}
