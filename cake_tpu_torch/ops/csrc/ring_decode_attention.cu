// One-query GQA attention over the rolling window cache (decode).
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/decode_attention.py
// (decode_attention) on the rolling path, which the reference runs on XLA
// (cake_tpu/models/llama/model.py block_forward, rolling: gqa_attention_hm
// over rolling_kv_positions). The body is decode_attention.cuh's, the
// dense kernel's, with RingLayout turning logical key position j into ring
// slot j mod L (kv_layout.cuh): the splits, the warps' keys and the merge
// order are the dense kernel's at the same logical bound, so on the same
// keys the two give the same bits. The window, folded into starts by the
// wrapper, keeps every walk inside the last L positions.
//
// Bound on the H100: device-memory bytes, as the dense kernel; the ring
// adds one integer modulo a split.
#include "decode_attention.cuh"

// As cake_decode_attention, with k, v: [b, n_kv, ring, head_dim] (ring = L,
// a multiple of DEC_SPLIT) and max_seq the logical bound of positions
// (>= ring); n_split = ceil(max_seq / DEC_SPLIT). The narrow head dims of
// the activations' dtype are instantiated here, the wide and the e4m3 ones
// in ring_decode_attention_{wide,f8,f8_wide}.cu.
extern "C" int cake_ring_decode_attention(const void* q, const void* k, const void* v,
                                          void* out, const void* lengths, const void* starts,
                                          void* part, void* tickets, int b, int n_kv, int group,
                                          int heads, int ring, int max_seq, int head_dim,
                                          int dtype, int kv_dtype, float scale, float softcap,
                                          int n_split, int z, void* stream) {
  using namespace cake;
  if (ring < DEC_SPLIT || ring % 128 || max_seq < ring) return (int)cudaErrorInvalidValue;
  DecodeArgs<RingLayout> a{q, k, v, out,
                           static_cast<const int*>(lengths), static_cast<const int*>(starts),
                           RingLayout{n_kv, ring, max_seq, 1.0f / (float)ring}, b, n_kv, group, heads, scale,
                           softcap, static_cast<float*>(part), static_cast<int*>(tickets),
                           n_split, z, static_cast<cudaStream_t>(stream)};
  return run_decode(dtype, kv_dtype, head_dim, max_seq, a);
}
