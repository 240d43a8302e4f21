// A chunk of queries attending the rolling window cache (prefill), causal
// GQA.
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/chunk_prefill.py
// (chunk_prefill_attention) on the rolling path's continuation chunks,
// which the reference runs on XLA (cake_tpu/models/llama/model.py
// block_forward, rolling: gqa_attention_hm over rolling_kv_positions). The
// body is chunk_prefill.cuh's, the dense kernel's, with RingLayout turning
// logical key position j into ring slot j mod L (kv_layout.cuh): tiles,
// loop bounds and arithmetic are the dense kernel's at the same logical
// bound, so on the same keys the two give the same bits. The window keeps
// every tile inside the last L positions (L >= window + chunk, checked by
// the wrapper).
//
// Bound on the H100: the products, as the dense chunk kernel (compute-bound
// at prefill shapes); the ring adds one integer modulo a 16-byte copy.
#include "chunk_prefill.cuh"

namespace cake {

cudaError_t ring_chunk_f8(int dtype, int head_dim, const ChunkArgs<RingLayout>& a);

}  // namespace cake

// q: [b, chunk, n_q, hd], out the same, through strides (qsb, qss, qsh) /
// (osb, oss, osh) in elements, hd contiguous; k, v: the ring [b, n_kv, ring,
// hd] of kv_dtype (dtype, or kF8), contiguous, ring a multiple of 128;
// max_seq: the logical bound of positions (>= ring). q_starts, lengths,
// k_starts: [b] int32 on the device; flag: one int32 on the device or NULL
// (= window always on); window <= 0 = none; softcap <= 0 = none. The e4m3
// cache's instantiations are in ring_chunk_attention_f8.cu.
extern "C" int cake_ring_chunk_attention(const void* q, const void* k, const void* v, void* out,
                                         const void* q_starts, const void* lengths,
                                         const void* k_starts, const void* flag, int b,
                                         int chunk, int n_q, int n_kv, int ring, int max_seq,
                                         int head_dim, int dtype, int kv_dtype, long long qsb,
                                         long long qss, long long qsh, long long osb,
                                         long long oss, long long osh, int window, float scale,
                                         float softcap, void* stream) {
  using namespace cake;
  if (n_kv < 1 || n_q % n_kv || ring < 128 || ring % 128 || max_seq < ring)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype != dtype && kv_dtype != kF8) return (int)cudaErrorInvalidValue;
  if (chunk < 1 || b < 1) return (int)cudaSuccess;
  ChunkArgs<RingLayout> a{q, k, v, out,
                          static_cast<const int*>(q_starts),
                          static_cast<const int*>(lengths),
                          static_cast<const int*>(k_starts),
                          static_cast<const int*>(flag),
                          RingLayout{n_kv, ring, max_seq, 1.0f / (float)ring},
                          b, chunk, n_q, n_q / n_kv,
                          qsb, qss, qsh, osb, oss, osh,
                          window, scale, softcap, static_cast<cudaStream_t>(stream)};
  if (kv_dtype == kF8) return (int)ring_chunk_f8(dtype, head_dim, a);
  switch (dtype) {
    case kF32: return (int)chunk_by_head_dim<float, float>(head_dim, a);
    case kF16: return (int)chunk_by_head_dim<__half, __half>(head_dim, a);
    case kBF16: return (int)chunk_by_head_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
