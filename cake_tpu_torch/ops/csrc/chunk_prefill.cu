// A chunk of queries attending the live dense KV prefix (prefill), causal GQA.
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/chunk_prefill.py
// (chunk_prefill_attention) and, through it, the position-0 prefill of
// cake_tpu/ops/pallas/flash_attention.py. The kernel body, its bound and its
// design are in chunk_prefill.cuh, shared with the paged kernel.
#include "chunk_prefill.cuh"

// q: [b, chunk, n_q, hd] and out through strides (qsb, qss, qsh) / (osb, oss,
// osh), of dtype; k, v: [b, n_kv, kv_len, hd] of kv_dtype (dtype, or kF8)
// through (ksb, ksh, kss) / (vsb, vsh, vss);
// every stride in elements, hd contiguous. strides = {qsb, qss, qsh, ksb, ksh,
// kss, vsb, vsh, vss, osb, oss, osh} in host memory. q_starts, lengths,
// k_starts: [b] int32 on the device; flag: one int32 on the device or NULL
// (= window always on); window <= 0 = no window; softcap <= 0 = none.
extern "C" int cake_chunk_prefill_attention(const void* q, const void* k, const void* v,
                                            void* out, const void* q_starts,
                                            const void* lengths, const void* k_starts,
                                            const void* flag, int b, int chunk, int n_q,
                                            int n_kv, int kv_len, int head_dim, int dtype,
                                            int kv_dtype, const long long* st, int window,
                                            float scale,
                                            float softcap, void* stream) {
  using namespace cake;
  if (n_kv < 1 || n_q % n_kv) return (int)cudaErrorInvalidValue;
  ChunkArgs<StridedLayout> a{q, k, v, out,
                             static_cast<const int*>(q_starts),
                             static_cast<const int*>(lengths),
                             static_cast<const int*>(k_starts),
                             static_cast<const int*>(flag),
                             StridedLayout{st[3], st[4], st[5], st[6], st[7], st[8], kv_len},
                             b, chunk, n_q, n_q / n_kv,
                             st[0], st[1], st[2], st[9], st[10], st[11],
                             window, scale, softcap, static_cast<cudaStream_t>(stream)};
  return run_chunk(dtype, kv_dtype, head_dim, a);
}
