// A chunk of queries attending the live paged KV prefix, causal GQA.
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/paged_prefill.py
// (paged_chunk_attention). One kernel serves the cold paged prefill
// (q_starts = 0), the warm suffix prefill over a forked prefix-cache chain
// (q_starts = the window start) and verify-shaped chunks (q_starts = the
// shared slot). The body is chunk_prefill.cuh's, the dense chunk kernel's,
// with PagedLayout resolving each key row of a 64-key tile through the block
// table. The TPU kernel's clamp of the logical page into the live range
// before the lookup becomes the key loop's bounds [max(k_start, window
// start), min(q0 + rows, length)); a query tile with no live key still
// writes zeros, and an all-masked row comes out exactly 0.
//
// Bound on the H100: as the dense chunk kernel, the products (compute-bound
// at prefill shapes); the table lookup adds one cached 4-byte load per
// 16-byte K/V copy.
#include "chunk_prefill.cuh"

// q: [b, chunk, n_q, hd], out the same, through strides (qsb, qss, qsh) /
// (osb, oss, osh) in elements, hd contiguous; k, v: one layer's pool
// [n_pages + 1, n_kv, page_size, hd], contiguous; tables: [b, n_p] int32 with
// row stride table_stride; q and out of dtype, the pool of kv_dtype (dtype,
// or kF8). q_starts, lengths, k_starts: [b] int32 on the
// device; flag: one int32 on the device or NULL (= window always on); window
// <= 0 = none; softcap <= 0 = none.
extern "C" int cake_paged_chunk_attention(const void* q, const void* k, const void* v,
                                          void* out, const void* q_starts, const void* lengths,
                                          const void* k_starts, const void* tables,
                                          const void* flag, int b, int chunk, int n_q, int n_kv,
                                          int page_size, int n_p, long long table_stride,
                                          int head_dim, int dtype, int kv_dtype, long long qsb,
                                          long long qss, long long qsh, long long osb,
                                          long long oss, long long osh, int window,
                                          float scale, float softcap, void* stream) {
  using namespace cake;
  if (n_kv < 1 || n_q % n_kv || page_size < 1 || n_p < 1) return (int)cudaErrorInvalidValue;
  ChunkArgs<PagedLayout> a{q, k, v, out,
                           static_cast<const int*>(q_starts),
                           static_cast<const int*>(lengths),
                           static_cast<const int*>(k_starts),
                           static_cast<const int*>(flag),
                           PagedLayout{static_cast<const int*>(tables), table_stride, n_p, n_kv,
                                       page_size},
                           b, chunk, n_q, n_q / n_kv,
                           qsb, qss, qsh, osb, oss, osh,
                           window, scale, softcap, static_cast<cudaStream_t>(stream)};
  return run_chunk(dtype, kv_dtype, head_dim, a);
}
