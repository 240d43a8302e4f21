// One-query GQA attention over the paged KV pool (decode).
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/paged_attention.py
// (paged_decode_attention). The body is decode_attention.cuh's, the dense
// kernel's, with PagedLayout turning a key slot into an address: page
// tables[row][j / page_size] (an unmapped entry reads page 0), offset
// j % page_size. The TPU kernel's clamp of the logical page into the live
// range before the lookup becomes the loop bound: only [start, length) is
// ever walked. Key slots go to warps as in the dense kernel, so on the same
// keys the two give the same bits.
//
// Bound on the H100: device-memory bytes, as the dense kernel. The table
// lookup is one cached 4-byte load per key row of head_dim * 2 bytes.
#include "decode_attention.cuh"

// q, out: [b, n_q, head_dim]; k, v: one layer's pool [n_pages + 1, n_kv,
// page_size, head_dim], contiguous. lengths, starts: [b] int32 (window folded
// into starts); tables: [b, n_p] int32 with row stride table_stride
// (elements), head_dim contiguous. softcap <= 0 means none.
extern "C" int cake_paged_decode_attention(const void* q, const void* k, const void* v,
                                           void* out, const void* lengths, const void* starts,
                                           const void* tables, int b, int n_kv, int group,
                                           int page_size, int n_p, long long table_stride,
                                           int head_dim, int dtype, float scale,
                                           float softcap, void* stream) {
  using namespace cake;
  if (page_size < 1 || n_p < 1) return (int)cudaErrorInvalidValue;
  DecodeArgs<PagedLayout> a{q, k, v, out,
                            static_cast<const int*>(lengths), static_cast<const int*>(starts),
                            PagedLayout{static_cast<const int*>(tables), table_stride, n_p,
                                        n_kv, page_size},
                            b, n_kv, group, scale, softcap,
                            static_cast<cudaStream_t>(stream)};
  return run_decode(dtype, head_dim, a);
}
