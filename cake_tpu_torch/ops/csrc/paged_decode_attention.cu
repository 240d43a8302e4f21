// One-query GQA attention over the paged KV pool (decode).
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/paged_attention.py
// (paged_decode_attention). The body is decode_attention.cuh's, the dense
// kernel's, with PagedLayout turning a key slot into an address: page
// tables[row][j / page_size] (an unmapped entry reads page 0), offset
// j % page_size. The TPU kernel's clamp of the logical page into the live
// range becomes the split bounds: only the splits of [start, length) are
// ever walked. A split of DEC_SPLIT keys lies inside one page, so a block
// looks its page up once and reads the split's keys from one base. Key
// splits, and key slots within them, go to warps by position as in the dense
// kernel, so on the same keys the two give the same bits.
//
// Bound on the H100: device-memory bytes, as the dense kernel. The table
// lookup is one 4-byte load a split of DEC_SPLIT key rows.
#include "decode_attention.cuh"

// q, out: [b, n_q, head_dim] of dtype; k, v: one layer's pool [n_pages + 1,
// n_kv, page_size, head_dim] of kv_dtype (dtype, or kF8), contiguous. lengths, starts: [b] int32 (window folded
// into starts); tables: [b, n_p] int32 with row stride table_stride
// (elements), head_dim contiguous. softcap <= 0 means none. heads, part,
// tickets, n_split (= ceil(n_p * page_size / DEC_SPLIT)) and z: as
// cake_decode_attention.
extern "C" int cake_paged_decode_attention(const void* q, const void* k, const void* v,
                                           void* out, const void* lengths, const void* starts,
                                           const void* tables, void* part, void* tickets, int b,
                                           int n_kv, int group, int heads, int page_size,
                                           int n_p,
                                           long long table_stride, int head_dim, int dtype,
                                           int kv_dtype, float scale, float softcap,
                                           int n_split, int z, void* stream) {
  using namespace cake;
  if (page_size < 1 || n_p < 1 || page_size % DEC_SPLIT) return (int)cudaErrorInvalidValue;
  DecodeArgs<PagedLayout> a{q, k, v, out,
                            static_cast<const int*>(lengths), static_cast<const int*>(starts),
                            PagedLayout{static_cast<const int*>(tables), table_stride, n_p,
                                        n_kv, page_size},
                            b, n_kv, group, heads, scale, softcap,
                            static_cast<float*>(part), static_cast<int*>(tickets), n_split, z,
                            static_cast<cudaStream_t>(stream)};
  return run_decode(dtype, kv_dtype, head_dim, n_p * page_size, a);
}
