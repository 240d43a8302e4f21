// Where the attention kernels find key slot j of (batch row, KV head).
//
// The dense and the paged kernels share their bodies (decode_attention.cuh,
// chunk_prefill.cuh) and differ only in this: a Layout gives the slot limit
// and, per (row, kv head), a cursor whose k<D>(j) / v<D>(j) are the element
// offsets of slot j's K and V rows (D: the head_dim, a template parameter). Which thread reads which slot, and all
// arithmetic, stay the same, so a paged kernel gives its dense twin's bits
// on the same keys. The decode kernel reads a split of keys through
// split<D>(j0): the offset of K's (and V's) slot j0, from which the next
// slots up to the next multiple of 128 follow D elements apart in both the
// dense cache and a page (every page size the paged kernels take is a
// multiple of 128).
#pragma once

#include <stddef.h>

namespace cake {

// The dense head-major cache [b, n_kv, max_seq, D], contiguous (the decode
// kernel's): the rows of one (row, kv head) are a compile-time D elements
// apart, so the TK keys of a warp step are immediate offsets from one
// address. (A runtime stride here cost the decode kernel half its speed.)
struct DenseCursor {
  size_t row0;  // first cache row of (row, kv head)
  template <int D>
  __device__ __forceinline__ size_t k(int j) const { return (row0 + (size_t)j) * D; }
  template <int D>
  __device__ __forceinline__ size_t v(int j) const { return k<D>(j); }
  template <int D>
  __device__ __forceinline__ size_t split(int j0) const { return k<D>(j0); }
};

struct DenseLayout {
  int n_kv, max_seq;
  __device__ __forceinline__ int limit() const { return max_seq; }
  __device__ __forceinline__ DenseCursor cursor(int row, int kvh) const {
    return {((size_t)row * n_kv + kvh) * (size_t)max_seq};
  }
};

// Dense K/V read through element strides, head_dim contiguous: the
// head-major cache [b, n_kv, max_seq, D] and the seq-major fresh
// projections [b, seq, n_kv, D] are both this (the chunk kernel's).
struct StridedCursor {
  size_t kb, vb;
  long long kss, vss;
  template <int D>
  __device__ __forceinline__ size_t k(int j) const { return kb + (size_t)j * kss; }
  template <int D>
  __device__ __forceinline__ size_t v(int j) const { return vb + (size_t)j * vss; }
};

struct StridedLayout {
  long long ksb, ksh, kss, vsb, vsh, vss;
  int kv_len;
  __device__ __forceinline__ int limit() const { return kv_len; }
  __device__ __forceinline__ StridedCursor cursor(int row, int kvh) const {
    return {(size_t)row * ksb + (size_t)kvh * ksh, (size_t)row * vsb + (size_t)kvh * vsh, kss,
            vss};
  }
};

// The rolling window cache [b, n_kv, L, D], contiguous (models/llama/
// cache.py write_layer_rolling): logical position j lives in ring slot
// j mod L. L is a multiple of 128 (the wrappers check it, and so do the C
// entry points), so a decode split of DEC_SPLIT positions and a 64-key chunk
// tile, both starting at multiples of their size, lie contiguous in the
// ring: split<D>(j0) takes one modulo and the split's keys follow D
// elements apart, as in DenseCursor. limit() is the LOGICAL bound (the
// full cache's length), never L: clamping walks at L would drop every key
// past the first wrap, and the decode grid (ops/decode_attention.plan) at
// the logical bound is the full cache's, which gives its bits. Which
// positions are live is the callers' (the window, always on over a ring:
// L holds the window plus the chunk being written).
//
// The chunk body resolves a slot for every 16-byte copy, so the modulo is
// taken without a division: the quotient from j times 1/L in f32 (exact to
// within one for positions below 2^24, far past any cache), then one
// correction each way. An integer `%` there cost the chunk kernel 26% of
// its time at Mistral-7B's operands (PERF.md, the ring rows).
struct RingCursor {
  size_t row0;    // first ring slot of (row, kv head)
  int ring;       // L
  float inv_ring; // 1 / L
  __device__ __forceinline__ int slot(int j) const {
    int r = j - __float2int_rz(__int2float_rn(j) * inv_ring) * ring;
    r += r < 0 ? ring : 0;
    r -= r >= ring ? ring : 0;
    return r;
  }
  template <int D>
  __device__ __forceinline__ size_t k(int j) const { return (row0 + (size_t)slot(j)) * D; }
  template <int D>
  __device__ __forceinline__ size_t v(int j) const { return k<D>(j); }
  template <int D>
  __device__ __forceinline__ size_t split(int j0) const { return k<D>(j0); }
};

struct RingLayout {
  int n_kv, ring, max_seq;  // max_seq: the logical bound of positions
  float inv_ring;           // 1 / ring, computed by the C entry points
  __device__ __forceinline__ int limit() const { return max_seq; }
  __device__ __forceinline__ RingCursor cursor(int row, int kvh) const {
    return {((size_t)row * n_kv + kvh) * (size_t)ring, ring, inv_ring};
  }
};

// One layer's page pool [n_pages + 1, n_kv, page_size, D] through a block
// table: slot j sits on physical page tables[row][j / page_size] at offset
// j % page_size. An unmapped entry (< 0) reads page 0, finite garbage that no
// live key uses (the TPU kernel's rule). Callers clamp every walk to
// limit() = n_p * page_size, so no table column past n_p is read. A page of
// a power-of-two size (128, 256, ...) splits a slot with a shift and a mask
// instead of a division (page_shift >= 0); other multiples of 128 divide.
struct PagedCursor {
  const int* table;
  int n_kv, kvh, page_size, page_shift;
  template <int D>
  __device__ __forceinline__ size_t k(int j) const {
    const int lp = page_shift >= 0 ? (j >> page_shift) : j / page_size;
    const int off = j - lp * page_size;
    const int page = max(__ldg(table + lp), 0);
    return (((size_t)page * n_kv + kvh) * (size_t)page_size + (size_t)off) * D;
  }
  template <int D>
  __device__ __forceinline__ size_t v(int j) const { return k<D>(j); }
  // One table lookup for the whole split that starts at j0.
  template <int D>
  __device__ __forceinline__ size_t split(int j0) const { return k<D>(j0); }
};

struct PagedLayout {
  const int* tables;
  long long table_stride;  // elements between table rows (sliced views)
  int n_p, n_kv, page_size;
  __device__ __forceinline__ int limit() const { return n_p * page_size; }
  __device__ __forceinline__ PagedCursor cursor(int row, int kvh) const {
    const int shift = (page_size & (page_size - 1)) == 0 ? __ffs(page_size) - 1 : -1;
    return {tables + (size_t)row * table_stride, n_kv, kvh, page_size, shift};
  }
};

}  // namespace cake
