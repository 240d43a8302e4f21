// Fused decode ingest: head split + RoPE on q/k + the one-slot K/V write.
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/fused_ingest.py
// (fused_qkv_ingest). At Llama-3-8B a row is ~24 KB of loads and stores, so
// on the H100 the kernel is bound by the latency of its memory round trip,
// not by bytes or by its launch alone. Design (see ops/fused_ingest.py
// plan()): one thread owns one vector of a q or k head's first half and the
// matching vector of its second half, with their cos/sin, or one vector of
// a v head; every load it makes is issued before its first store, so a
// thread makes one trip to memory. The grid (blocks, rows) and the threads'
// (head, vector) split come from the shapes; the body maps threads by
// shifts. The write slot is read from device memory, as the TPU kernel
// reads it from a scalar-prefetch ref, so a captured CUDA graph replays with
// the slot its buffer holds at each replay. Every rope product and sum is
// rounded on its own, as the plain path's separate ops round them, so q and
// the written K/V are its bits. A cache of another dtype KT (e4m3, or f32
// under 16-bit activations) stores k rounded first to T, as the plain path's
// rope returns it, then to KT, and v from T: narrow_f8 for e4m3, round to
// nearest even with NaN past +-464 as the reference's astype. The vectors
// stay plan()'s (by T): a thread's k pair writes 8 bytes of e4m3 where it
// wrote 16 of bf16.
#include "common.cuh"

#include <type_traits>

namespace cake {

// Raw copy of N elements of T (N * sizeof(T) a power of two <= 16 bytes,
// both addresses aligned to it).
template <typename T, int N>
struct alignas(N * sizeof(T)) Pack {
  T e[N];
};

// rope_shift / v_shift: log2 of the threads a q/k head / a v head takes
// (each a power of two at least its vector count). `slot` points at the
// shared write slot (an int64 in device memory). Dense: the slot indexes
// the cache's sequence axis. Paged: its page is slot / seq_stride (the page
// size) and its offset in the page slot % seq_stride.
template <typename T, typename KT, int VR, int VV>
__global__ void ingest_kernel(const T* __restrict__ qkv, const float* __restrict__ cos_rows,
                              const float* __restrict__ sin_rows, T* __restrict__ q_out,
                              KT* __restrict__ k_cache, KT* __restrict__ v_cache,
                              const int* __restrict__ tables, const long long* __restrict__ slot,
                              int n_q, int n_kv, int hd, int rope_shift, int v_shift,
                              int seq_stride, int n_p, long long table_stride) {
  const int row = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int half = hd >> 1;
  const int n_rope = (n_q + n_kv) << rope_shift;
  const bool rope = t < n_rope;
  const int u = rope ? t : t - n_rope;
  const int shift = rope ? rope_shift : v_shift;
  const int head = u >> shift, j = u & ((1 << shift) - 1);
  if (rope ? j * VR >= half : (head >= n_kv || j * VV >= hd)) return;

  // The slot, the rope rows and the row's qkv vectors, then the table
  // entry (it depends on the slot): every load is issued before the first
  // store.
  const long long at = *slot;
  const T* x = qkv + (size_t)row * (n_q + 2 * n_kv) * hd;
  float c[VR], s[VR], x1[VR], x2[VR];
  Pack<T, VV> v;
  if (rope) {
    load_vec<float, VR>(cos_rows + (size_t)row * half + j * VR, c);
    load_vec<float, VR>(sin_rows + (size_t)row * half + j * VR, s);
    load_vec<T, VR>(x + head * hd + j * VR, x1);
    load_vec<T, VR>(x + head * hd + half + j * VR, x2);
  } else {
    v = *reinterpret_cast<const Pack<T, VV>*>(x + (n_q + n_kv + head) * hd + j * VV);
  }
  // Element offset of [.., head 0, slot, 0] in the cache, or -1: dropped
  // (a negative slot; dense: a slot past the cache; paged: an unmapped
  // entry or a page past the table, the logical page clamped into the
  // table before the lookup). Dense: [b, n_kv, max_seq, hd]. Paged: the
  // pool [P, n_kv, page, hd]. q threads write no cache.
  long long base = -1;
  const bool writes = !rope || head >= n_q;
  if (writes && tables == nullptr) {
    if (at >= 0 && at < seq_stride) base = ((long long)row * n_kv * seq_stride + at) * hd;
  } else if (writes && at >= 0) {
    const long long logical = at / seq_stride;
    const int phys = tables[(long long)row * table_stride + min(logical, (long long)n_p - 1)];
    if (logical < n_p && phys >= 0)
      base = ((long long)phys * n_kv * seq_stride + at % seq_stride) * hd;
  }
  const long long head_stride = (long long)seq_stride * hd;
  if (rope) {
    // q and k heads: rotate-half in f32, every product and sum rounded alone.
    float o1[VR], o2[VR];
#pragma unroll
    for (int i = 0; i < VR; ++i) {
      o1[i] = __fsub_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], s[i]));
      o2[i] = __fadd_rn(__fmul_rn(x2[i], c[i]), __fmul_rn(x1[i], s[i]));
    }
    if (head < n_q) {
      T* dst = q_out + ((size_t)row * n_q + head) * hd;
      store_vec<T, VR>(dst + j * VR, o1);
      store_vec<T, VR>(dst + half + j * VR, o2);
    } else {
      if (base < 0) return;
      KT* dst = k_cache + base + (head - n_q) * head_stride;
      if constexpr (!std::is_same_v<KT, T>) {  // k as the plain rope returns it, in T
#pragma unroll
        for (int i = 0; i < VR; ++i) {
          o1[i] = round_to<T>(o1[i]);
          o2[i] = round_to<T>(o2[i]);
        }
      }
      store_vec<KT, VR>(dst + j * VR, o1);
      store_vec<KT, VR>(dst + half + j * VR, o2);
    }
  } else {
    // v heads: copied into the slot (narrowed or widened to KT).
    if (base < 0) return;
    KT* dst = v_cache + base + head * head_stride + j * VV;
    if constexpr (std::is_same_v<KT, T>) {
      *reinterpret_cast<Pack<T, VV>*>(dst) = v;
    } else {
      float w[VV];
#pragma unroll
      for (int i = 0; i < VV; ++i) w[i] = to_f(v.e[i]);
      store_vec<KT, VV>(dst, w);
    }
  }
}

template <typename T, typename KT, int VR, int VV>
static cudaError_t launch_ingest(const void* qkv, const void* cos_rows, const void* sin_rows,
                                 void* q_out, void* k_cache, void* v_cache, const void* tables,
                                 const void* slot, int b, int n_q, int n_kv, int hd,
                                 int rope_shift, int v_shift, int seq_stride, int n_p,
                                 long long table_stride, int blocks, int threads,
                                 cudaStream_t stream) {
  ingest_kernel<T, KT, VR, VV><<<dim3(blocks, b), threads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cos_rows),
      static_cast<const float*>(sin_rows), static_cast<T*>(q_out), static_cast<KT*>(k_cache),
      static_cast<KT*>(v_cache), static_cast<const int*>(tables),
      static_cast<const long long*>(slot), n_q, n_kv, hd, rope_shift, v_shift, seq_stride, n_p,
      table_stride);
  return cudaGetLastError();
}

// The instantiation for the plan's vector counts (powers of two, at most
// 16 bytes of T each).
template <typename T, typename KT>
static cudaError_t ingest_by_vectors(int vr, int vv, const void* qkv, const void* cs,
                                     const void* sn, void* q, void* kc, void* vc,
                                     const void* tb, const void* sl, int b, int n_q, int n_kv,
                                     int hd, int rs, int vs, int seq, int n_p, long long ts,
                                     int blocks, int threads, cudaStream_t st) {
  constexpr int MAXV = 16 / (int)sizeof(T);
#define CAKE_INGEST(R, V)                                                                      \
  if (vr == R && vv == V)                                                                      \
    return launch_ingest<T, KT, R, V>(qkv, cs, sn, q, kc, vc, tb, sl, b, n_q, n_kv, hd, rs, vs, \
                                      seq, n_p, ts, blocks, threads, st);
#define CAKE_INGEST_V(R) CAKE_INGEST(R, 1) CAKE_INGEST(R, 2) CAKE_INGEST(R, 4)
  CAKE_INGEST_V(1)
  CAKE_INGEST_V(2)
  CAKE_INGEST_V(4)
  if constexpr (MAXV == 8) {
    CAKE_INGEST(1, 8)
    CAKE_INGEST(2, 8)
    CAKE_INGEST(4, 8)
    CAKE_INGEST(8, 8)
  }
#undef CAKE_INGEST_V
#undef CAKE_INGEST
  return cudaErrorInvalidValue;
}

// The cache's element type: the activations' (T), e4m3, or f32 (wider than
// a 16-bit T).
template <typename T, typename... Args>
static cudaError_t ingest_by_kv(int kv_dtype, Args... args) {
  if (kv_dtype == kF8) return ingest_by_vectors<T, f8>(args...);
  if constexpr (!std::is_same_v<T, float>) {
    if (kv_dtype == kF32) return ingest_by_vectors<T, float>(args...);
  }
  return ingest_by_vectors<T, T>(args...);
}

}  // namespace cake

// qkv: [b, (n_q + 2 n_kv) hd]; cos_rows/sin_rows: [b, hd/2] f32; q_out:
// [b, n_q, hd]; slot: one int64 in device memory, the shared write slot.
// tables == NULL: dense cache [b, n_kv, seq_stride, hd], the write at the
// slot. Otherwise tables [b, n_p] int32 (row stride table_stride) and the
// pool [P, n_kv, seq_stride = page size, hd]. All contiguous; qkv and q of
// dtype, the cache of kv_dtype (dtype, kF8, or kF32 under a 16-bit dtype);
// every base 16-byte aligned. The geometry is
// ops/fused_ingest.plan()'s: `blocks` x `threads` a row, vectors of `vr`
// (q/k) and `vv` (v) elements, 2^rope_shift threads a q/k head and
// 2^v_shift a v head. Returns the launch's error.
extern "C" int cake_fused_qkv_ingest(const void* qkv, const void* cos_rows, const void* sin_rows,
                                     void* q_out, void* k_cache, void* v_cache,
                                     const void* tables, const void* slot, int b, int n_q,
                                     int n_kv, int hd, int seq_stride, int n_p,
                                     long long table_stride, int blocks, int threads, int vr,
                                     int vv, int rope_shift, int v_shift, int dtype,
                                     int kv_dtype, void* stream) {
  using namespace cake;
  if (b < 1) return (int)cudaSuccess;
  if (hd < 2 || hd % 2 || seq_stride < 1 || slot == nullptr || (tables != nullptr && n_p < 1) ||
      blocks < 1 || threads < 1 || threads > 1024 || (hd / 2) % vr || hd % vv ||
      (1 << rope_shift) * vr < hd / 2 || (1 << v_shift) * vv < hd ||
      (long long)blocks * threads < ((long long)(n_q + n_kv) << rope_shift) + (n_kv << v_shift) ||
      !(kv_dtype == dtype || kv_dtype == kF8 || (kv_dtype == kF32 && dtype != kF32)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CAKE_INGEST_ARGS                                                                    \
  vr, vv, qkv, cos_rows, sin_rows, q_out, k_cache, v_cache, tables, slot, b, n_q, n_kv, hd, \
      rope_shift, v_shift, seq_stride, n_p, table_stride, blocks, threads, s
  switch (dtype) {
    case kF32: return (int)ingest_by_kv<float>(kv_dtype, CAKE_INGEST_ARGS);
    case kF16: return (int)ingest_by_kv<__half>(kv_dtype, CAKE_INGEST_ARGS);
    case kBF16: return (int)ingest_by_kv<__nv_bfloat16>(kv_dtype, CAKE_INGEST_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CAKE_INGEST_ARGS
}
