// Fused decode ingest: head split + RoPE on q/k + the one-slot K/V write.
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/fused_ingest.py
// (fused_qkv_ingest). Bound on the H100: its launch (~24 KB a row at
// Llama-3-8B). One block per row; every rope product and sum is rounded on
// its own, as the plain path's separate ops round them, so q and the
// written K/V are its bits (see ops/fused_ingest.py).
#include "common.cuh"

namespace cake {

constexpr int IN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(IN_THREADS)
ingest_kernel(const T* __restrict__ qkv, const float* __restrict__ cos_rows,
              const float* __restrict__ sin_rows, T* __restrict__ q_out, T* __restrict__ k_cache,
              T* __restrict__ v_cache, const int* __restrict__ tables, int n_q, int n_kv, int hd,
              int slot, int seq_stride, int n_p, long long table_stride) {
  const int b = blockIdx.x;
  const int half = hd / 2;
  const T* row = qkv + (size_t)b * (n_q + 2 * n_kv) * hd;
  const float* cb = cos_rows + (size_t)b * half;
  const float* sb = sin_rows + (size_t)b * half;

  // Element offset of [.., head 0, slot, 0] in the cache, or -1: dropped.
  // Dense: [b, n_kv, max_seq, hd]. Paged: the pool [P, n_kv, page, hd]
  // through the table, the logical page clamped before the lookup.
  long long base = -1;
  if (tables == nullptr) {
    base = ((long long)b * n_kv * seq_stride + slot) * hd;
  } else {
    const int logical = slot / seq_stride;
    const int off = slot % seq_stride;
    const int phys = tables[(long long)b * table_stride + min(logical, n_p - 1)];
    if (logical < n_p && phys >= 0) base = ((long long)phys * n_kv * seq_stride + off) * hd;
  }
  const long long head_stride = (long long)seq_stride * hd;

  // q and k heads: rotate-half in f32, every product and sum rounded alone.
  for (int i = threadIdx.x; i < (n_q + n_kv) * half; i += IN_THREADS) {
    const int h = i / half, j = i % half;
    const float c = cb[j], s = sb[j];
    const float x1 = to_f(row[h * hd + j]);
    const float x2 = to_f(row[h * hd + j + half]);
    const float o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
    const float o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
    if (h < n_q) {
      T* qh = q_out + ((size_t)b * n_q + h) * hd;
      qh[j] = from_f<T>(o1);
      qh[j + half] = from_f<T>(o2);
    } else if (base >= 0) {
      T* kh = k_cache + base + (h - n_q) * head_stride;
      kh[j] = from_f<T>(o1);
      kh[j + half] = from_f<T>(o2);
    }
  }
  // v heads: copied into the slot.
  if (base >= 0) {
    const T* vr = row + (n_q + n_kv) * hd;
    for (int i = threadIdx.x; i < n_kv * hd; i += IN_THREADS) {
      v_cache[base + (i / hd) * head_stride + (i % hd)] = vr[i];
    }
  }
}

template <typename T>
static cudaError_t launch_ingest(const void* qkv, const void* cos_rows, const void* sin_rows,
                                 void* q_out, void* k_cache, void* v_cache, const void* tables,
                                 int b, int n_q, int n_kv, int hd, int slot, int seq_stride,
                                 int n_p, long long table_stride, cudaStream_t stream) {
  ingest_kernel<T><<<b, IN_THREADS, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cos_rows),
      static_cast<const float*>(sin_rows), static_cast<T*>(q_out), static_cast<T*>(k_cache),
      static_cast<T*>(v_cache), static_cast<const int*>(tables), n_q, n_kv, hd, slot, seq_stride,
      n_p, table_stride);
  return cudaGetLastError();
}

}  // namespace cake

// qkv: [b, (n_q + 2 n_kv) hd]; cos_rows/sin_rows: [b, hd/2] f32; q_out:
// [b, n_q, hd]. tables == NULL: dense cache [b, n_kv, seq_stride, hd], the
// write at slot. Otherwise tables [b, n_p] int32 (row stride table_stride)
// and the pool [P, n_kv, seq_stride = page size, hd]. All contiguous, one
// dtype for qkv, q and the cache. Returns the launch's error.
extern "C" int cake_fused_qkv_ingest(const void* qkv, const void* cos_rows, const void* sin_rows,
                                     void* q_out, void* k_cache, void* v_cache,
                                     const void* tables, int b, int n_q, int n_kv, int hd,
                                     int slot, int seq_stride, int n_p, long long table_stride,
                                     int dtype, void* stream) {
  using namespace cake;
  if (b < 1) return (int)cudaSuccess;
  if (hd < 2 || hd % 2 || seq_stride < 1 || slot < 0 || (tables != nullptr && n_p < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)launch_ingest<float>(qkv, cos_rows, sin_rows, q_out, k_cache, v_cache, tables,
                                       b, n_q, n_kv, hd, slot, seq_stride, n_p, table_stride, s);
    case kF16:
      return (int)launch_ingest<__half>(qkv, cos_rows, sin_rows, q_out, k_cache, v_cache, tables,
                                        b, n_q, n_kv, hd, slot, seq_stride, n_p, table_stride, s);
    case kBF16:
      return (int)launch_ingest<__nv_bfloat16>(qkv, cos_rows, sin_rows, q_out, k_cache, v_cache,
                                               tables, b, n_q, n_kv, hd, slot, seq_stride, n_p,
                                               table_stride, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
