// Warp-level tensor-core helpers (mma.sync m16n8k16, ldmatrix) and the
// paired conversions that build their 16-bit operand registers.
#pragma once

#include "common.cuh"

namespace cake {

template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type make(float a, float b) { return __floats2bfloat162_rn(a, b); }
};
template <> struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ type make(float a, float b) { return __floats2half2_rn(a, b); }
};

// Two floats rounded to T (to nearest even) as one 32-bit operand register,
// a in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  typename Pair<T>::type h = Pair<T>::make(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Four 8x8 16-bit matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. .trans hands each thread a column pair instead
// of a row pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d (one m16n8 f32 tile) += a (m16k16, row-major) x b (k16n8, column-major).
template <typename T> __device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4],
                                                               uint32_t b0, uint32_t b1);
template <> __device__ __forceinline__ void mma16816<__nv_bfloat16>(float* d, const uint32_t (&a)[4],
                                                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <> __device__ __forceinline__ void mma16816<__half>(float* d, const uint32_t (&a)[4],
                                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace cake
