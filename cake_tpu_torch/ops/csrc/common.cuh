// Shared device helpers for the attention kernels: element conversions and
// vectorized loads/stores for the three activation dtypes the port takes and
// the f8 (e4m3) KV-cache dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cake {

// Matches the dtype codes the Python wrappers pass (ops/_build.py DTYPE_CODES).
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2, kF8 = 3 };

using f8 = __nv_fp8_e4m3;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
// Exact: every e4m3 value is an f16 value (cvt.rn.f16x2.e4m3x2 on sm_89+).
__device__ __forceinline__ float to_f(f8 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

// Four e4m3 bytes (the lowest first) widened to floats: two paired converts.
__device__ __forceinline__ void widen4(uint32_t raw, float* out) {
  const __half2 lo(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(raw & 0xffffu), __NV_E4M3));
  const __half2 hi(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(raw >> 16), __NV_E4M3));
  const float2 a = __half22float2(lo), b = __half22float2(hi);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// x narrowed to e4m3 as the JAX package's astype narrows it (ml_dtypes):
// round to nearest even, and NaN, with x's sign, for every magnitude that
// rounds past the largest finite value 448 (above 464, the tie 464 rounding
// to 448) and for NaN. Below 464 saturation never acts, so the hardware's
// saturating convert rounds as the reference does; torch's own cast
// saturates instead of giving NaN, hence ops/kv_dtype.narrow, the same rule.
__device__ __forceinline__ f8 narrow_f8(float x) {
  f8 r;
  r.__x = fabsf(x) <= 464.f ? __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3)
                            : (__nv_fp8_storage_t)(signbit(x) ? 0xFFu : 0x7Fu);
  return r;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ f8 from_f<f8>(float x) { return narrow_f8(x); }

// Round to T's precision and back: the reference casts the softmax numerator
// p to V's dtype before the p@v product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Load N consecutive elements of T into floats. The address must be aligned
// to min(N * sizeof(T), 16) bytes; the wrappers check base pointers and
// strides so that every load the kernels issue is.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (sizeof(T) == 1 && BYTES % 4 == 0) {  // e4m3: 4 bytes a convert pair
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
      for (int c = 0; c < BYTES / 16; ++c) {
        const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
        widen4(raw.x, out + 16 * c);
        widen4(raw.y, out + 16 * c + 4);
        widen4(raw.z, out + 16 * c + 8);
        widen4(raw.w, out + 16 * c + 12);
      }
    } else if constexpr (BYTES == 8) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      widen4(raw.x, out);
      widen4(raw.y, out + 4);
    } else {
      static_assert(BYTES == 4, "e4m3 vectors of 4, 8 or a multiple of 16 bytes");
      widen4(*reinterpret_cast<const uint32_t*>(p), out);
    }
  } else if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) out[c * PER + i] = to_f(e[i]);
    }
  } else if constexpr (BYTES == 8) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  } else if constexpr (BYTES == 4) {
    uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(p[i]);
  }
}

// Store N floats as consecutive elements of T (same alignment rule); to f8
// through narrow_f8.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&in)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) e[i] = from_f<T>(in[c * PER + i]);
      reinterpret_cast<uint4*>(p)[c] = raw;
    }
  } else if constexpr (sizeof(T) == 1 && BYTES == 8) {  // e4m3
    uint2 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f<T>(in[i]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else if constexpr (sizeof(T) == 1 && BYTES == 4) {
    uint32_t raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f<T>(in[i]);
    *reinterpret_cast<uint32_t*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f<T>(in[i]);
  }
}

// Copy 16 bytes (global -> shared tile rows); both addresses 16-byte aligned.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Asynchronous 16-byte copy global -> shared (sm_80+). With valid == false
// nothing is read and the 16 shared bytes are zero-filled; `src` must still
// be a mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `N` of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float softcap_score(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace cake
