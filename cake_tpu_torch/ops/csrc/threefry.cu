// Threefry-2x32 noise for the sampled decode step (ops/threefry.py).
//
// Replaces no Pallas kernel: the JAX package draws a step's gumbel noise with
// XLA (jax.random.gumbel over threefry keys, outside its kernels). Here one
// launch reads the key or keys from device memory (a captured CUDA graph
// replays it with the key the previous step wrote), splits them when asked,
// and writes the plane, the same bits as jax's partitionable layout:
//   element j of a row: (b1, b2) = threefry2x32(key, (j >> 32, j & 0xffffffff)),
//   bits = b1 ^ b2; u = max(tiny, f + tiny) with f = bitcast((bits >> 9) |
//   0x3f800000) - 1; gumbel = -log(-log(u)).
// One key for all (per_row 0: a single row of n elements, counted over the
// whole draw) or one key a row (per_row 1: rows of n, each counted from 0).
//
// Bound: the plane's bytes (4 a element) and ~80 32-bit integer operations an
// element. One thread an element; the block's draw key sits in shared memory,
// so an element costs one threefry. With a split, the first block of each
// row writes the next and sub keys to buffers of their own: no launch writes
// what it reads. logf is the precise one (no fast math), as torch's log.

#include <cuda_runtime.h>
#include <stdint.h>

namespace cake {

constexpr int kThreefryThreads = 256;
enum NoiseKind : int { kGumbel = 0, kUniform = 1, kBits = 2 };

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][r]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

template <int KIND>
__global__ void __launch_bounds__(kThreefryThreads)
threefry_noise_kernel(const long long* __restrict__ keys, long long* __restrict__ next,
                      long long* __restrict__ sub, void* __restrict__ out, long long n,
                      int per_row) {
  const int row = blockIdx.y;
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) {
    const long long* k = keys + (per_row ? 2 * row : 0);
    uint32_t k0 = (uint32_t)k[0], k1 = (uint32_t)k[1];
    if (sub != nullptr) {  // split: draw with the subkey, carry the next key
      const uint2 s = threefry2x32(k0, k1, 0u, 1u);
      if (blockIdx.x == 0) {
        const uint2 nx = threefry2x32(k0, k1, 0u, 0u);
        next[2 * row] = nx.x;
        next[2 * row + 1] = nx.y;
        sub[2 * row] = s.x;
        sub[2 * row + 1] = s.y;
      }
      k0 = s.x;
      k1 = s.y;
    }
    key[0] = k0;
    key[1] = k1;
  }
  __syncthreads();
  const long long j = (long long)blockIdx.x * kThreefryThreads + threadIdx.x;
  if (j >= n) return;
  const uint2 b = threefry2x32(key[0], key[1], (uint32_t)(j >> 32), (uint32_t)j);
  const uint32_t bits = b.x ^ b.y;
  const long long at = (long long)row * n + j;
  if constexpr (KIND == kBits) {
    static_cast<uint32_t*>(out)[at] = bits;
  } else {
    constexpr float tiny = 1.17549435e-38f;  // FLT_MIN, the smallest normal f32
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    // jax: max(tiny, f * (1 - tiny) + tiny), and 1 - tiny is 1 in f32.
    const float u = fmaxf(tiny, f + tiny);
    static_cast<float*>(out)[at] = KIND == kUniform ? u : -logf(-logf(u));
  }
}

}  // namespace cake

// keys: [2] (per_row 0, rows 1) or [rows, 2] int64 holding uint32 words.
// next/sub: [rows, 2] int64 outputs of the split, both NULL for a draw with
// the keys themselves. out: [rows, n] f32 (gumbel, uniform) or uint32 (bits).
extern "C" int cake_threefry_noise(const void* keys, void* next, void* sub, void* out, int rows,
                                   long long n, int per_row, int kind, void* stream) {
  using namespace cake;
  if (rows < 1) return (int)cudaSuccess;
  if (keys == nullptr || out == nullptr || n < 0 || (next == nullptr) != (sub == nullptr) ||
      (!per_row && rows != 1) || rows > 65535)
    return (int)cudaErrorInvalidValue;
  const long long blocks = n > 0 ? (n + kThreefryThreads - 1) / kThreefryThreads : 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(keys);
  long long* nx = static_cast<long long*>(next);
  long long* sb = static_cast<long long*>(sub);
  switch (kind) {
    case kGumbel:
      threefry_noise_kernel<kGumbel><<<grid, kThreefryThreads, 0, s>>>(k, nx, sb, out, n, per_row);
      break;
    case kUniform:
      threefry_noise_kernel<kUniform><<<grid, kThreefryThreads, 0, s>>>(k, nx, sb, out, n, per_row);
      break;
    case kBits:
      threefry_noise_kernel<kBits><<<grid, kThreefryThreads, 0, s>>>(k, nx, sb, out, n, per_row);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
