// Grouped expert GEMM for the MoE grouped dispatch (ops/moe.py).
//
// Replaces no Pallas kernel: the JAX package's grouped dispatch multiplies
// each expert's row group with ``jax.lax.ragged_dot`` (XLA). Here one launch
// covers every expert of one product (gate, up or down):
//
//   out[r, :] = x[r, :] @ w[e(r)]         for every row r of expert e's group,
//
// the rows sorted by expert, the groups delimited by ``offsets`` [E + 1]
// (int32, read from device memory). The weights are the expert stack [E, K,
// N] in x's dtype, or int8 (``--quantize int8|int4`` keeps experts int8),
// widened in the kernel; the per-expert scale stays the caller's, applied
// after the product (ops/moe.py ``_ragged``). The output is x's dtype.
//
// Rows are independent of their neighbours: a block owns a fixed tile of
// BM rows of one expert's group and BN output columns, and every output
// element is one row times one column, accumulated in f32 over K in one
// fixed order (BK-wide tiles, k16 mma steps in order). So an output row's
// bits depend only on that row and its expert's weights, never on how many
// rows the expert got (cuBLAS picks its kernel by the row count, which is
// why a loop of per-expert cuBLAS products gave the warm prefix wave other
// bits than the cold one).
//
// Grid: x = N / BN column tiles, y = an upper bound on the row tiles,
// ceil(M / BM) + E (each group wastes at most one partial tile); a block
// finds its (expert, tile) by walking the offsets and exits past the last
// one. f16/bf16 take mma.sync m16n8k16 (8 warps, 32 x 32 each; A and B
// staged in shared memory, two buffers, the next tile loaded into registers
// while the current one computes); f32 takes a CUDA-core loop, one output a
// thread, k in order.

#include "mma.cuh"

namespace cake {
namespace moegrp {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDA = BK + 8;   // padded rows: ldmatrix without bank conflicts
constexpr int LDB = BN + 8;
constexpr int kThreads = 256;

// The (expert, first row, row end) of row tile `t`, or e = -1 past the last.
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets, int E, int t, int& e,
                                          int& r0, int& r1) {
  e = -1;
  for (int i = 0; i < E; ++i) {
    const int lo = offsets[i], hi = offsets[i + 1];
    const int tiles = (hi - lo + BM - 1) / BM;
    if (t < tiles) {
      e = i;
      r0 = lo + t * BM;
      r1 = hi;
      return;
    }
    t -= tiles;
  }
}

// 16 weights of one smem row segment from global: 8 16-bit values a uint4,
// or 16 int8 values widened to T (exact: every int8 is a T value).
template <typename T, typename W> struct BLoad;
template <typename T> struct BLoad<T, T> {
  // 32 x 128 16-bit weights a tile: two uint4 a thread.
  static constexpr int kVecs = 2;
  uint4 v[2];
  __device__ __forceinline__ void load(const T* __restrict__ w, int K, int N, int k0, int n0,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;  // 512 vectors: 32 rows x 16
      const int kr = idx >> 4, c = (idx & 15) * 8;
      const int n = n0 + c;
      if (n < N)
        v[i] = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kr) * N + n);
      else
        v[i] = make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store(T* sB, int tid) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int kr = idx >> 4, c = (idx & 15) * 8;
      *reinterpret_cast<uint4*>(sB + kr * LDB + c) = v[i];
    }
  }
};
template <typename T> struct BLoad<T, int8_t> {
  // 32 x 128 int8 weights a tile: one uint4 (16 weights) a thread.
  uint4 v;
  __device__ __forceinline__ void load(const int8_t* __restrict__ w, int K, int N, int k0, int n0,
                                       int tid) {
    const int kr = tid >> 3, c = (tid & 7) * 16;
    const int n = n0 + c;
    if (n < N)
      v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kr) * N + n);
    else
      v = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void store(T* sB, int tid) const {
    const int kr = tid >> 3, c = (tid & 7) * 16;
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    uint32_t packed[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) packed[j] = pack2<T>((float)b[2 * j], (float)b[2 * j + 1]);
    uint4* dst = reinterpret_cast<uint4*>(sB + kr * LDB + c);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
};

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
grouped_tc_kernel(const T* __restrict__ x, const W* __restrict__ w,
                  const int* __restrict__ offsets, T* __restrict__ out, int K, int N, int E) {
  __shared__ __align__(16) T sA[2][BM * LDA];
  __shared__ __align__(16) T sB[2][BK * LDB];
  int e, r0, r1;
  find_tile(offsets, E, blockIdx.y, e, r0, r1);
  if (e < 0) return;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const W* we = w + (size_t)e * K * N;

  // A: 64 rows x 32 columns, one uint4 (8 values) a thread; rows past the
  // group's end load zeros (their outputs are never stored).
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  const bool a_live = r0 + ar < r1;
  const T* xa = x + (size_t)(r0 + ar) * K + ac;
  uint4 va;
  BLoad<T, W> vb;
  auto load = [&](int k0) {
    va = a_live ? *reinterpret_cast<const uint4*>(xa + k0) : make_uint4(0, 0, 0, 0);
    vb.load(we, K, N, k0, n0, tid);
  };
  auto store = [&](int buf) {
    *reinterpret_cast<uint4*>(&sA[buf][ar * LDA + ac]) = va;
    vb.store(sB[buf], tid);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int nk = K / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], &sA[cur][(wm * 32 + i * 16 + (lane & 15)) * LDA + kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int jb = 0; jb < 2; ++jb) {
        uint32_t b[4];
        const int mi = lane >> 3;
        ldsm_x4_trans(b, &sB[cur][(kk * 16 + (mi & 1) * 8 + (lane & 7)) * LDB + wn * 32 + jb * 16 +
                                  (mi >> 1) * 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816<T>(acc[i][2 * jb], a[i], b[0], b[1]);
          mma16816<T>(acc[i][2 * jb + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // C fragment: (row g, cols 2t, 2t+1) and (row g + 8, the same cols).
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + t4 * 2;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm * 32 + i * 16 + g + h * 8;
        if (r < r1) {
          T* o = out + (size_t)r * N + n;
          *reinterpret_cast<uint32_t*>(o) = pack2<T>(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

// f32: one output element a thread, K in order (fmaf), BM rows a block.
template <typename W>
__global__ void __launch_bounds__(BN)
grouped_f32_kernel(const float* __restrict__ x, const W* __restrict__ w,
                   const int* __restrict__ offsets, float* __restrict__ out, int K, int N, int E) {
  int e, r0, r1;
  find_tile(offsets, E, blockIdx.y, e, r0, r1);
  if (e < 0) return;
  const int n = blockIdx.x * BN + threadIdx.x;
  if (n >= N) return;
  const W* we = w + (size_t)e * K * N + n;
  const int rend = min(r1, r0 + BM);
  for (int r = r0; r < rend; ++r) {
    const float* xr = x + (size_t)r * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(xr[k], (float)we[(size_t)k * N], acc);
    out[(size_t)r * N + n] = acc;
  }
}

template <typename T, typename W>
cudaError_t launch_tc(const void* x, const void* w, const int* off, void* out, int K, int N, int E,
                      int tiles, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, tiles);
  grouped_tc_kernel<T, W><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                                     static_cast<const W*>(w), off,
                                                     static_cast<T*>(out), K, N, E);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_f32(const void* x, const void* w, const int* off, void* out, int K, int N, int E,
                       int tiles, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, tiles);
  grouped_f32_kernel<W><<<grid, BN, 0, s>>>(static_cast<const float*>(x),
                                            static_cast<const W*>(w), off,
                                            static_cast<float*>(out), K, N, E);
  return cudaGetLastError();
}

}  // namespace moegrp
}  // namespace cake

// x [M, K] (rows sorted by expert), w [E, K, N] (x's dtype, or int8 when
// quant), offsets [E + 1] int32 on the device, out [M, N] in x's dtype.
// tiles: the grid's row tiles, at least the groups' ceil(rows / 64) summed.
extern "C" int cake_moe_grouped(const void* x, const void* w, const void* offsets, void* out,
                                int M, int K, int N, int E, int dtype, int quant, int tiles,
                                void* stream) {
  using namespace cake;
  using namespace cake::moegrp;
  if (M < 1 || tiles < 1) return (int)cudaSuccess;
  if (E < 1 || K < BK || K % BK || N < 8 || N % (quant ? 16 : 8) || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  switch (dtype) {
    case kF32:
      return quant ? (int)launch_f32<int8_t>(x, w, off, out, K, N, E, tiles, s)
                   : (int)launch_f32<float>(x, w, off, out, K, N, E, tiles, s);
    case kF16:
      return quant ? (int)launch_tc<__half, int8_t>(x, w, off, out, K, N, E, tiles, s)
                   : (int)launch_tc<__half, __half>(x, w, off, out, K, N, E, tiles, s);
    case kBF16:
      return quant ? (int)launch_tc<__nv_bfloat16, int8_t>(x, w, off, out, K, N, E, tiles, s)
                   : (int)launch_tc<__nv_bfloat16, __nv_bfloat16>(x, w, off, out, K, N, E, tiles,
                                                                   s);
    default: return (int)cudaErrorInvalidValue;
  }
}
