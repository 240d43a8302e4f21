// RMSNorm folded into the projection it feeds: out = rms_norm(x, w_norm) @ W.
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/fused_norm_matmul.py
// (fused_norm_matmul). Two bodies, chosen by the wrapper
// (ops/fused_norm_matmul.py) through the `h` scratch it passes:
//
// - GEMV (h == NULL: decode rows, and every f32 call). Bound by the bytes
//   of W. One block per (row tile, column strip), the row tile fastest in
//   the grid so blocks sharing a strip run together; each block computes its
//   rows' inverse RMS in f32, stages the normalized rows (cast to T as
//   rms_norm casts) in shared memory as [K][RT], streams its strip with
//   16-byte loads, CG column groups wide and 256 / CG K-lanes deep, and
//   reduces the K-lanes through warp shuffles and shared memory. The strip is
//   as wide (CG = 16, 8 or 4) as still leaves two strips per SM: wider strips
//   read longer runs of each row of W.
// - Tensor cores (h != NULL: f16/bf16 past the decode rows, up to a
//   prefill chunk). A small kernel normalizes each row once, (x * inv) * w
//   in f32 cast to T where rms_norm casts, into the [rows, K] scratch `h`
//   (at most 2 MB at 256 rows of Llama-3-8B, held in the L2); the product
//   kernel runs wgmma over 128-row tiles (two warpgroups, one m64nBNk16
//   product each per 16-deep K step, f32 accumulation) from a ring of
//   cp.async stages of K 64 in shared memory, one step's products in
//   flight while the next stage lands. Normalizing in every block instead,
//   as each x tile lands, repeats the work once per column strip (224
//   times for w_gu) and costs a second barrier per K step: it measured
//   slower wherever the products, not the bytes of W, set the time. Blocks
//   of one column strip run side by side (row tile fastest) and share it
//   through the L2; 64-column strips where 128-column ones would leave SMs
//   idle. mma.sync tiles of 16 to 64 rows measured no faster, wqkv's
//   narrow output aside, so wgmma serves every row count past the GEMV's.
#include "common.cuh"
#include "wgmma.cuh"

namespace cake {

constexpr int NM_THREADS = 256;
constexpr int NM_WARPS = NM_THREADS / 32;
constexpr int NM_UNROLL = 8;                 // weight loads in flight per thread
constexpr size_t NM_SMEM_CAP = 100 * 1024;   // staged rows: two blocks per SM

template <typename T>
__device__ __forceinline__ uint4 ldg16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T, int V>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[V]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
}

// ------------------------------------------------------------------ GEMV

// CG: 16-byte column groups a strip (4, 8 or 16); 256 / CG K-lanes.
template <typename T, int RT, int CG>
__global__ void __launch_bounds__(NM_THREADS)
norm_matmul_kernel(const T* __restrict__ x, const T* __restrict__ nw, const T* __restrict__ w,
                   T* __restrict__ out, int rows, int K, int N, float eps, int offset) {
  constexpr int V = 16 / (int)sizeof(T);  // columns per 16-byte load
  constexpr int KL = NM_THREADS / CG;     // K-lanes per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);  // [K][RT] normalized rows
  __shared__ float inv_rms[RT];
  __shared__ float red[NM_WARPS][CG][RT * V];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * RT;
  const int n0 = blockIdx.y * (CG * V);

  // 1. Each row's inverse RMS, in f32 (one warp per row).
  for (int r = warp; r < RT; r += NM_WARPS) {
    float ss = 0.f;
    if (r0 + r < rows) {
      const T* xr = x + (size_t)(r0 + r) * K;
      for (int k = lane; k < K; k += 32) {
        const float v = to_f(xr[k]);
        ss += v * v;
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) inv_rms[r] = rsqrtf(ss / (float)K + eps);
  }
  __syncthreads();

  // 2. Normalized rows, cast to T where rms_norm casts: (x * inv) * w.
  for (int r = 0; r < RT; ++r) {
    const bool live = r0 + r < rows;
    const float inv = inv_rms[r];
    for (int k = tid; k < K; k += NM_THREADS) {
      float h = 0.f;
      if (live) {
        float wf = to_f(nw[k]);
        if (offset) wf = __fadd_rn(1.f, wf);
        h = __fmul_rn(__fmul_rn(to_f(x[(size_t)(r0 + r) * K + k]), inv), wf);
      }
      hs[(size_t)k * RT + r] = from_f<T>(h);
    }
  }
  __syncthreads();

  // 3. Stream the strip: K-lane kl reads rows kl, kl + KL, ... of columns
  // [col, col + V).
  const int c = tid % CG;
  const int kl = tid / CG;
  const int col = n0 + c * V;
  float acc[RT][V];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;

  if (col < N) {
    const T* wp = w + col;
    int k = kl;
    for (; k + (NM_UNROLL - 1) * KL < K; k += NM_UNROLL * KL) {
      uint4 raw[NM_UNROLL];
#pragma unroll
      for (int u = 0; u < NM_UNROLL; ++u) raw[u] = ldg16(wp + (size_t)(k + u * KL) * N);
#pragma unroll
      for (int u = 0; u < NM_UNROLL; ++u) {
        float wv[V], hv[RT];
        unpack16<T, V>(raw[u], wv);
        load_vec<T, RT>(hs + (size_t)(k + u * KL) * RT, hv);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int j = 0; j < V; ++j) acc[r][j] = fmaf(hv[r], wv[j], acc[r][j]);
      }
    }
    for (; k < K; k += KL) {
      float wv[V], hv[RT];
      unpack16<T, V>(ldg16(wp + (size_t)k * N), wv);
      load_vec<T, RT>(hs + (size_t)k * RT, hv);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r][j] = fmaf(hv[r], wv[j], acc[r][j]);
    }
  }

  // 4. Reduce over the K-lanes: the lanes of a warp that share a column
  // group (lane % CG) by shuffles, then the warps through shared memory.
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int o = CG; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < CG) red[warp][lane][r * V + j] = v;
    }
  __syncthreads();
  for (int i = tid; i < CG * RT * V; i += NM_THREADS) {
    const int cc = i / (RT * V), rem = i % (RT * V);
    const int r = rem / V, j = rem % V;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < NM_WARPS; ++wi) s += red[wi][cc][rem];
    const int row = r0 + r, cx = n0 + cc * V + j;
    if (row < rows && cx < N) out[(size_t)row * N + cx] = from_f<T>(s);
  }
}

template <typename T, int RT, int CG>
static cudaError_t launch_norm_matmul(const void* x, const void* nw, const void* w, void* out,
                                      int rows, int K, int N, float eps, int offset,
                                      cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  auto kernel = norm_matmul_kernel<T, RT, CG>;
  const size_t smem = (size_t)K * RT * sizeof(T);  // <= NM_SMEM_CAP (norm_matmul_by_rows)
  // The staged rows and the static reduction buffer together pass the 48 KB
  // a block gets without opting in (4 rows of 4096 beside 16 KB at CG = 16):
  // opt in to the cap, once per instantiation (the call costs host time).
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)NM_SMEM_CAP);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  const int strips = (N + CG * V - 1) / (CG * V);
  dim3 grid((rows + RT - 1) / RT, strips);
  kernel<<<grid, NM_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(nw), static_cast<const T*>(w),
      static_cast<T*>(out), rows, K, N, eps, offset);
  return cudaGetLastError();
}

static cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

// The widest strip (CG of 16, 8, 4 column groups) that still gives every SM
// two strips.
template <typename T, int RT>
static cudaError_t norm_matmul_by_width(const void* x, const void* nw, const void* w, void* out,
                                        int rows, int K, int N, float eps, int offset,
                                        cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (N >= 2 * sms * 16 * V)
    return launch_norm_matmul<T, RT, 16>(x, nw, w, out, rows, K, N, eps, offset, stream);
  if (N >= 2 * sms * 8 * V)
    return launch_norm_matmul<T, RT, 8>(x, nw, w, out, rows, K, N, eps, offset, stream);
  return launch_norm_matmul<T, RT, 4>(x, nw, w, out, rows, K, N, eps, offset, stream);
}

// Rows per block: the fewest of {1, 2, 4, 8} that cover `rows`, halved while
// the staged rows exceed the shared-memory cap.
template <typename T>
static cudaError_t norm_matmul_by_rows(const void* x, const void* nw, const void* w, void* out,
                                       int rows, int K, int N, float eps, int offset,
                                       cudaStream_t stream) {
  int rt = 1;
  while (rt < rows && rt < 8) rt *= 2;
  while (rt > 1 && (size_t)K * rt * sizeof(T) > NM_SMEM_CAP) rt /= 2;
  if ((size_t)K * rt * sizeof(T) > NM_SMEM_CAP) return cudaErrorInvalidValue;
  switch (rt) {
    case 1: return norm_matmul_by_width<T, 1>(x, nw, w, out, rows, K, N, eps, offset, stream);
    case 2: return norm_matmul_by_width<T, 2>(x, nw, w, out, rows, K, N, eps, offset, stream);
    case 4: return norm_matmul_by_width<T, 4>(x, nw, w, out, rows, K, N, eps, offset, stream);
    default: return norm_matmul_by_width<T, 8>(x, nw, w, out, rows, K, N, eps, offset, stream);
  }
}

// ---------------------------------------------------------- tensor cores

constexpr int TC_BK = 64;  // K per stage: four 16-deep products, one 128-byte row of h

// Each row normalized once into h, one warp a row: the inverse RMS in f32,
// then (x * inv) * w cast to T, as rms_norm computes it.
template <typename T>
__global__ void __launch_bounds__(NM_THREADS)
norm_rows_kernel(const T* __restrict__ x, const T* __restrict__ nw, T* __restrict__ h, int rows,
                 int K, float eps, int offset) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * NM_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const T* xr = x + (size_t)r * K;
  float ss = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load_vec<T, 8>(xr + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += v[j] * v[j];
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float iv = rsqrtf(ss / (float)K + eps);
  for (int k = lane * 8; k < K; k += 256) {
    float v[8], wv[8];
    load_vec<T, 8>(xr + k, v);
    load_vec<T, 8>(nw + k, wv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float wf = offset ? __fadd_rn(1.f, wv[j]) : wv[j];
      v[j] = __fmul_rn(__fmul_rn(v[j], iv), wf);
    }
    store_vec<T, 8>(h + (size_t)r * K + k, v);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  p[0] = from_f<T>(a);
  p[1] = from_f<T>(b);
}

// The product: 128-row tiles through Hopper's warpgroup products. Two
// warpgroups, 64 rows each, one m64nBNk16 wgmma per 16-deep K step from
// shared memory; the tiles land through a cp.async ring in the 128-byte
// swizzled layouts the descriptors name: h K-major (a 128-byte row per tile
// row), W MN-major (a 128-byte row of 64 columns per K row, one such column
// block per 64 columns of the strip).
constexpr int WG_BM = 128, WG_STAGES = 3;
constexpr int WG_A_BYTES = WG_BM * TC_BK * 2;   // 16 KB

// One m64nBNk16 product per warpgroup from shared memory: BN / 2 f32
// accumulators a thread.
template <int BN, typename T>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_k16<128, __nv_bfloat16>(float (&d)[64], uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"  // D += A B; B MN-major (transposed)
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_k16<128, __half>(float (&d)[64], uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"  // D += A B; B MN-major (transposed)
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_k16<64, __nv_bfloat16>(float (&d)[32], uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"  // D += A B; B MN-major (transposed)
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_k16<64, __half>(float (&d)[32], uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"  // D += A B; B MN-major (transposed)
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <typename T, int BN>
__global__ void __launch_bounds__(256, 2)
norm_matmul_wgmma_kernel(const T* __restrict__ h, const T* __restrict__ w, T* __restrict__ out,
                         int rows, int K, int N) {
  constexpr int B_BYTES = TC_BK * BN * 2;
  constexpr int STAGE = WG_A_BYTES + B_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte aligned stages: the swizzle pattern repeats every 8 rows of
  // 128 bytes from an aligned base.
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * BN;
  const int KT = (K + TC_BK - 1) / TC_BK;

  auto load_stage = [&](int s, int k0) {
    unsigned char* a = base + (size_t)s * STAGE;
    unsigned char* b = a + WG_A_BYTES;
    for (int i = tid; i < WG_BM * 8; i += 256) {  // row r, 16-byte chunk c of 8
      const int r = i >> 3, c = i & 7;
      const int row = m0 + r, k = k0 + c * 8;
      const bool ok = row < rows && k < K;
      cp_async16(a + r * 128 + ((c ^ (r & 7)) << 4), ok ? h + (size_t)row * K + k : h, ok);
    }
    for (int i = tid; i < TC_BK * (BN / 8); i += 256) {  // K row kr, 16-byte chunk c
      const int kr = i / (BN / 8), c = i % (BN / 8);
      const int k = k0 + kr, col = n0 + c * 8;
      const bool ok = k < K && col < N;
      cp_async16(b + (c >> 3) * (TC_BK * 128) + kr * 128 + (((c & 7) ^ (kr & 7)) << 4),
                 ok ? w + (size_t)k * N + col : w, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * TC_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % WG_STAGES;
    cp_async_wait<WG_STAGES - 2>();
    fence_proxy_async();  // cp.async -> wgmma
    __syncthreads();  // stage s landed for every thread

    // This warpgroup's 64 rows start 64 x 128 bytes into the h tile; each
    // 16-deep K step is 32 bytes along h's rows and 16 rows of W.
    const unsigned char* a = base + (size_t)s * STAGE + wg * 64 * 128;
    const unsigned char* b = base + (size_t)s * STAGE + WG_A_BYTES;
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
      wgmma_k16<BN, T>(acc, wg_desc(a + kk * 32, 16, 1024),
                       wg_desc(b + kk * 16 * 128, TC_BK * 128, 1024));
    wg_commit();
    // Keep this step's products in flight; the previous step's are done
    // (in every warpgroup, after the barrier), so its stage takes the next
    // load.
    wg_wait<1>();
    __syncthreads();
    const int nk = kt + WG_STAGES - 1;
    if (nk < KT) load_stage(nk % WG_STAGES, nk * TC_BK);
    cp_async_commit();
  }
  wg_wait<0>();
  wg_fence_acc(acc);
  cp_async_wait<0>();

  // The accumulators: warp (warp & 3) of the warpgroup owns 16 rows; for
  // the 8 columns of block j, registers 4j, 4j + 1 hold row lane / 4 and
  // 4j + 2, 4j + 3 row lane / 4 + 8, at columns 2 (lane % 4) and + 1.
  const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= N) continue;
    if (row < rows) store2<T>(out + (size_t)row * N + col, acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < rows)
      store2<T>(out + (size_t)(row + 8) * N + col, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <typename T, int BN>
static cudaError_t launch_wgmma(const void* h, const void* w, void* out, int rows, int K, int N,
                                cudaStream_t stream) {
  auto kernel = norm_matmul_wgmma_kernel<T, BN>;
  const size_t smem = (size_t)WG_STAGES * (WG_A_BYTES + TC_BK * BN * 2) + 1024;  // + alignment
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  dim3 grid((rows + WG_BM - 1) / WG_BM, (N + BN - 1) / BN);
  kernel<<<grid, 256, smem, stream>>>(static_cast<const T*>(h), static_cast<const T*>(w),
                                      static_cast<T*>(out), rows, K, N);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t norm_matmul_tc(const void* x, const void* nw, const void* w, void* h,
                                  void* out, int rows, int K, int N, float eps, int offset,
                                  cudaStream_t stream) {
  norm_rows_kernel<T><<<(rows + NM_WARPS - 1) / NM_WARPS, NM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(nw), static_cast<T*>(h), rows, K, eps,
      offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // 64-column strips where 128-column ones would leave SMs idle (wqkv).
  const int row_tiles = (rows + WG_BM - 1) / WG_BM;
  if ((long long)((N + 127) / 128) * row_tiles >= sms)
    return launch_wgmma<T, 128>(h, w, out, rows, K, N, stream);
  return launch_wgmma<T, 64>(h, w, out, rows, K, N, stream);
}

}  // namespace cake

// x: [rows, K]; nw: [K]; w: [K, N] row-major; out: [rows, N]; one dtype, all
// contiguous and 16-byte aligned, K and N multiples of 16 / sizeof(dtype).
// offset != 0: the norm weight applies as (1 + w). h: NULL for the GEMV,
// else a [rows, K] scratch of the dtype for the tensor-core path (f16/bf16
// only). Returns the launch's error.
extern "C" int cake_fused_norm_matmul(const void* x, const void* nw, const void* w, void* out,
                                      void* h, int rows, int K, int N, int dtype, float eps,
                                      int offset, void* stream) {
  using namespace cake;
  if (rows < 1) return (int)cudaSuccess;
  if (K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (h) return (int)cudaErrorInvalidValue;
      return (int)norm_matmul_by_rows<float>(x, nw, w, out, rows, K, N, eps, offset, s);
    case kF16:
      if (h) return (int)norm_matmul_tc<__half>(x, nw, w, h, out, rows, K, N, eps, offset, s);
      return (int)norm_matmul_by_rows<__half>(x, nw, w, out, rows, K, N, eps, offset, s);
    case kBF16:
      if (h)
        return (int)norm_matmul_tc<__nv_bfloat16>(x, nw, w, h, out, rows, K, N, eps, offset, s);
      return (int)norm_matmul_by_rows<__nv_bfloat16>(x, nw, w, out, rows, K, N, eps, offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
