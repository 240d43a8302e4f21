// RMSNorm folded into the projection it feeds: out = rms_norm(x, w_norm) @ W.
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/fused_norm_matmul.py
// (fused_norm_matmul). Three bodies; the wrapper's plan()
// (ops/fused_norm_matmul.py) picks one from the shapes alone and passes its
// geometry (row or column tile, K split, ring depth), which the entry point
// takes as given:
//
// - GEMV (f32). One block per (row tile, column strip), the row tile
//   fastest in the grid so blocks sharing a strip run together; each block
//   computes its rows' inverse RMS in f32, stages the normalized rows in
//   shared memory as [K][RT], streams its strip with 16-byte loads, CG
//   column groups wide and 256 / CG K-lanes deep, and reduces the K-lanes
//   through warp shuffles and shared memory. The strip is as wide (CG = 16,
//   8 or 4) as still leaves two strips per SM.
// - Swap AB (decode rows, 1 to 64, f16/bf16). Bound by the bytes of W, so
//   the design keeps W in flight: out^T = W^T h^T, W's output columns as
//   wgmma's M (A read MN-major from shared memory, W as stored) and the
//   rows, padded to RP = 8, 16, 32 or 64, as its N (the K-major B operand).
//   A block covers 128 columns (two product warpgroups of 64) over one split
//   of K; one producer warp keeps a ring of TMA stages (64 k x 128 columns
//   of W and the step's RP rows) in flight behind full and empty mbarriers,
//   with no block-wide barrier in the loop; blocks are small enough that
//   several share an SM. Where the column strips leave SMs idle (wqkv) K is
//   split, by (K, N) alone: each split writes f32 partials, and the block
//   that finishes a strip last (an atomic ticket after a fence) adds them
//   in split order, p0 + p1 + ..., and resets its ticket.
// - Warp-specialized (prefill rows, 65 to 256, f16/bf16). Bound by the
//   products. One persistent block per SM walks 128-row x BN-column output
//   tiles (BN 256, or 128 where those would leave SMs idle; widths between
//   that are not multiples of 64 measured slower: PERF.md), both row tiles
//   of a column strip on neighbouring blocks so W comes from device memory
//   once. A producer warpgroup (its registers handed to the others by
//   setmaxnreg) keeps TMA loads of the rows' tile and the W tile in a ring
//   behind full and empty mbarriers; two consumer warpgroups run m64nBNk16
//   wgmma, one step's products in flight while the next waits for its
//   stage, and each tile's stores overlap the loads of the next. A pair of
//   blocks in a cluster sharing W by TMA multicast measured no faster
//   (PERF.md).
//
// Both tensor-core bodies take their rows from `h`, which a small kernel
// (norm_rows_kernel) writes first, each row normalized once in one fixed
// order of its sum of squares and cast to T where rms_norm casts; the
// product kernel is its programmatic dependent, so W streams while the rows
// are normalized. A row's sum runs over the same K steps in the same order
// whatever rows share the call, so a body gives a row the same bits alone
// and among others. The sums run in another order than cuBLAS's: the plain
// version holds the kernel within a tolerance, never bitwise.
#include "common.cuh"
#include "mma.cuh"
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

// ------------------------------------------------------------ the norm

constexpr int NORM_THREADS = 256;  // threads a row's norm spreads over
constexpr int NORM_BATCH = 8;      // 16-byte loads a thread keeps in flight

// 8 consecutive normalized elements, (x * inv) * w in f32 rounded to T
// where rms_norm rounds, as 16 bytes.
template <typename T>
__device__ __forceinline__ uint4 norm8(const T* __restrict__ xk, const T* __restrict__ nwk,
                                       float inv, int offset) {
  float v[8], wv[8];
  load_vec<T, 8>(xk, v);
  load_vec<T, 8>(nwk, wv);
  uint4 r;
  uint32_t* p = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float w0 = offset ? __fadd_rn(1.f, wv[2 * j]) : wv[2 * j];
    const float w1 = offset ? __fadd_rn(1.f, wv[2 * j + 1]) : wv[2 * j + 1];
    p[j] = pack2<T>(__fmul_rn(__fmul_rn(v[2 * j], inv), w0),
                    __fmul_rn(__fmul_rn(v[2 * j + 1], inv), w1));
  }
  return r;
}

// Each row normalized once into h [rows, K], a block a row: thread t sums
// the squares of the 8-element chunks t, t + NORM_THREADS, ... in order
// (NORM_BATCH loads in flight), a butterfly sums each warp, the warps' sums
// add in warp order, and the inverse RMS in f32 scales the row. It lets the
// product kernel launched after it start at once (a programmatic dependent
// launch): W streams while the rows are normalized.
template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
norm_rows_kernel(const T* __restrict__ x, const T* __restrict__ nw, T* __restrict__ h, int K,
                 float eps, int offset) {
  __shared__ float wss[NORM_THREADS / 32];
  __shared__ float inv;
  griddep_launch_dependents();
  const int t = threadIdx.x;
  const T* xr = x + (size_t)blockIdx.x * K;
  T* hr = h + (size_t)blockIdx.x * K;
  for (int k = t * 8; k < K; k += NORM_THREADS * 8)  // the norm weight on its way meanwhile
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(nw + k));
  float ss = 0.f;
  for (int k0 = t * 8; k0 < K; k0 += NORM_THREADS * 8 * NORM_BATCH) {
    float v[NORM_BATCH][8];
#pragma unroll
    for (int u = 0; u < NORM_BATCH; ++u) {
      const int k = k0 + NORM_THREADS * 8 * u;
      if (k < K) {
        load_vec<T, 8>(xr + k, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < NORM_BATCH; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j) ss = fmaf(v[u][j], v[u][j], ss);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((t & 31) == 0) wss[t >> 5] = ss;
  __syncthreads();
  if (t == 0) {
    float sum = wss[0];
#pragma unroll
    for (int w = 1; w < NORM_THREADS / 32; ++w) sum += wss[w];
    inv = rsqrtf(sum / (float)K + eps);
  }
  __syncthreads();
  for (int k0 = t * 8; k0 < K; k0 += NORM_THREADS * 8 * NORM_BATCH) {
    uint4 v[NORM_BATCH];
#pragma unroll
    for (int u = 0; u < NORM_BATCH; ++u) {
      const int k = k0 + NORM_THREADS * 8 * u;
      if (k < K) v[u] = norm8<T>(xr + k, nw + k, inv, offset);
    }
#pragma unroll
    for (int u = 0; u < NORM_BATCH; ++u) {
      const int k = k0 + NORM_THREADS * 8 * u;
      if (k < K) *reinterpret_cast<uint4*>(hr + k) = v[u];
    }
  }
}

template <typename T>
static cudaError_t launch_norm_rows(const void* x, const void* nw, void* h, int rows, int K,
                                    float eps, int offset, cudaStream_t stream) {
  norm_rows_kernel<T><<<rows, NORM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(nw), static_cast<T*>(h), K, eps, offset);
  return cudaGetLastError();
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  *reinterpret_cast<typename Pair<T>::type*>(p) = Pair<T>::make(a, b);
}

// Shared-memory tiles of the tensor-core bodies, all 128-byte swizzled (a
// 128-byte row per tile row, 16-byte chunk c of row r at chunk c ^ (r % 8),
// as TMA writes them and the descriptors read them) from 1024-byte aligned
// bases: a W box is 64 k rows of 64 columns (MN-major), a row tile is its
// rows of 64 k (K-major).
constexpr int BK = 64;               // K a step covers: one 128-byte row of a 16-bit tile
constexpr int W_BOX = BK * 128;      // one TMA box of W, 8 KB
constexpr int MAX_STAGES = 8;        // ring depth bound (the mbarrier arrays)
constexpr int MAX_SPLITS = 8;        // swap AB's splits of K (the fold's registers)
constexpr int CONSUMERS = 256;       // two product warpgroups
constexpr int CONSUMER_WARPS = CONSUMERS / 32;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  // An offset from the extern array keeps every access a shared-memory one.
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// --------------------------------------------------------------- swap AB

constexpr int SA_COLS = 128;                   // output columns a block covers
constexpr int SA_THREADS = CONSUMERS + 32;     // two product warpgroups and a producer warp

// The rows' tile of each step (RP rows of 64 k from h, rows past `rows`
// and k past K zeros) comes by TMA beside W's two boxes.
template <typename T, int RP>
__global__ void __launch_bounds__(SA_THREADS, 2)
norm_matmul_swap_ab_kernel(const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ CUtensorMap hmap, T* __restrict__ out,
                           float* __restrict__ part, int* __restrict__ tickets, int rows, int K,
                           int N, int per, int stages) {
  constexpr int H_TILE = RP * 128;  // a step of the rows: RP x 64 k
  constexpr int STAGE = 2 * W_BOX + H_TILE;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ int s_last;
  unsigned char* base = align1024(tc_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * SA_COLS;
  const int steps = (K + BK - 1) / BK;
  const int lo = blockIdx.y * per, nst = min(steps, lo + per) - lo;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // The producer: each step's W boxes (a box wholly past N is not
    // loaded; its columns are never stored) and the rows' tile. The kernel
    // that writes h may still run: the first stages' W goes out before
    // waiting for it.
    if (lane == 0) {
      const bool second = n0 + 64 < N;
      const int ahead = min(stages, nst);
      for (int it = 0; it < nst; ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);
        unsigned char* st = base + (size_t)s * STAGE;
        const int k0 = (lo + it) * BK;
        mbar_expect_tx(&full[s], (second ? 2 : 1) * W_BOX + H_TILE);
        tma_load_2d(st, &wmap, n0, k0, &full[s]);
        if (second) tma_load_2d(st + W_BOX, &wmap, n0 + 64, k0, &full[s]);
        if (it + 1 == ahead) {
          griddep_wait();
          for (int j = 0; j < ahead; ++j)
            tma_load_2d(base + (size_t)j * STAGE + 2 * W_BOX, &hmap, (lo + j) * BK, 0, &full[j]);
        } else if (it >= ahead) {
          tma_load_2d(st + 2 * W_BOX, &hmap, k0, 0, &full[s]);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // this warpgroup's columns: n0 + 64 wg ..
  float acc[RP / 2];
#pragma unroll
  for (int i = 0; i < RP / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < nst; ++it) {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    const unsigned char* st = base + (size_t)s * STAGE;
    const unsigned char* a = st + wg * W_BOX;
    const unsigned char* b = st + 2 * W_BOX;
    wg_fence_acc(acc);
    wg_fence();
    // Each 16-deep K step: 16 rows of the W box (MN-major A), 32 bytes
    // along the rows' tile (K-major B).
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<1, 0>(acc, wg_desc(a + kk * 2048, W_BOX, 1024), wg_desc(b + kk * 32, 16, 1024),
                     static_cast<const T*>(nullptr));
    wg_commit();
    // This step's products stay in flight; the previous step's are done,
    // so its stage goes back to the producer.
    wg_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
  }
  wg_wait<0>();
  wg_fence_acc(acc);

  // Accumulator 4j + e (e = 0, 1): W column `col` (a row of the product's
  // M), row 8j + 2 (lane % 4) + e (its N); 4j + 2 + e: column col + 8.
  const int col = n0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int splits = gridDim.y;
  float* mine = part + (size_t)blockIdx.y * rows * N;
#pragma unroll
  for (int j = 0; j < RP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 8 * j + 2 * (lane & 3) + e;
      if (row >= rows) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col + 8 * h;
        if (c >= N) continue;
        if (splits == 1)
          out[(size_t)row * N + c] = from_f<T>(acc[4 * j + 2 * h + e]);
        else
          mine[(size_t)row * N + c] = acc[4 * j + 2 * h + e];
      }
    }
  if (splits == 1) return;

  // Take a ticket; the block that brings the strip's count to `splits` adds
  // the partials in split order and leaves the ticket at zero.
  __threadfence();
  named_barrier(1, CONSUMERS);
  if (tid == 0) {
    const int before = atomicAdd(tickets + blockIdx.x, 1);
    s_last = before == splits - 1;
    if (s_last) tickets[blockIdx.x] = 0;
  }
  named_barrier(1, CONSUMERS);
  if (!s_last) return;
  __threadfence();
  // Four columns a thread, every split's partial loaded before the adds;
  // the loop over the thread's groups unrolled, so the loads of several
  // groups are in flight together.
#pragma unroll
  for (int q = 0; q < RP * (SA_COLS / 4) / CONSUMERS; ++q) {
    const int i = tid + q * CONSUMERS, row = i / (SA_COLS / 4), c = n0 + i % (SA_COLS / 4) * 4;
    // N is a multiple of 8: a group's four columns are all in or all out.
    if (row >= rows || c >= N) continue;
    const float* p = part + (size_t)row * N + c;
    float4 v[MAX_SPLITS];
#pragma unroll
    for (int z = 0; z < MAX_SPLITS; ++z)
      if (z < splits) v[z] = __ldcg(reinterpret_cast<const float4*>(p + (size_t)z * rows * N));
    float4 sum = v[0];
#pragma unroll
    for (int z = 1; z < MAX_SPLITS; ++z)
      if (z < splits) {
        sum.x = __fadd_rn(sum.x, v[z].x);
        sum.y = __fadd_rn(sum.y, v[z].y);
        sum.z = __fadd_rn(sum.z, v[z].z);
        sum.w = __fadd_rn(sum.w, v[z].w);
      }
    T* o = out + (size_t)row * N + c;
    store2<T>(o, sum.x, sum.y);
    store2<T>(o + 2, sum.z, sum.w);
  }
}

template <typename T, int RP>
static cudaError_t launch_swap_ab(const void* h, const void* w, void* out, float* part,
                                  int* tickets, int rows, int K, int N, int per, int stages,
                                  cudaStream_t stream) {
  auto kernel = norm_matmul_swap_ab_kernel<T, RP>;
  const size_t smem = (size_t)stages * (2 * W_BOX + RP * 128) + 1024;  // + the alignment
  static size_t allowed = 0;  // the most this instantiation has opted into so far
  if (smem > allowed) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  CUtensorMap wmap, hmap;
  cudaError_t err = tile_map_2d<T>(&wmap, w, K, N, BK, 64);
  if (err == cudaSuccess) err = tile_map_2d<T>(&hmap, h, rows, K, RP, BK);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + SA_COLS - 1) / SA_COLS, ((K + BK - 1) / BK + per - 1) / per);
  cfg.blockDim = dim3(SA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // after norm_rows_kernel
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, wmap, hmap, static_cast<T*>(out), part, tickets, rows,
                            K, N, per, stages);
}

template <typename T>
static cudaError_t norm_matmul_swap_ab(const void* x, const void* nw, const void* w, void* out,
                                       void* h, float* part, int* tickets, int rows, int K, int N,
                                       float eps, int offset, int tile, int per, int stages,
                                       cudaStream_t stream) {
  const int splits = ((K + BK - 1) / BK + per - 1) / per;
  if (!h || rows > tile || splits > MAX_SPLITS || (splits > 1 && (!part || !tickets)))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_norm_rows<T>(x, nw, h, rows, K, eps, offset, stream);
  if (err != cudaSuccess) return err;
  switch (tile) {
    case 8: return launch_swap_ab<T, 8>(h, w, out, part, tickets, rows, K, N, per, stages, stream);
    case 16: return launch_swap_ab<T, 16>(h, w, out, part, tickets, rows, K, N, per, stages, stream);
    case 32: return launch_swap_ab<T, 32>(h, w, out, part, tickets, rows, K, N, per, stages, stream);
    case 64: return launch_swap_ab<T, 64>(h, w, out, part, tickets, rows, K, N, per, stages, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------ warp-specialized

constexpr int WS_ROWS = 128;                  // rows a tile covers: two warpgroups of 64
constexpr int WS_THREADS = CONSUMERS + 128;   // two product warpgroups and a producer warpgroup

template <typename T, int BN>
__global__ void __launch_bounds__(WS_THREADS, 1)
norm_matmul_ws_kernel(const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap wmap, T* __restrict__ out, int rows,
                      int K, int N, int stages) {
  constexpr int H_BOX = WS_ROWS * 128;  // a step of the tile's rows, 16 KB
  constexpr int STAGE = H_BOX + BN / 64 * W_BOX;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  unsigned char* base = align1024(tc_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int steps = (K + BK - 1) / BK;
  const int row_tiles = (rows + WS_ROWS - 1) / WS_ROWS;
  const int tiles = row_tiles * ((N + BN - 1) / BN);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // Tile t: row tile t % row_tiles of column strip t / row_tiles, so the
  // row tiles of a strip run on neighbouring blocks at once and share its
  // W through the L2.
  if (warp >= CONSUMER_WARPS) {
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS) {
      griddep_wait();  // h comes from norm_rows_kernel, which may still run
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % row_tiles) * WS_ROWS, n0 = (t / row_tiles) * BN;
        // W boxes wholly past N are not loaded: their columns are never stored.
        const int boxes = min(BN / 64, (N - n0 + 63) / 64);
        for (int ks = 0; ks < steps; ++ks, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);
          unsigned char* st = base + (size_t)s * STAGE;
          mbar_expect_tx(&full[s], H_BOX + boxes * W_BOX);
          tma_load_2d(st, &hmap, ks * BK, m0, &full[s]);
          for (int c = 0; c < boxes; ++c)
            tma_load_2d(st + H_BOX + c * W_BOX, &wmap, n0 + 64 * c, ks * BK, &full[s]);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp >> 2;  // this warpgroup's rows: m0 + 64 wg ..
  float acc[BN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % row_tiles) * WS_ROWS, n0 = (t / row_tiles) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const unsigned char* st = base + (size_t)s * STAGE;
      const unsigned char* a = st + wg * 64 * 128;
      const unsigned char* b = st + H_BOX;
      wg_fence_acc(acc);
      wg_fence();
      // Each 16-deep K step: 32 bytes along the h tile's rows (K-major A),
      // 16 rows of the W boxes (MN-major B, the boxes W_BOX apart).
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<0, 1>(acc, wg_desc(a + kk * 32, 16, 1024), wg_desc(b + kk * 2048, W_BOX, 1024),
                       static_cast<const T*>(nullptr));
      wg_commit();
      wg_wait<1>();
      if (ks > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
    }
    wg_wait<0>();
    wg_fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);

    // Accumulator 4j (+1): row `row`, columns n0 + 8j + 2 (lane % 4) (+1);
    // 4j + 2 (+1): row + 8.
    const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + j * 8 + (lane & 3) * 2;
      if (c >= N) continue;
      if (row < rows) store2<T>(out + (size_t)row * N + c, acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < rows)
        store2<T>(out + (size_t)(row + 8) * N + c, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <typename T, int BN>
static cudaError_t launch_ws(const void* h, const void* w, void* out, int rows, int K, int N,
                             int stages, cudaStream_t stream) {
  auto kernel = norm_matmul_ws_kernel<T, BN>;
  const size_t smem = (size_t)stages * (WS_ROWS * 128 + BN / 64 * W_BOX) + 1024;
  static size_t allowed = 0;
  if (smem > allowed) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  CUtensorMap hmap, wmap;
  cudaError_t err = tile_map_2d<T>(&hmap, h, rows, K, WS_ROWS, BK);
  if (err == cudaSuccess) err = tile_map_2d<T>(&wmap, w, K, N, BK, 64);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = (rows + WS_ROWS - 1) / WS_ROWS * ((N + BN - 1) / BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles < sms ? tiles : sms);  // persistent: a block an SM at most
  cfg.blockDim = dim3(WS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // after norm_rows_kernel
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, hmap, wmap, static_cast<T*>(out), rows, K, N, stages);
}

template <typename T>
static cudaError_t norm_matmul_ws(const void* x, const void* nw, const void* w, void* h,
                                  void* out, int rows, int K, int N, float eps, int offset,
                                  int tile, int stages, cudaStream_t stream) {
  if (!h) return cudaErrorInvalidValue;
  cudaError_t err = launch_norm_rows<T>(x, nw, h, rows, K, eps, offset, stream);
  if (err != cudaSuccess) return err;
  if (tile == 128) return launch_ws<T, 128>(h, w, out, rows, K, N, stages, stream);
  if (tile == 256) return launch_ws<T, 256>(h, w, out, rows, K, N, stages, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
static cudaError_t norm_matmul_tc(const void* x, const void* nw, const void* w, void* out,
                                  void* h, void* part, void* tickets, int rows, int K, int N,
                                  float eps, int offset, int body, int tile, int per, int stages,
                                  cudaStream_t stream) {
  if (stages < 2 || stages > MAX_STAGES) return cudaErrorInvalidValue;
  if (body == 1)
    return norm_matmul_swap_ab<T>(x, nw, w, out, h, static_cast<float*>(part),
                                  static_cast<int*>(tickets), rows, K, N, eps, offset, tile, per,
                                  stages, stream);
  if (body == 2)
    return norm_matmul_ws<T>(x, nw, w, h, out, rows, K, N, eps, offset, tile, stages, stream);
  return cudaErrorInvalidValue;
}

}  // namespace cake

// x: [rows, K]; nw: [K]; w: [K, N] row-major; out: [rows, N]; one dtype, all
// contiguous and 16-byte aligned, K and N multiples of 16 / sizeof(dtype).
// offset != 0: the norm weight applies as (1 + w). body (ops/fused_norm_matmul.py
// plan): 0 the GEMV (every dtype; h, part, tickets unused); 1 swap AB
// (f16/bf16, rows <= tile = 8, 16, 32 or 64; h a [rows, K] scratch for the
// normalized rows; K in splits of `per` 64-row steps, and past one split
// part: a [splits, rows, N] f32 scratch and tickets: [ceil(N / 128)] int32,
// zero between calls);
// 2 warp-specialized (f16/bf16; h a [rows, K] scratch; tile = BN, 128 or
// 256). stages: the ring's depth (2 to 8). Returns the first launch error.
extern "C" int cake_fused_norm_matmul(const void* x, const void* nw, const void* w, void* out,
                                      void* h, void* part, void* tickets, int rows, int K, int N,
                                      int dtype, float eps, int offset, int body, int tile,
                                      int per, int stages, void* stream) {
  using namespace cake;
  if (rows < 1) return (int)cudaSuccess;
  if (K < 1 || N < 1 || per < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (body != 0) return (int)cudaErrorInvalidValue;
      return (int)norm_matmul_by_rows<float>(x, nw, w, out, rows, K, N, eps, offset, s);
    case kF16:
      if (body == 0)
        return (int)norm_matmul_by_rows<__half>(x, nw, w, out, rows, K, N, eps, offset, s);
      return (int)norm_matmul_tc<__half>(x, nw, w, out, h, part, tickets, rows, K, N, eps, offset,
                                         body, tile, per, stages, s);
    case kBF16:
      if (body == 0)
        return (int)norm_matmul_by_rows<__nv_bfloat16>(x, nw, w, out, rows, K, N, eps, offset, s);
      return (int)norm_matmul_tc<__nv_bfloat16>(x, nw, w, out, h, part, tickets, rows, K, N, eps,
                                                offset, body, tile, per, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
