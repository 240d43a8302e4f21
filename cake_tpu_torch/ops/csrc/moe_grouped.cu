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
// What bounds it on the H100: the products. A prefill chunk's rows reach
// each expert by the thousand (Mixtral's gate at 7424 rows over 8 experts:
// 0.87 TFLOP against 0.8 GB of weights), far above the ~295 operations a
// byte where the tensor cores, not device memory, set the pace. Small
// groups (Qwen3-MoE's 128 experts at a few dozen rows each) are bound by
// the weights' bytes instead: each expert's weights must stream once. On
// the card the loads cost as much as the products (PERF.md: each alone
// takes most of the kernel's time, and a shallower ring is slower), so the
// design spends its shared memory on the ring and shares W between blocks.
//
// The schedule, shared by both tensor-core bodies. Work items are (expert,
// 256-row pair of its group, column strip), numbered expert by expert,
// each expert's strips one after another and a strip's row pairs next to
// each other, so the items running at one time share a few W strips
// through the L2 and each strip streams from device memory about once per
// expert. Persistent blocks walk the items (one block or one cluster an
// item slot, as many slots as the card holds at once); the list is never
// materialized: each block reads ``offsets`` into shared memory, a warp
// scans the groups' pair counts into a prefix (tpre[e], items before
// expert e, a strip), and an item's expert is a binary search of that
// prefix (log2 E steps, not a walk from expert 0). The host reads nothing
// back. TMA brings both operands: x is one 2-D map over [M, K] (boxes of 64
// k), W one 3-D map over the stack [E, K, N] (boxes of 64 k of one
// expert), so a ragged last K step reads zeros past K in both and never the
// next expert's rows. An item that runs past its group loads the next
// group's rows (or zeros past M); those rows are computed and never stored.
// A producer warpgroup gives its registers to the consumers (setmaxnreg);
// one of its threads keeps the ring of stages in flight behind full and
// empty mbarriers, and two consumer warpgroups run the products, one
// step's in flight while the next waits for its stage. The epilogue stores
// only rows below the group's end (a whole-tile store would overwrite the
// next group's rows), packed to x's dtype, while the producer already
// loads the next item.
//
// 16-bit stacks (grouped_ws_kernel): an item runs on a cluster of two
// blocks, 128 rows each, sharing the W strip: each block loads half of the
// strip's 64-column boxes and multicasts them into both. Each consumer
// warpgroup runs m64nBNk16 (BN = 256, or 128 for narrow N) over its 64
// rows, x K-major and W MN-major as stored; a warpgroup whose rows all lie
// past its group's end skips the products but still releases every stage
// to both blocks' producers. A quad of lanes transposes its accumulators
// so each lane stores 16 contiguous bytes.
//
// int8 stacks (grouped_swap_kernel), "swap AB": out^T = W^T x^T. wgmma
// takes no int8 x bf16 product and B must come from shared memory, so W
// becomes the register A operand: every consumer thread reads its two
// neighbouring columns' bytes (one 16-bit read a k row) and widens them
// exactly (a byte permute builds 2^23 + 128 + w as a float, one
// subtraction gives w, the high half is its bf16; f16 by 1024 + 128 + w in
// half2), a step ahead of the products, which run meanwhile. x, the B
// operand, is the item's 256 rows, K-major: m64n256k16, 128 W columns an
// item, one block an item. Widening a 16-bit copy of the strip into shared
// memory instead (a producer warp's job, then the 16-bit body's products)
// measured about twice the bf16 time: the copy through shared memory set
// the pace.
//
// Rows are independent of their neighbours, bitwise: every output element
// is one row times one column, accumulated in f32 over K in one fixed
// order (64-deep steps, four k16 wgmma in order, no split of K), and the
// body, tile and instruction are a function of (K, N, dtype, quant) alone
// (ops/moe.plan), never of M or the group sizes. So an output row's bits
// depend only on that row and its expert's weights, not on how many rows
// the expert got (cuBLAS picks its kernel by the row count, which is why a
// loop of per-expert cuBLAS products gave the warm prefix wave other bits
// than the cold one).
//
// f32 rows take a CUDA-core loop, one output a thread, k in order (fmaf),
// over 64-row tiles found by a walk of the offsets.

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace cake {
namespace moegrp {

// ------------------------------------------------------------------ f32

constexpr int F32_ROWS = 64;
constexpr int F32_COLS = 128;

// The (expert, first row, row end) of 64-row tile `t`, or e = -1 past the last.
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets, int E, int t, int& e,
                                          int& r0, int& r1) {
  e = -1;
  for (int i = 0; i < E; ++i) {
    const int lo = offsets[i], hi = offsets[i + 1];
    const int tiles = (hi - lo + F32_ROWS - 1) / F32_ROWS;
    if (t < tiles) {
      e = i;
      r0 = lo + t * F32_ROWS;
      r1 = hi;
      return;
    }
    t -= tiles;
  }
}

template <typename W>
__global__ void __launch_bounds__(F32_COLS)
grouped_f32_kernel(const float* __restrict__ x, const W* __restrict__ w,
                   const int* __restrict__ offsets, float* __restrict__ out, int K, int N, int E) {
  int e, r0, r1;
  find_tile(offsets, E, blockIdx.y, e, r0, r1);
  if (e < 0) return;
  const int n = blockIdx.x * F32_COLS + threadIdx.x;
  if (n >= N) return;
  const W* we = w + (size_t)e * K * N + n;
  const int rend = min(r1, r0 + F32_ROWS);
  for (int r = r0; r < rend; ++r) {
    const float* xr = x + (size_t)r * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(xr[k], (float)we[(size_t)k * N], acc);
    out[(size_t)r * N + n] = acc;
  }
}

template <typename W>
static cudaError_t launch_f32(const void* x, const void* w, const int* off, void* out, int M, int K,
                       int N, int E, cudaStream_t s) {
  const int tiles = (M + F32_ROWS - 1) / F32_ROWS + E;  // each group wastes at most one tile
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + F32_COLS - 1) / F32_COLS, tiles);
  grouped_f32_kernel<W><<<grid, F32_COLS, 0, s>>>(static_cast<const float*>(x),
                                                  static_cast<const W*>(w), off,
                                                  static_cast<float*>(out), K, N, E);
  return cudaGetLastError();
}

// ------------------------------------------------------ the tensor-core bodies

// Shared-memory tiles, all 128-byte swizzled (16-byte chunk c of a 128-byte
// row r at chunk c ^ (r % 8), as TMA writes them and the descriptors read
// them) from 1024-byte aligned bases.
constexpr int ROWS = 128;               // rows a block of a 16-bit item covers
constexpr int CLUSTER = 2;              // blocks of an item, one row tile each
constexpr int PAIR = CLUSTER * ROWS;    // rows an item covers
constexpr int BK = 64;                  // K a step covers: one 128-byte row of a 16-bit x tile
constexpr int X_BOX = ROWS * 128;       // the x tile of a step, 16 KB
constexpr int W_BOX = BK * 128;         // 64 k x 64 16-bit columns, 8 KB
constexpr int R_BOX = BK * 128;         // 64 k x 128 int8 columns, 8 KB
constexpr int CONSUMERS = 256;          // two product warpgroups
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
constexpr int SA_COLS = 128;            // int8 stacks: W columns an item covers
constexpr int MAX_STAGES = 8;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  // An offset from the extern array keeps every access a shared-memory one.
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" :::
          "memory");
}
// One arrival on the mbarrier at `bar`'s offset in block `cta` of the
// cluster (release at the block's scope, as CUTLASS's cluster barriers do:
// the cluster-scope release cost more than the whole product).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 a;\nmapa.shared::cluster.u32 a, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [a];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
// A box of a 3-D map into the same offset of every block in `mask`, each
// block's mbarrier at `bar`'s offset counting its bytes.
__device__ __forceinline__ void tma_load_3d_multicast(void* dst, const void* tmap, int c0, int c1,
                                                      int c2, uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::"
      "cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(smem_u32(dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}
__device__ __forceinline__ uint32_t ld_shared_u16(uint32_t a) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}

// Work item t of a cluster: expert e, the block's rows [r0, rend) (rows
// past rend are never stored; rank r's tile starts 128 r rows into the
// item's 256), columns from n0. tpre[e]: 256-row items of the groups
// before e, a strip. Items run expert by expert, strip by strip, the row
// pairs of a strip fastest (ops/moe.tile_items is the same arithmetic in
// Python).
struct Item {
  int e, r0, rend, n0;
};
template <int BN>
__device__ __forceinline__ Item item_of(int t, int rank, const int* soff, const int* tpre, int E,
                                        int strips) {
  int lo = 0, hi = E;  // the last expert whose first item is at or before t
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (strips * tpre[mid] <= t) lo = mid;
    else hi = mid;
  }
  const int pairs = tpre[lo + 1] - tpre[lo], local = t - strips * tpre[lo];
  return {lo, soff[lo] + (local % pairs) * PAIR + rank * ROWS, soff[lo + 1], (local / pairs) * BN};
}

// Every block's copy of the offsets and their item prefix: an exclusive
// scan of the groups' row pairs by warp 0, 32 groups at a time.
__device__ __forceinline__ void load_schedule(const int* __restrict__ offsets, int E, int* soff,
                                              int* tpre) {
  for (int i = threadIdx.x; i <= E; i += blockDim.x) soff[i] = offsets[i];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    if (lane == 0) tpre[0] = 0;
    for (int b = 0; b < E; b += 32) {
      const int e = b + lane;
      int c = e < E ? (soff[e + 1] - soff[e] + PAIR - 1) / PAIR : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, c, d);
        if (lane >= d) c += v;
      }
      if (e < E) tpre[e + 1] = carry + c;
      carry += __shfl_sync(0xffffffffu, c, 31);
    }
  }
}

// One m64n8 row quad's four words of four neighbouring 8-column groups
// (lane t holds columns 8j + 2t, +1 of group j) transposed across the quad:
// lane t ends with group t's eight columns in order, one 16-byte store.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  // bit 1: swap with lane t ^ 1 the words whose group differs from t in bit 0
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, (t & 1) ? v[0] : v[1], 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, (t & 1) ? v[2] : v[3], 1);
  if (t & 1) { v[0] = r0; v[2] = r1; } else { v[1] = r0; v[3] = r1; }
  // bit 2: swap with lane t ^ 2 the words whose group differs from t in bit 1
  r0 = __shfl_xor_sync(0xffffffffu, (t & 2) ? v[0] : v[2], 2);
  r1 = __shfl_xor_sync(0xffffffffu, (t & 2) ? v[1] : v[3], 2);
  if (t & 2) { v[0] = r0; v[1] = r1; } else { v[2] = r0; v[3] = r1; }
}

// 16-bit stacks: x (A, K-major) and W (B, MN-major as stored) from the
// ring, m64nBNk16, two consumer warpgroups of 64 rows; the cluster's two
// blocks take the item's two row tiles and multicast halves of its W strip.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 1)
grouped_ws_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const int* __restrict__ offsets,
                  T* __restrict__ out, int K, int N, int E, int stages) {
  constexpr int STAGE = X_BOX + BN / 64 * W_BOX;
  extern __shared__ __align__(1024) unsigned char ws_smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  unsigned char* base = align1024(ws_smem);
  int* soff = reinterpret_cast<int*>(base + (size_t)stages * STAGE);  // [E + 1]
  int* tpre = soff + E + 1;                                           // [E + 1]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cluster_rank();
  const int steps = (K + BK - 1) / BK;
  const int strips = (N + BN - 1) / BN;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      // both blocks' consumers release a stage: each block multicasts its
      // share of W into both
      mbar_init(&empty[s], CLUSTER * CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  load_schedule(offsets, E, soff, tpre);
  // The peer's barriers are initialized before any multicast or remote
  // arrival reaches them; tpre is visible to the block.
  cluster_sync();
  const int items = strips * tpre[E];
  const int first = blockIdx.x / CLUSTER, stride = gridDim.x / CLUSTER;

  if (warp >= CONSUMER_WARPS) {
    setmaxnreg_dec<40>();
    if (tid != CONSUMERS) return;
    // The TMA thread: its x tile and its share of the item's W strip, that
    // share multicast to both blocks, every K step of every item.
    int it = 0;
    for (int t = first; t < items; t += stride) {
      const Item job = item_of<BN>(t, rank, soff, tpre, E, strips);
      // W boxes wholly past N are not loaded: their columns are never stored.
      const int boxes = min(BN / 64, (N - job.n0 + 63) / 64);
      for (int ks = 0; ks < steps; ++ks, ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);
        unsigned char* st = base + (size_t)s * STAGE;
        mbar_expect_tx(&full[s], X_BOX + boxes * W_BOX);
        tma_load_2d(st, &xmap, ks * BK, job.r0, &full[s]);
        for (int c = rank; c < boxes; c += CLUSTER)
          tma_load_3d_multicast(st + X_BOX + c * W_BOX, &wmap, job.n0 + 64 * c, ks * BK, job.e,
                                &full[s], (1 << CLUSTER) - 1);
      }
    }
    // Stay until the cluster released the last stages: every multicast
    // into the peer has landed and every remote arrival on this block's
    // barriers has come before the block exits.
    for (int j = it > stages ? it - stages : 0; j < it; ++j)
      mbar_wait(&empty[j % stages], (j / stages) & 1);
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp >> 2;  // this warpgroup's rows: r0 + 64 wg ..
  float acc[BN / 2];
  int it = 0;
  auto release = [&](int j) {  // iteration j's stage, to both blocks' producers
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CLUSTER; ++c) mbar_arrive_cluster(&empty[j % stages], c);
    }
  };
  for (int t = first; t < items; t += stride) {
    const Item job = item_of<BN>(t, rank, soff, tpre, E, strips);
    const int r0 = job.r0 + 64 * wg;
    if (r0 >= job.rend) {
      // Every row of this warpgroup lies past the group: no products, but
      // the stages are released in order, each once it is full.
      for (int ks = 0; ks < steps; ++ks, ++it) {
        mbar_wait(&full[it % stages], (it / stages) & 1);
        release(it);
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const unsigned char* st = base + (size_t)s * STAGE;
      const unsigned char* a = st + wg * 64 * 128;
      const unsigned char* b = st + X_BOX;
      wg_fence_acc(acc);
      wg_fence();
      // Each 16-deep K step: 32 bytes along the x tile's rows (K-major A),
      // 16 rows of the W boxes (MN-major B, the boxes W_BOX apart).
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<0, 1>(acc, wg_desc(a + kk * 32, 16, 1024), wg_desc(b + kk * 2048, W_BOX, 1024),
                       static_cast<const T*>(nullptr));
      wg_commit();
      wg_wait<1>();
      if (ks > 0) release(it - 1);
    }
    wg_wait<0>();
    wg_fence_acc(acc);
    release(it - 1);

    // Accumulator 4j (+1): row `row`, columns n0 + 8j + 2 (lane % 4) (+1);
    // 4j + 2 (+1): row + 8. A quad's words of four groups of 8 columns are
    // transposed so each lane stores one group's 16 bytes; rows at or past
    // the group's end are not stored.
    const int row = r0 + (warp & 3) * 16 + (lane >> 2), q4 = lane & 3;
#pragma unroll
    for (int jg = 0; jg < BN / 32; ++jg) {
      uint32_t top[4], bot[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * jg + u;
        top[u] = pack2<T>(acc[4 * j], acc[4 * j + 1]);
        bot[u] = pack2<T>(acc[4 * j + 2], acc[4 * j + 3]);
      }
      quad_transpose(top, q4);
      quad_transpose(bot, q4);
      const int c = job.n0 + jg * 32 + q4 * 8;
      if (c >= N) continue;
      if (row < job.rend)
        *reinterpret_cast<uint4*>(out + (size_t)row * N + c) =
            make_uint4(top[0], top[1], top[2], top[3]);
      if (row + 8 < job.rend)
        *reinterpret_cast<uint4*>(out + (size_t)(row + 8) * N + c) =
            make_uint4(bot[0], bot[1], bot[2], bot[3]);
    }
  }
}

// Four int8 weights, bytes [c0 at k, c1 at k, c0 at k + 1, c1 at k + 1]
// of two neighbouring columns, as two A registers, each widened exactly to
// T: a holds column c0 at k and k + 1, b column c1.
template <typename T>
__device__ __forceinline__ void widen_pair(uint32_t w, uint32_t& a, uint32_t& b);
template <>
__device__ __forceinline__ void widen_pair<__nv_bfloat16>(uint32_t w, uint32_t& a, uint32_t& b) {
  const uint32_t u = w ^ 0x80808080u;  // each byte w + 128, unsigned
  // 2^23 + (w + 128) as a float, less 2^23 + 128: w, exactly; |w| <= 128
  // has at most 8 significant bits, so the high half is the bf16 value.
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  a = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  b = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}
template <>
__device__ __forceinline__ void widen_pair<__half>(uint32_t w, uint32_t& a, uint32_t& b) {
  const uint32_t u = w ^ 0x80808080u;
  // 0x64xx is 1024 + xx in f16; less 1024 + 128: w, exactly.
  const __half2 bias = __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480));
  uint32_t lo = __byte_perm(u, 0x64646464u, 0x4240);  // c0 at k, k + 1
  uint32_t hi = __byte_perm(u, 0x64646464u, 0x4341);  // c1 at k, k + 1
  const __half2 l = __hsub2(*reinterpret_cast<const __half2*>(&lo), bias);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&hi), bias);
  a = *reinterpret_cast<const uint32_t*>(&l);
  b = *reinterpret_cast<const uint32_t*>(&h);
}

// int8 stacks, "swap AB": out^T = W^T x^T. W's columns are wgmma's M, 64 a
// warpgroup, their int8 bytes widened straight into the register A operand
// by every consumer thread (the fragment's rows g and g + 8 are two
// neighbouring columns, so one 16-bit read of a row gives both); x, by TMA,
// is the K-major B, the item's 256 rows the product's N (m64n256k16), so a
// widened A serves every row of the item. A step's products stay in flight
// while the next step's A is widened (two register sets). The item
// schedule is the 16-bit body's, one block an item.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
grouped_swap_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const int* __restrict__ offsets,
                    T* __restrict__ out, int K, int N, int E, int stages) {
  constexpr int STAGE = PAIR * 128 + R_BOX;
  extern __shared__ __align__(1024) unsigned char ws_smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  unsigned char* base = align1024(ws_smem);
  int* soff = reinterpret_cast<int*>(base + (size_t)stages * STAGE);  // [E + 1]
  int* tpre = soff + E + 1;                                           // [E + 1]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int steps = (K + BK - 1) / BK;
  const int strips = (N + SA_COLS - 1) / SA_COLS;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  load_schedule(offsets, E, soff, tpre);
  __syncthreads();
  const int items = strips * tpre[E];

  if (warp >= CONSUMER_WARPS) {
    setmaxnreg_dec<40>();
    if (tid != CONSUMERS) return;
    int it = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const Item job = item_of<SA_COLS>(t, 0, soff, tpre, E, strips);
      for (int ks = 0; ks < steps; ++ks, ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);
        unsigned char* st = base + (size_t)s * STAGE;
        mbar_expect_tx(&full[s], PAIR * 128 + R_BOX);
        tma_load_2d(st, &xmap, ks * BK, job.r0, &full[s]);
        tma_load_3d(st + PAIR * 128, &wmap, job.n0, ks * BK, job.e, &full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp >> 2, g = lane >> 2, q4 = lane & 3;
  // This thread's two neighbouring columns of the strip: 16-byte chunk
  // 4 wg + warp % 4 of a raw row, bytes 2g and 2g + 1.
  const int chunk = 4 * wg + (warp & 3);
  float acc[PAIR / 2];
  int it = 0;
  // Step j's A operand (four k16 steps) from its raw strip: rows 16 kk +
  // 2 q4 (+1) and + 8 (+9), each read once as the column pair.
  auto widen = [&](int j, uint32_t (&as)[BK / 16][4]) {
    const int s = j % stages;
    mbar_wait(&full[s], (j / stages) & 1);
    const uint32_t raw = smem_u32(base + (size_t)s * STAGE + PAIR * 128) + 2 * g;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kk * 16 + 2 * q4 + 8 * h;  // k and k + 1 share k % 8 >> 1
        const uint32_t r0 = ld_shared_u16(raw + k * 128 + ((chunk ^ (k & 7)) << 4));
        const uint32_t r1 = ld_shared_u16(raw + (k + 1) * 128 + ((chunk ^ ((k + 1) & 7)) << 4));
        widen_pair<T>(r0 | (r1 << 16), as[kk][2 * h], as[kk][2 * h + 1]);
      }
  };
  auto mma = [&](int j, const uint32_t (&as)[BK / 16][4]) {
    const unsigned char* xs = base + (size_t)(j % stages) * STAGE;
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<PAIR, T>(acc, as[kk], wg_desc(xs + kk * 32, 16, 1024));
    wg_commit();
  };
  auto release = [&](int j) {
    if (lane == 0) mbar_arrive(&empty[j % stages]);
  };
  uint32_t a0[BK / 16][4], a1[BK / 16][4];
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const Item job = item_of<SA_COLS>(t, 0, soff, tpre, E, strips);
#pragma unroll
    for (int i = 0; i < PAIR / 2; ++i) acc[i] = 0.f;
    // Step ks: its products from one register set, then (once step ks - 1's
    // products are done, freeing the other set and its stage) the next
    // step's A into the other set while these run.
    const int it0 = it;
    widen(it0, a0);
    int ks = 0;
    for (; ks + 1 < steps; ks += 2) {
      mma(it0 + ks, a0);
      wg_wait<1>();
      if (ks > 0) release(it0 + ks - 1);
      widen(it0 + ks + 1, a1);
      mma(it0 + ks + 1, a1);
      wg_wait<1>();
      release(it0 + ks);
      if (ks + 2 < steps) widen(it0 + ks + 2, a0);
    }
    if (ks < steps) {
      mma(it0 + ks, a0);
      wg_wait<1>();
      if (ks > 0) release(it0 + ks - 1);
    }
    wg_wait<0>();
    wg_fence_acc(acc);
    release(it0 + steps - 1);
    it = it0 + steps;

    // Accumulator 4j (+1): column m = 16 (warp % 4) + g of this warpgroup's
    // 64 (the pair 2g, 2g + 1 of its chunk: m and m + 8 are accumulators
    // 4j + 2 (+3)), rows 8j + 2 q4 (+1). Each store: one row's two columns.
    const int col = job.n0 + 16 * chunk + 2 * g;
    if (col < N) {
#pragma unroll
      for (int j = 0; j < PAIR / 8; ++j) {
        const int row = job.r0 + 8 * j + 2 * q4;
        if (row < job.rend)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
              pack2<T>(acc[4 * j], acc[4 * j + 2]);
        if (row + 1 < job.rend)
          *reinterpret_cast<uint32_t*>(out + (size_t)(row + 1) * N + col) =
              pack2<T>(acc[4 * j + 1], acc[4 * j + 3]);
      }
    }
  }
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

// The TMA map of the stack [E, K, N] (elem bytes a value) in boxes of
// box_n columns x BK k rows of one expert, 128-byte swizzled, zeros past
// the edges (past K within an expert too).
static cudaError_t stack_map(CUtensorMap* map, const void* w, CUtensorMapDataType type, int elem,
                             int E, int K, int N, int box_n) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * elem, (cuuint64_t)K * N * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_n, (cuuint32_t)BK, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(w), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Host helpers keep internal linkage: a static local of an external
// template would be one object across every library loaded in the process
// (a timing script loads variants side by side), and a second library would
// skip its own shared-memory opt-in.
template <typename T, bool QUANT, int BN>
static cudaError_t launch_body(const void* x, const void* w, const int* off, void* out, int M,
                             int K, int N, int E, int stages, cudaStream_t s) {
  const auto kernel = QUANT ? grouped_swap_kernel<T> : grouped_ws_kernel<T, BN>;
  const size_t stage = QUANT ? PAIR * 128 + R_BOX : X_BOX + BN / 64 * W_BOX;
  const size_t smem = (size_t)stages * stage + 1024 + 8 * (size_t)(E + 1);
  static size_t allowed = 0;
  if (smem > allowed) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  CUtensorMap xmap, wmap;
  cudaError_t err = tile_map_2d<T>(&xmap, x, M, K, QUANT ? PAIR : ROWS, BK);
  if (err == cudaSuccess)
    err = QUANT ? stack_map(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, E, K, N, SA_COLS)
                : stack_map(&wmap, w,
                            std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, E, K, N, 64);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // A bound on the items: every group wastes at most one row pair a strip.
  const long long bound = (long long)((N + BN - 1) / BN) * ((M + PAIR - 1) / PAIR + E);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms / CLUSTER * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = QUANT ? 1 : CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Persistent: no more items at once than the card holds (a cluster waits
  // for a pair of SMs its GPC can give it), nor than the items.
  static int resident = 0;
  static size_t resident_smem = 0;
  if (resident_smem != smem) {
    if (QUANT) {
      resident = sms;
    } else {
      err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (resident < 1) return cudaErrorInvalidConfiguration;
    }
    resident_smem = smem;
  }
  const int slots = bound < resident ? (int)bound : resident;
  cfg.gridDim = dim3(QUANT ? slots : slots * CLUSTER);
  return cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, off, static_cast<T*>(out), K, N, E, stages);
}

template <typename T, bool QUANT>
static cudaError_t launch_tc(const void* x, const void* w, const int* off, void* out, int M,
                             int K, int N, int E, int tile, int stages, cudaStream_t s) {
  if (stages < 2 || stages > MAX_STAGES) return cudaErrorInvalidValue;
  if (QUANT) {
    if (tile != SA_COLS) return cudaErrorInvalidValue;
    return launch_body<T, true, SA_COLS>(x, w, off, out, M, K, N, E, stages, s);
  }
  if (tile == 128) return launch_body<T, false, 128>(x, w, off, out, M, K, N, E, stages, s);
  if (tile == 256) return launch_body<T, false, 256>(x, w, off, out, M, K, N, E, stages, s);
  return cudaErrorInvalidValue;
}

}  // namespace moegrp
}  // namespace cake

// x [M, K] (rows sorted by expert), w [E, K, N] (x's dtype, or int8 when
// quant), offsets [E + 1] int32 on the device, out [M, N] in x's dtype; x
// and w 16-byte aligned. body (ops/moe.py plan): 0 the f32 CUDA-core loop
// (tile, stages unused); 1 the warp-specialized wgmma body (f16/bf16 rows,
// 16-bit stacks) with column tile `tile` (128 or 256); 2 swap AB (f16/bf16
// rows, int8 stacks), tile 128; a ring of `stages` (2 to 8).
extern "C" int cake_moe_grouped(const void* x, const void* w, const void* offsets, void* out,
                                int M, int K, int N, int E, int dtype, int quant, int body,
                                int tile, int stages, void* stream) {
  using namespace cake;
  using namespace cake::moegrp;
  if (M < 1) return (int)cudaSuccess;
  if (E < 1 || K < 32 || K % 32 || N < 8 || N % (quant ? 16 : 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (dtype == kF32) {
    if (body != 0) return (int)cudaErrorInvalidValue;
    return quant ? (int)launch_f32<int8_t>(x, w, off, out, M, K, N, E, s)
                 : (int)launch_f32<float>(x, w, off, out, M, K, N, E, s);
  }
  if (body != (quant ? 2 : 1)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF16:
      return quant ? (int)launch_tc<__half, true>(x, w, off, out, M, K, N, E, tile, stages, s)
                   : (int)launch_tc<__half, false>(x, w, off, out, M, K, N, E, tile, stages, s);
    case kBF16:
      return quant
                 ? (int)launch_tc<__nv_bfloat16, true>(x, w, off, out, M, K, N, E, tile, stages, s)
                 : (int)launch_tc<__nv_bfloat16, false>(x, w, off, out, M, K, N, E, tile, stages,
                                                        s);
    default: return (int)cudaErrorInvalidValue;
  }
}
