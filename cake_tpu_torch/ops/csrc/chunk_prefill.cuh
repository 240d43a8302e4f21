// A chunk of queries attending the live KV prefix (prefill), causal GQA:
// the kernel body shared by chunk_prefill.cu (dense cache, and the fresh
// projections of the position-0 prefill) and paged_chunk_attention.cu (page
// pool). The two differ only in the Layout that turns a key slot into an
// address (kv_layout.cuh); tiles, loop bounds and arithmetic are this body.
//
// Row r's query i sits at absolute position q_starts[r] + i and sees key
// slot j when
//     k_starts[r] <= j <= its position,  j < lengths[r],
//     and, with a window gated on by *flag, j > its position - window.
// Scores and the softmax state are f32; all-masked rows (padded queries,
// left-pad-only rows) come out exactly 0; p is rounded to V's dtype before
// p@v, as in the reference.
//
// Bound on the H100: at the main path's shapes (a 256-2048 token chunk over
// a prefix of the same order, head_dim 128) the work is about 4*head_dim
// FLOPs per (query, key) pair against 4*head_dim bytes per key row read
// once, so the kernel is bound by the tensor cores' operations.
//
// Head dims 64, 96, 128 and 256: every tile loop runs over head_dim / 16
// k-steps of mma.sync (6 at 96) and head_dim / 8 output n8 tiles, and a row
// of a shared tile is head_dim + 8 elements (208 bytes at 96 in f16/bf16:
// 16-byte aligned for ldmatrix, its 8 rows on distinct bank quads).
//
// Design (f16, bf16: chunk_kernel_tc): one block per (64 rows, KV head,
// batch row), 4 warps of 16 rows. A row is a (query, head) pair of the KV
// head's GQA group, queries outer, so the block covers 64 / group queries
// of every head of the group and each K/V tile is read once for the group
// (not once per query head). Both products run on the tensor cores,
// mma.sync m16n8k16 with f32 accumulation: S = Q K^T from ldmatrix
// fragments of the Q tile and a 64-key K tile, then the online softmax in
// f32 on the accumulators (a row's scores on the 4 threads of a quad), then
// O += P V with P rounded to the dtype and fed straight from the score
// registers as the A fragments, V through ldmatrix.trans. K/V tiles land
// through cp.async, two stages, the next tile in flight while the current
// one is used. f32 takes chunk_kernel, the same loop on the CUDA cores:
// 32-query tiles of one head, each thread a 4x4 block of scores.
//
// An f8 (e4m3) cache (KT = f8; T stays q's dtype): the tensor-core body
// stages each K/V tile narrow, 128 bytes a key row where bf16 takes 256 at
// head_dim 128 (by cp.async, into two stages), and after the wait
// widens the current tile in shared memory into the T layout ldmatrix reads
// (exact: every e4m3 value is an f16 and a bf16 value), so the products and
// every bit after them are the T kernel's over the widened cache. The f32
// body widens each 16-byte narrow load in registers into its f32 tile.
//
// Both bodies loop over 64-key tiles from the first key any row needs
// (k_starts and the window) to the last (the causal end and lengths):
// pruning is the loop bound, as the reference's block pruning. The tiles
// sit at multiples of 64 in key position, not where the query block
// starts, so a query's sums run over the same tiles whichever block holds
// it: the warm suffix prefill over a cached prefix gives the cold
// prefill's bits. Keys outside the block's range land as zeros.
//
// Dense K and V are addressed through strides with the head_dim axis
// contiguous, so the same kernel reads the head-major cache [b, n_kv,
// max_seq, hd] and the fresh seq-major projections [b, seq, n_kv, hd] of the
// position-0 prefill without a copy. Paged K/V resolve each key row of a
// tile through the block table (a 128-slot page holds two 64-key tiles).
#pragma once

#include "common.cuh"
#include "kv_layout.cuh"
#include "mma.cuh"

#include <type_traits>

namespace cake {

constexpr int CP_BQ = 32;       // query rows per block
constexpr int CP_BK = 64;       // keys per tile
constexpr int CP_THREADS = 128;
constexpr int CP_PAD = 16;      // bytes of padding per shared-memory row

template <typename T, int D>
struct ChunkSmem {
  static constexpr int LD = D + CP_PAD / (int)sizeof(T);  // row stride, elements
  static constexpr size_t bytes =
      (size_t)(CP_BQ + 2 * CP_BK) * LD * sizeof(T) + (size_t)CP_BQ * CP_BK * sizeof(float);
};

template <typename T, typename KT, int D, typename Layout>
__global__ void __launch_bounds__(CP_THREADS)
chunk_kernel(const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
             T* __restrict__ out, const int* __restrict__ q_starts,
             const int* __restrict__ lengths, const int* __restrict__ k_starts,
             const int* __restrict__ flag, Layout layout, int chunk, int group, long long qsb,
             long long qss, long long qsh, long long osb, long long oss, long long osh,
             int window, float scale, float softcap) {
  constexpr int LD = ChunkSmem<T, D>::LD;
  constexpr int NC = D / 16;                    // output columns per thread
  constexpr int VEC = 16 / (int)sizeof(T);      // elements per 16-byte copy
  constexpr int ROWV = D / VEC;                 // 16-byte copies per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);       // [CP_BQ][LD]
  T* sK = sQ + CP_BQ * LD;                      // [CP_BK][LD]
  T* sV = sK + CP_BK * LD;                      // [CP_BK][LD]
  float* sP = reinterpret_cast<float*>(sV + CP_BK * LD);  // [CP_BQ][CP_BK]

  const int q_lo = blockIdx.x * CP_BQ;
  const int h = blockIdx.y;
  const int row = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int tq = tid >> 4;   // owns rows tq*4 .. tq*4+3
  const int tk = tid & 15;   // owns keys tk + 16*jj and columns tk*NC ..
  const int n_rows = min(CP_BQ, chunk - q_lo);
  const int q0 = q_starts[row] + q_lo;          // absolute position of tile row 0
  const int k_first = max(k_starts[row], 0);
  const bool win = window > 0 && (flag == nullptr || flag[0] != 0);
  int kbeg = k_first;
  if (win) kbeg = max(kbeg, q0 - window + 1);
  const int kend = min(min(q0 + n_rows, lengths[row]), layout.limit());  // exclusive

  const T* qb = q + row * qsb + h * qsh;
  for (int idx = tid; idx < CP_BQ * ROWV; idx += CP_THREADS) {
    const int r = idx / ROWV;
    const int c = (idx % ROWV) * VEC;
    if (r < n_rows) copy16(sQ + r * LD + c, qb + (q_lo + r) * qss + c);
    else zero16(sQ + r * LD + c);
  }

  float o[4][NC], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  const auto cur = layout.cursor(row, kvh);
  // Key tiles sit at multiples of CP_BK, whatever the query tile: a
  // query's sums run over the same tiles in a cold prefill and a warm one.
  for (int kt = kbeg & ~(CP_BK - 1); kt < kend; kt += CP_BK) {
    __syncthreads();  // the previous tile's readers are done (and Q is loaded)
    if constexpr (std::is_same_v<KT, T>) {
      for (int idx = tid; idx < CP_BK * ROWV; idx += CP_THREADS) {
        const int r = idx / ROWV;
        const int c = (idx % ROWV) * VEC;
        const int j = kt + r;
        if (j >= kbeg && j < kend) {
          copy16(sK + r * LD + c, k + cur.template k<D>(j) + c);
          copy16(sV + r * LD + c, v + cur.template v<D>(j) + c);
        } else {
          zero16(sK + r * LD + c);
          zero16(sV + r * LD + c);
        }
      }
    } else {  // e4m3: 16 narrow bytes a load, widened into the f32 tile
      for (int idx = tid; idx < CP_BK * (D / 16); idx += CP_THREADS) {
        const int r = idx / (D / 16);
        const int c = (idx % (D / 16)) * 16;
        const int j = kt + r;
        float wk[16], wv[16];
        if (j >= kbeg && j < kend) {
          load_vec<KT, 16>(k + cur.template k<D>(j) + c, wk);
          load_vec<KT, 16>(v + cur.template v<D>(j) + c, wv);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) wk[i] = wv[i] = 0.f;
        }
        store_vec<T, 16>(sK + r * LD + c, wk);
        store_vec<T, 16>(sV + r * LD + c, wv);
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float qa[4][2], ka[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec<T, 2>(sQ + (tq * 4 + i) * LD + d, qa[i]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) load_vec<T, 2>(sK + (tk + 16 * jj) * LD + d, ka[jj]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[i][jj] = fmaf(qa[i][1], ka[jj][1], fmaf(qa[i][0], ka[jj][0], s[i][jj]));
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tq * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = kt + tk + 16 * jj;
        const bool ok = kpos < kend && kpos <= qpos && kpos >= k_first &&
                        (!win || kpos > qpos - window);
        s[i][jj] = ok ? softcap_score(s[i][jj] * scale, softcap) : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(mrow[i], mx);
      // All-masked so far: keep exact zeros (exp(-inf - 0) == 0).
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = __expf(mrow[i] - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = __expf(s[i][jj] - m_safe);
        psum += p;
        sP[(tq * 4 + i) * CP_BK + tk + 16 * jj] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      lrow[i] = lrow[i] * alpha + psum;
      mrow[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    const int j0 = max(kbeg - kt, 0), nk = min(CP_BK, kend - kt);
    for (int j = j0; j < nk; ++j) {
      float vv[NC];
      load_vec<T, NC>(sV + j * LD + tk * NC, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(tq * 4 + i) * CP_BK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tq * 4 + i;
    if (r >= n_rows) continue;
    const float inv = lrow[i] > 0.f ? 1.f / lrow[i] : 1.f;
    float vals[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) vals[c] = o[i][c] * inv;
    store_vec<T, NC>(out + row * osb + (q_lo + r) * oss + h * osh + tk * NC, vals);
  }
}

// ------------------------------------------------ tensor cores (f16, bf16)

// One block per (64 (query, head) rows, KV head, batch row), 4 warps of 16
// rows: row r is the pair p0 + r, query p / group and head p % group of the
// KV head's group, so a block covers 64 / group queries of every head of
// the group and reads each K/V tile once for all of them.
constexpr int TC_BM = 64;
constexpr int TC_BK = 64;       // keys per tile, tiles at multiples of TC_BK
constexpr int TC_THREADS = 128;

template <typename T, typename KT, int D>
struct ChunkTcSmem {
  static constexpr int LD = D + 8;  // row stride, elements (16 bytes of padding: ldmatrix conflict-free)
  static constexpr bool NARROW = !std::is_same_v<KT, T>;  // an e4m3 cache
  static constexpr int STAGES = NARROW ? 1 : 2;  // K/V tiles in T: the narrow ones stage twice
  static constexpr int LD8 = D + 16;  // narrow row stride, bytes (16-byte aligned rows)
  // Q, then K and V in T (two stages each, or the one widened tile), then
  // the narrow K and V in two stages each.
  static constexpr size_t bytes = (size_t)(TC_BM + 2 * STAGES * TC_BK) * LD * sizeof(T) +
                                  (NARROW ? (size_t)4 * TC_BK * LD8 : 0);
};

template <typename T, typename KT, int D, typename Layout>
__global__ void __launch_bounds__(TC_THREADS)
chunk_kernel_tc(const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
                T* __restrict__ out, const int* __restrict__ q_starts,
                const int* __restrict__ lengths, const int* __restrict__ k_starts,
                const int* __restrict__ flag, Layout layout, int chunk, int group, long long qsb,
                long long qss, long long qsh, long long osb, long long oss, long long osh,
                int window, float scale, float softcap) {
  using Smem = ChunkTcSmem<T, KT, D>;
  constexpr int LD = Smem::LD, LD8 = Smem::LD8;
  constexpr bool NARROW = Smem::NARROW;
  constexpr int ROWV = D / 8;  // 16-byte copies per row (T)
  constexpr int ROW8 = D / 16; // 16-byte copies per row (e4m3)
  constexpr int DT = D / 8;    // n8 tiles of a warp's output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);                 // [TC_BM][LD]
  T* sK = sQ + TC_BM * LD;                                // [STAGES][TC_BK][LD]
  T* sV = sK + Smem::STAGES * TC_BK * LD;                 // [STAGES][TC_BK][LD]
  KT* sK8 = reinterpret_cast<KT*>(sV + Smem::STAGES * TC_BK * LD);  // NARROW: [2][TC_BK][LD8]
  KT* sV8 = sK8 + 2 * TC_BK * LD8;                                  // NARROW: [2][TC_BK][LD8]

  const int kvh = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * TC_BM;
  const int n_pairs = min(TC_BM, chunk * group - p0);
  const int qs = q_starts[row];
  const int q0 = qs + p0 / group;  // the block's first and last query positions
  const int q1 = qs + (p0 + n_pairs - 1) / group;
  const int k_first = max(k_starts[row], 0);
  const bool win = window > 0 && (flag == nullptr || flag[0] != 0);
  int kbeg = k_first;
  if (win) kbeg = max(kbeg, q0 - window + 1);
  const int kend = min(min(q1 + 1, lengths[row]), layout.limit());  // exclusive

  const T* qb = q + row * qsb + (size_t)kvh * group * qsh;
  for (int idx = tid; idx < TC_BM * ROWV; idx += TC_THREADS) {
    const int r = idx / ROWV, c = (idx % ROWV) * 8;
    const int p = p0 + r;
    const bool ok = r < n_pairs;
    cp_async16(sQ + r * LD + c, ok ? qb + (p / group) * qss + (p % group) * qsh + c : q, ok);
  }
  const auto cur = layout.cursor(row, kvh);
  // Keys outside [kbeg, kend) land as zeros: no row of the block sees them.
  auto load_kv = [&](int kt, int s) {
    if constexpr (NARROW) {
      for (int idx = tid; idx < TC_BK * ROW8; idx += TC_THREADS) {
        const int r = idx / ROW8, c = (idx % ROW8) * 16;
        const int j = kt + r;
        const bool ok = j >= kbeg && j < kend;
        cp_async16(sK8 + (s * TC_BK + r) * LD8 + c, ok ? k + cur.template k<D>(j) + c : k, ok);
        cp_async16(sV8 + (s * TC_BK + r) * LD8 + c, ok ? v + cur.template v<D>(j) + c : v, ok);
      }
    } else {
      for (int idx = tid; idx < TC_BK * ROWV; idx += TC_THREADS) {
        const int r = idx / ROWV, c = (idx % ROWV) * 8;
        const int j = kt + r;
        const bool ok = j >= kbeg && j < kend;
        T* dk = sK + (s * TC_BK + r) * LD + c;
        T* dv = sV + (s * TC_BK + r) * LD + c;
        cp_async16(dk, ok ? k + cur.template k<D>(j) + c : k, ok);
        cp_async16(dv, ok ? v + cur.template v<D>(j) + c : v, ok);
      }
    }
  };
  // NARROW: stage s's e4m3 tiles widened into the T tiles (zeros stay zeros).
  auto widen_kv = [&](int s) {
    for (int idx = tid; idx < TC_BK * ROW8; idx += TC_THREADS) {
      const int r = idx / ROW8, c = (idx % ROW8) * 16;
      float w[16];
      load_vec<KT, 16>(sK8 + (s * TC_BK + r) * LD8 + c, w);
      store_vec<T, 16>(sK + r * LD + c, w);
      load_vec<KT, 16>(sV8 + (s * TC_BK + r) * LD8 + c, w);
      store_vec<T, 16>(sV + r * LD + c, w);
    }
  };

  // This thread's rows: 16 warp + g (e = 0) and + 8 (e = 1).
  int qpos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) qpos[e] = qs + (p0 + warp * 16 + g + 8 * e) / group;
  float o[DT][4], mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;

  const int kt0 = kbeg & ~(TC_BK - 1);
  if (kt0 < kend) load_kv(kt0, 0);
  cp_async_commit();
  int s = 0;
  for (int kt = kt0; kt < kend; kt += TC_BK, s ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt (and Q) landed; every warp is done with the other stage
    if (kt + TC_BK < kend) load_kv(kt + TC_BK, s ^ 1);
    cp_async_commit();
    const T* tK = sK + (NARROW ? 0 : s * TC_BK * LD);
    const T* tV = sV + (NARROW ? 0 : s * TC_BK * LD);
    if constexpr (NARROW) {
      widen_kv(s);
      __syncthreads();  // the widened tile is whole
    }
    const int mi = lane >> 3;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n8 tiles.
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t b[4];
        ldsm_x4(b, tK + (nb * 16 + (mi >> 1) * 8 + (lane & 7)) * LD + kk * 16 + (mi & 1) * 8);
        mma16816<T>(sc[2 * nb], a, b[0], b[1]);
        mma16816<T>(sc[2 * nb + 1], a, b[2], b[3]);
      }
    }

    // Online softmax in f32; a row's 64 scores lie on the 4 threads of a quad.
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = kt + 8 * j + 2 * t + c;
          const bool ok = kpos < kend && kpos <= qpos[e] && kpos >= k_first &&
                          (!win || kpos > qpos[e] - window);
          const float x = ok ? softcap_score(sc[j][2 * e + c] * scale, softcap) : -INFINITY;
          sc[j][2 * e + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[e], mx);
      // All-masked so far: keep exact zeros (exp(-inf - 0) == 0).
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = __expf(mrow[e] - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = __expf(sc[j][2 * e + c] - m_safe);
          psum += p;
          sc[j][2 * e + c] = p;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      lrow[e] = lrow[e] * alpha + psum;
      mrow[e] = m_new;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        o[i][2 * e] *= alpha;
        o[i][2 * e + 1] *= alpha;
      }
    }

    // O += P V, P rounded to T: the score tiles are the A fragments.
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t a[4] = {pack2<T>(sc[2 * kk][0], sc[2 * kk][1]),
                             pack2<T>(sc[2 * kk][2], sc[2 * kk][3]),
                             pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldsm_x4_trans(b, tV + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD + dn * 16 + (mi >> 1) * 8);
        mma16816<T>(o[2 * dn], a, b[0], b[1]);
        mma16816<T>(o[2 * dn + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = warp * 16 + g + 8 * e;
    if (r >= n_pairs) continue;
    const int p = p0 + r;
    const float inv = lrow[e] > 0.f ? 1.f / lrow[e] : 1.f;
    T* dst = out + row * osb + (p / group) * oss + ((size_t)kvh * group + p % group) * osh + 2 * t;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<typename Pair<T>::type*>(dst + i * 8) =
          Pair<T>::make(o[i][2 * e] * inv, o[i][2 * e + 1] * inv);
  }
}

// Everything a launch needs besides the element type and head_dim.
template <typename Layout>
struct ChunkArgs {
  const void *q, *k, *v;
  void* out;
  const int *q_starts, *lengths, *k_starts;  // [b] int32
  const int* flag;                           // one int32, or NULL = window always on
  Layout layout;
  int b, chunk, n_q, group;
  long long qsb, qss, qsh, osb, oss, osh;    // q / out strides, elements
  int window;                                // <= 0: none
  float scale, softcap;                      // softcap <= 0: none
  cudaStream_t stream;
};

template <typename T, typename KT, int D, typename Layout>
static cudaError_t launch_chunk(const ChunkArgs<Layout>& a) {
  if constexpr (std::is_same_v<T, float>) {
    auto kernel = chunk_kernel<T, KT, D, Layout>;
    const size_t smem = ChunkSmem<T, D>::bytes;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.chunk + CP_BQ - 1) / CP_BQ, a.n_q, a.b);
    kernel<<<grid, CP_THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
        static_cast<T*>(a.out), a.q_starts, a.lengths, a.k_starts, a.flag, a.layout, a.chunk,
        a.group, a.qsb, a.qss, a.qsh, a.osb, a.oss, a.osh, a.window, a.scale, a.softcap);
  } else {
    auto kernel = chunk_kernel_tc<T, KT, D, Layout>;
    const size_t smem = ChunkTcSmem<T, KT, D>::bytes;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const long long pairs = (long long)a.chunk * a.group;
    dim3 grid((unsigned)((pairs + TC_BM - 1) / TC_BM), a.n_q / a.group, a.b);
    kernel<<<grid, TC_THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
        static_cast<T*>(a.out), a.q_starts, a.lengths, a.k_starts, a.flag, a.layout, a.chunk,
        a.group, a.qsb, a.qss, a.qsh, a.osb, a.oss, a.osh, a.window, a.scale, a.softcap);
  }
  return cudaGetLastError();
}

template <typename T, typename KT, typename Layout>
static cudaError_t chunk_by_head_dim(int head_dim, const ChunkArgs<Layout>& a) {
  switch (head_dim) {
    case 64: return launch_chunk<T, KT, 64>(a);
    case 96: return launch_chunk<T, KT, 96>(a);
    case 128: return launch_chunk<T, KT, 128>(a);
    case 256: return launch_chunk<T, KT, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The cache's element type: the activations' (T), or e4m3.
template <typename T, typename Layout>
static cudaError_t chunk_by_kv(int kv_dtype, int head_dim, const ChunkArgs<Layout>& a) {
  if (kv_dtype == kF8) return chunk_by_head_dim<T, f8>(head_dim, a);
  return chunk_by_head_dim<T, T>(head_dim, a);
}

// The C entry points' common tail: validate, then dispatch on the dtype of
// q and out (dtype) and of K/V (kv_dtype: dtype, or kF8).
template <typename Layout>
static int run_chunk(int dtype, int kv_dtype, int head_dim, const ChunkArgs<Layout>& a) {
  if (a.group < 1 || a.n_q % a.group) return (int)cudaErrorInvalidValue;
  if (kv_dtype != dtype && kv_dtype != kF8) return (int)cudaErrorInvalidValue;
  if (a.chunk < 1 || a.b < 1) return (int)cudaSuccess;
  switch (dtype) {
    case kF32: return (int)chunk_by_kv<float>(kv_dtype, head_dim, a);
    case kF16: return (int)chunk_by_kv<__half>(kv_dtype, head_dim, a);
    case kBF16: return (int)chunk_by_kv<__nv_bfloat16>(kv_dtype, head_dim, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cake
