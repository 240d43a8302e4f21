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
// a prefix of the same order, head_dim 128) the work is about 2*head_dim
// FLOPs per (query, key) pair against 4*head_dim bytes per key row, so a
// kernel that streams each K/V row once per query tile is compute-bound;
// the bytes bound (Q, K, V read once, O written once) is lower.
//
// Design: one block per (query tile of 32 rows, query head, batch row),
// 128 threads. The block loops over 64-key tiles from the first key any of
// its rows needs (k_starts and the window) to the last (the causal end and
// lengths): pruning is the loop bound, as the reference's block pruning.
// Q, K and V tiles sit in shared memory (rows padded by 16 bytes against
// bank conflicts); each thread owns a 4x4 block of scores, its 4 rows' online
// softmax state (rows shared by 16 lanes of a half-warp, reduced with
// shuffles) and a 4 x head_dim/16 slice of the output accumulator. The
// products run on the CUDA cores in f32; tensor-core tiles (mma.sync, then
// wgmma with TMA) are the next step.
//
// Dense K and V are addressed through strides with the head_dim axis
// contiguous, so the same kernel reads the head-major cache [b, n_kv,
// max_seq, hd] and the fresh seq-major projections [b, seq, n_kv, hd] of the
// position-0 prefill without a copy. Paged K/V resolve each key row of a
// tile through the block table (a 128-slot page is two 64-key tiles; a tile
// that starts mid-page straddles two pages, row by row).
#pragma once

#include "common.cuh"
#include "kv_layout.cuh"

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

template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(CP_THREADS)
chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
  for (int kt = kbeg; kt < kend; kt += CP_BK) {
    __syncthreads();  // the previous tile's readers are done (and Q is loaded)
    for (int idx = tid; idx < CP_BK * ROWV; idx += CP_THREADS) {
      const int r = idx / ROWV;
      const int c = (idx % ROWV) * VEC;
      const int j = kt + r;
      if (j < kend) {
        copy16(sK + r * LD + c, k + cur.template k<D>(j) + c);
        copy16(sV + r * LD + c, v + cur.template v<D>(j) + c);
      } else {
        zero16(sK + r * LD + c);
        zero16(sV + r * LD + c);
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

    const int nk = min(CP_BK, kend - kt);
    for (int j = 0; j < nk; ++j) {
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

template <typename T, int D, typename Layout>
static cudaError_t launch_chunk(const ChunkArgs<Layout>& a) {
  auto kernel = chunk_kernel<T, D, Layout>;
  const size_t smem = ChunkSmem<T, D>::bytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.chunk + CP_BQ - 1) / CP_BQ, a.n_q, a.b);
  kernel<<<grid, CP_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.q_starts, a.lengths, a.k_starts, a.flag, a.layout, a.chunk,
      a.group, a.qsb, a.qss, a.qsh, a.osb, a.oss, a.osh, a.window, a.scale, a.softcap);
  return cudaGetLastError();
}

template <typename T, typename Layout>
static cudaError_t chunk_by_head_dim(int head_dim, const ChunkArgs<Layout>& a) {
  switch (head_dim) {
    case 64: return launch_chunk<T, 64>(a);
    case 128: return launch_chunk<T, 128>(a);
    case 256: return launch_chunk<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The C entry points' common tail: validate, then dispatch on the dtype.
template <typename Layout>
static int run_chunk(int dtype, int head_dim, const ChunkArgs<Layout>& a) {
  if (a.group < 1 || a.n_q % a.group) return (int)cudaErrorInvalidValue;
  if (a.chunk < 1 || a.b < 1) return (int)cudaSuccess;
  switch (dtype) {
    case kF32: return (int)chunk_by_head_dim<float>(head_dim, a);
    case kF16: return (int)chunk_by_head_dim<__half>(head_dim, a);
    case kBF16: return (int)chunk_by_head_dim<__nv_bfloat16>(head_dim, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cake
