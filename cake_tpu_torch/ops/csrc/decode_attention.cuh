// One-query GQA attention (decode), shared by the dense and the paged cache:
// flash-decoding for Hopper, key splits over the whole card with an ordered
// combine.
//
// The kernel body of decode_attention.cu (dense head-major cache) and
// paged_decode_attention.cu (page pool through a block table). The two differ
// only in how a key slot becomes an address, which a Layout type supplies
// (kv_layout.cuh). Everything else, including which warp reads which key slot
// and the order in which partial results are merged, is this one body, so the
// paged kernel gives the dense kernel's bits on the same keys.
//
// Function: per batch row, the query heads of one KV-head group attend keys
// [start, length) with an f32 online softmax, optional score scale and tanh
// soft-cap; p is rounded to the cache dtype before p@v as in the reference.
// An empty [start, length) writes zeros.
//
// Bound on the H100: device-memory bytes. Each live K/V row is read once and
// used for `group` queries (4 for Llama-3-8B), about 1 FLOP per byte, far
// below the ~295 FLOP/byte where bf16 tensor cores would start to matter. To
// stream at the card's rate the reads must be spread over the whole card.
//
// Design against that bound:
//   * a row's live range is cut at multiples of DEC_SPLIT key positions. The
//     split points depend on nothing but positions: not on the batch, the
//     cache width, the grid or the other rows, so a row's bits are the same
//     whatever shares the call. DEC_SPLIT divides 128 and every page size the
//     paged kernels take is a multiple of 128, so a split never straddles a
//     page: a block looks its page up once and reads the split's keys at
//     immediate offsets D elements apart from one base (Cursor::split);
//   * the grid is (n_kv * passes, b, z), z fixed by the host from the shapes
//     alone (ops/decode_attention.plan), never from `lengths`, so a CUDA
//     graph can replay it. A block works out its row's live splits on the
//     device and grid-strides over them; blocks past the live splits exit at
//     once. A GQA group larger than a block takes (16 query heads at
//     head_dim <= 128, 8 at 256) is cut into `passes` blocks of at most
//     `heads` query heads each, every one reading the KV head's keys: a
//     (KV head, pass) is a unit of its own, with its own partials and ticket;
//   * inside a split, 8 warps take the keys by absolute position, TK keys a
//     warp step (8 for head_dim <= 128 and groups up to 8, 2 for the
//     16-head tiles), each lane holding head_dim/32 contiguous elements
//     (3 at head_dim 96, loaded one by one), so 2*TK independent loads are
//     in flight per lane;
//     each warp keeps its own running (max, sum, acc) and the warps merge in
//     warp order through shared memory;
//   * each live split writes its own partial (per query head of the group:
//     max m, sum l and acc[D], f32) to scratch; a block that takes several
//     splits never merges them itself, so the bits do not depend on z. The
//     block that finishes a (row, KV head) last, by an atomic ticket taken
//     after a __threadfence(), merges the partials in ascending split order
//     and resets the ticket for the next call. A row with one live split
//     writes its output directly (the combine of one split, exp(m - m) = 1);
//   * the heads a block takes are a template parameter G (rounded up to 1,
//     2, 4, 8 or 16; padded query heads are zeros and never written), so the
//     per-step warp reductions are straight-line shuffles with no branches.
// An f8 (e4m3) cache is the same body with KT = f8: a lane loads its
// head_dim/32 elements narrow (4 bytes at head_dim 128, half the bf16 load)
// and widens them in registers (cvt.rn.f16x2.e4m3x2, exact), so which lane
// and warp read which key, the split points, the grid (plan() takes no
// dtype: f8 leaves the split length at DEC_SPLIT) and the merge order stay
// the bf16 kernel's, and over the f8 values widened to T the two give the
// same bits. The products stay in f32 on the widened values and p is
// rounded to T, as the reference widens f8 K/V to q's dtype before its dots.
// The tickets assume one launch at a time on them: the port's callers run
// the decode kernels on one stream.
#pragma once

#include "common.cuh"
#include "kv_layout.cuh"

#include <type_traits>

namespace cake {

constexpr int DEC_WARPS = 8;
// Most query heads a block takes: the register tiles of 16 heads fit at
// head_dim <= 128 (ops/decode_attention.max_heads holds the same rule).
template <int D>
constexpr int DEC_MAX_HEADS = D <= 128 ? 16 : 8;
constexpr int DEC_SPLIT = 128;  // keys a split (a page); 32 and 64 measured slower (PERF.md)
static_assert(128 % DEC_SPLIT == 0, "a split must never straddle a page");

// Groups up to G * head_dim = 512 (Llama-3-8B's 4 x 128) keep their register
// tiles in 128 registers a thread: 16 warps an SM.
constexpr int DEC_SMALL_BLOCKS = DEC_WARPS < 16 ? 16 / DEC_WARPS : 1;

template <typename T, typename KT, int D, int G, typename Layout>
__global__ void __launch_bounds__(DEC_WARPS * 32, G * D <= 512 ? DEC_SMALL_BLOCKS : 1)
split_decode_kernel(const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
                    T* __restrict__ out, const int* __restrict__ lengths,
                    const int* __restrict__ starts, Layout layout, int n_kv, int group,
                    int heads, float scale, float softcap, float* __restrict__ part,
                    int* __restrict__ tickets, int n_split) {
  constexpr int N = D / 32;            // elements per lane
  constexpr int TK = G > 8 ? 2 : (N <= 4 ? 8 : 4);   // keys per warp step
  constexpr int STEPS = (DEC_SPLIT + DEC_WARPS * TK - 1) / (DEC_WARPS * TK);  // warp steps a split
  // The 16-head tile's step is ~600 instructions: unrolled 8 times it cost
  // the build more than every other tile of its unit together.
  constexpr int UNROLL = G > 8 ? 1 : STEPS;
  extern __shared__ float smem[];
  __shared__ int s_last;
  // The unit (KV head, pass): query heads [h0, h0 + gc) of the group. Only
  // the largest tile takes a group in passes (plan(): more than half its
  // heads a pass); below it a unit is a KV head and every bound a kernel
  // parameter, which keeps those tiles' registers as they were.
  constexpr bool PASSES = G == DEC_MAX_HEADS<D>;
  const int passes = PASSES ? (group + heads - 1) / heads : 1;
  const int unit = blockIdx.x;
  const int units = PASSES ? (int)gridDim.x : n_kv;
  const int kvh = PASSES ? unit / passes : unit;
  const int h0 = PASSES ? (unit % passes) * heads : 0;
  const int gc = PASSES ? min(heads, group - h0) : group;  // heads of this unit
  const int hs = PASSES ? heads : group;                   // a split's partial stride, heads
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_q = n_kv * group;
  const int length = min(lengths[row], layout.limit());
  const int start = max(starts[row], 0);
  T* out_row = out + ((size_t)row * n_q + kvh * group + h0) * D;

  if (start >= length) {
    if (blockIdx.z == 0) {
      for (int idx = threadIdx.x; idx < gc * D; idx += blockDim.x) out_row[idx] = from_f<T>(0.f);
    }
    return;
  }
  const int s_lo = start / DEC_SPLIT;
  const int s_hi = (length - 1) / DEC_SPLIT;
  const int n_live = s_hi - s_lo + 1;
  if (s_lo + (int)blockIdx.z > s_hi) return;

  float qr[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < gc) {
      load_vec<T, N>(q + ((size_t)row * n_q + kvh * group + h0 + g) * D + lane * N, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) qr[g][i] = 0.f;
    }
  }

  const auto cur = layout.cursor(row, kvh);
  // Partials: acc [b, units, n_split, heads, D], then (m, l) [b, units, n_split, heads, 2].
  const size_t rk = ((size_t)row * units + unit) * n_split;
  float* acc_rk = part + rk * hs * D;
  float* ml_rk = part + (size_t)gridDim.y * units * n_split * hs * D + rk * hs * 2;
  float* s_acc = smem;                      // [DEC_WARPS][G][D]
  float* s_m = smem + DEC_WARPS * G * D;    // [DEC_WARPS][G]
  float* s_l = s_m + DEC_WARPS * G;         // [DEC_WARPS][G]
  int done = 0;

  for (int s = s_lo + blockIdx.z; s <= s_hi; s += gridDim.z, ++done) {
    float m[G], l[G], acc[G][N];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
    }
    const int s0 = s * DEC_SPLIT;
    const size_t base = cur.template split<D>(s0) + (size_t)lane * N;

#pragma unroll (UNROLL)
    for (int it = 0; it < STEPS; ++it) {
      const int r0 = warp * TK + it * DEC_WARPS * TK;  // the step's first key in the split
      const int j0 = s0 + r0;
      // Past the split, or the step's keys [j0, j0 + TK) miss [start, length).
      if (r0 >= DEC_SPLIT || j0 + TK <= start || j0 >= length) continue;
      float kr[TK][N], vr[TK][N];
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        if (j0 + t >= start && j0 + t < length) {
          load_vec<KT, N>(k + base + (size_t)(r0 + t) * D, kr[t]);
          load_vec<KT, N>(v + base + (size_t)(r0 + t) * D, vr[t]);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) kr[t][i] = vr[t][i] = 0.f;
        }
      }
      float sc[TK][G];
#pragma unroll
      for (int t = 0; t < TK; ++t) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i) a = fmaf(qr[g][i], kr[t][i], a);
          sc[t][g] = a;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int t = 0; t < TK; ++t) {
#pragma unroll
          for (int g = 0; g < G; ++g) sc[t][g] += __shfl_xor_sync(0xffffffffu, sc[t][g], off);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float tmax = -INFINITY;
#pragma unroll
        for (int t = 0; t < TK; ++t) {
          const float x = softcap_score(sc[t][g] * scale, softcap);
          sc[t][g] = (j0 + t >= start && j0 + t < length) ? x : -INFINITY;
          tmax = fmaxf(tmax, sc[t][g]);
        }
        // The step holds a live key, so tmax and m_new are finite.
        const float m_new = fmaxf(m[g], tmax);
        const float alpha = __expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int t = 0; t < TK; ++t) {
          const float p = __expf(sc[t][g] - m_new);
          psum += p;
          const float pr = round_to<T>(p);
#pragma unroll
          for (int i = 0; i < N; ++i) acc[g][i] = fmaf(pr, vr[t][i], acc[g][i]);
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
      }
    }

    // Merge the warps' states in warp order (a warp with no live key holds
    // m = -inf, l = 0, acc = 0 and adds nothing).
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < N; ++i) s_acc[(warp * G + g) * D + lane * N + i] = acc[g][i];
      if (lane == 0) {
        s_m[warp * G + g] = m[g];
        s_l[warp * G + g] = l[g];
      }
    }
    __syncthreads();
    float* acc_s = acc_rk + (size_t)s * hs * D;
    float* ml_s = ml_rk + (size_t)s * hs * 2;
    for (int idx = threadIdx.x; idx < gc * D; idx += blockDim.x) {
      const int g = idx / D;
      const int d = idx % D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, s_m[w * G + g]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float c = __expf(s_m[w * G + g] - mx);
        lsum += s_l[w * G + g] * c;
        a += s_acc[(w * G + g) * D + d] * c;
      }
      if (n_live == 1) {
        out_row[idx] = from_f<T>(a / lsum);
      } else {
        acc_s[idx] = a;
        if (d == 0) {
          ml_s[2 * g] = mx;
          ml_s[2 * g + 1] = lsum;
        }
      }
    }
    __syncthreads();  // shared memory is reused by the next split
  }
  if (n_live == 1) return;

  // Take a ticket; the block that brings the count to n_live merges.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = tickets + (size_t)row * units + unit;
    const int before = atomicAdd(ticket, done);
    s_last = before + done == n_live;
    if (s_last) *ticket = 0;  // every block of (row, kvh) has counted: ready for the next call
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The ordered combine of every live split's partial. Stage the splits'
  // (m, l) in shared memory, weight each split by c = exp(m - max m), then
  // sum l * c and acc * c in ascending split order.
  float* c_w = smem;                   // [n_live][G] weights c
  float* c_l = smem + n_live * G;      // [n_live][G] sums l
  float* c_sum = c_l + n_live * G;     // [G] sum of l * c
  const float* ml_lo = ml_rk + (size_t)s_lo * hs * 2;
  for (int i = threadIdx.x; i < n_live * gc; i += blockDim.x) {
    const int sp = i / gc, g = i % gc;
    c_w[sp * G + g] = __ldcg(ml_lo + 2 * (sp * hs + g));
    c_l[sp * G + g] = __ldcg(ml_lo + 2 * (sp * hs + g) + 1);
  }
  __syncthreads();
  for (int g = warp; g < gc; g += DEC_WARPS) {  // warp w: query heads w, w + 8
    float mx = -INFINITY;
    for (int sp = lane; sp < n_live; sp += 32) mx = fmaxf(mx, c_w[sp * G + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    for (int sp = lane; sp < n_live; sp += 32) c_w[sp * G + g] = __expf(c_w[sp * G + g] - mx);
    __syncwarp();
    if (lane == 0) {
      float lsum = 0.f;
      for (int sp = 0; sp < n_live; ++sp) lsum += c_l[sp * G + g] * c_w[sp * G + g];
      c_sum[g] = lsum;
    }
  }
  __syncthreads();
  // Four consecutive elements a thread (16-byte loads; D is a multiple of 32).
  const float* acc_lo = acc_rk + (size_t)s_lo * hs * D;
  for (int idx = threadIdx.x * 4; idx < gc * D; idx += blockDim.x * 4) {
    const int g = idx / D;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int sp = 0; sp < n_live; ++sp) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(acc_lo + (size_t)sp * hs * D + idx));
      const float c = c_w[sp * G + g];
      a[0] += x.x * c;
      a[1] += x.y * c;
      a[2] += x.z * c;
      a[3] += x.w * c;
    }
    const float lsum = c_sum[g];
#pragma unroll
    for (int i = 0; i < 4; ++i) out_row[idx + i] = from_f<T>(a[i] / lsum);
  }
}

// Dynamic shared memory of a launch: the warps' merge, or the combine's
// (m, l) staging of up to n_split splits, whichever is larger.
template <int D, int G>
static size_t decode_smem(int n_split) {
  const size_t merge = (size_t)DEC_WARPS * G * (D + 2);
  const size_t combine = (size_t)2 * n_split * G + G;
  return (merge > combine ? merge : combine) * sizeof(float);
}

// Everything a launch needs besides the element type, head_dim and group.
template <typename Layout>
struct DecodeArgs {
  const void *q, *k, *v;
  void* out;
  const int *lengths, *starts;  // [b] int32, window already folded into starts
  Layout layout;
  int b, n_kv, group;
  int heads;                    // query heads a block: a group past it takes several passes
  float scale, softcap;         // softcap <= 0: none
  float* part;                  // f32 partials: acc [b, units, n_split, heads, D], (m, l) [.., 2]
  int* tickets;                 // [b, units] int32, zero between calls (units: n_kv * passes)
  int n_split, z;               // split slots a row has; the grid's third dimension
  cudaStream_t stream;
};

template <typename T, typename KT, int D, int G, typename Layout>
static cudaError_t launch_decode(const DecodeArgs<Layout>& a) {
  auto kernel = split_decode_kernel<T, KT, D, G, Layout>;
  const size_t smem = decode_smem<D, G>(a.n_split);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int passes = (a.group + a.heads - 1) / a.heads;
  dim3 grid(a.n_kv * passes, a.b, a.z);
  kernel<<<grid, DEC_WARPS * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
      static_cast<T*>(a.out), a.lengths, a.starts, a.layout, a.n_kv, a.group, a.heads, a.scale,
      a.softcap, a.part, a.tickets, a.n_split);
  return cudaGetLastError();
}

template <typename T, typename KT, int D, typename Layout>
static cudaError_t decode_by_group(const DecodeArgs<Layout>& a) {
  if (a.heads < 1 || a.heads > DEC_MAX_HEADS<D>) return cudaErrorInvalidValue;
  // A group in passes takes the largest tile (its heads a pass are more
  // than half of it); the smaller tiles read the group from the parameters.
  if (a.heads < a.group && 2 * a.heads <= DEC_MAX_HEADS<D>) return cudaErrorInvalidValue;
  if (a.heads <= 1) return launch_decode<T, KT, D, 1>(a);
  if (a.heads <= 2) return launch_decode<T, KT, D, 2>(a);
  if (a.heads <= 4) return launch_decode<T, KT, D, 4>(a);
  if constexpr (DEC_MAX_HEADS<D> > 8) {
    if (a.heads > 8) return launch_decode<T, KT, D, 16>(a);
  }
  return launch_decode<T, KT, D, 8>(a);
}

// Head dims 64 and 96 ("narrow", in the units with the C entry points and
// the f8 ones) or 128 and 256 ("wide", in units of their own): the decode
// bodies were the build's tail, so they spread over twice the units.
template <typename T, typename KT, bool WIDE, typename Layout>
static cudaError_t decode_by_head_dim(int head_dim, const DecodeArgs<Layout>& a) {
  if constexpr (WIDE) {
    if (head_dim == 128) return decode_by_group<T, KT, 128>(a);
    if (head_dim == 256) return decode_by_group<T, KT, 256>(a);
  } else {
    if (head_dim == 64) return decode_by_group<T, KT, 64>(a);
    if (head_dim == 96) return decode_by_group<T, KT, 96>(a);
  }
  return cudaErrorInvalidValue;
}

// The kernels over a cache of element type KT (T: the activations' dtype).
template <typename KT, bool WIDE, typename Layout>
static cudaError_t decode_by_dtype(int dtype, int head_dim, const DecodeArgs<Layout>& a) {
  constexpr bool same = std::is_same_v<KT, void>;  // void: the cache in T
  switch (dtype) {
    case kF32:
      return decode_by_head_dim<float, std::conditional_t<same, float, KT>, WIDE>(head_dim, a);
    case kF16:
      return decode_by_head_dim<__half, std::conditional_t<same, __half, KT>, WIDE>(head_dim, a);
    case kBF16:
      return decode_by_head_dim<__nv_bfloat16, std::conditional_t<same, __nv_bfloat16, KT>,
                                WIDE>(head_dim, a);
    default: return cudaErrorInvalidValue;
  }
}

// The instantiations in translation units of their own, so that they
// compile in parallel with the rest: the wide head dims
// (decode_attention_wide.cu, paged_decode_attention_wide.cu) and the e4m3
// caches, narrow and wide (decode_attention_f8.cu, ..._f8_wide.cu and
// their paged twins); the rolling ring's the same four
// (ring_decode_attention*.cu).
cudaError_t decode_wide(int dtype, int head_dim, const DecodeArgs<DenseLayout>& a);
cudaError_t decode_wide(int dtype, int head_dim, const DecodeArgs<PagedLayout>& a);
cudaError_t decode_f8(int dtype, int head_dim, const DecodeArgs<DenseLayout>& a);
cudaError_t decode_f8(int dtype, int head_dim, const DecodeArgs<PagedLayout>& a);
cudaError_t decode_f8_wide(int dtype, int head_dim, const DecodeArgs<DenseLayout>& a);
cudaError_t decode_f8_wide(int dtype, int head_dim, const DecodeArgs<PagedLayout>& a);
// The rolling ring (ring_decode_attention*.cu).
cudaError_t decode_wide(int dtype, int head_dim, const DecodeArgs<RingLayout>& a);
cudaError_t decode_f8(int dtype, int head_dim, const DecodeArgs<RingLayout>& a);
cudaError_t decode_f8_wide(int dtype, int head_dim, const DecodeArgs<RingLayout>& a);

// The C entry points' common tail: validate, then dispatch on the dtype of
// q and out (dtype) and of the cache (kv_dtype: dtype, or kF8).
// `limit` is the layout's slot count; the scratch must hold n_split splits.
template <typename Layout>
static int run_decode(int dtype, int kv_dtype, int head_dim, int limit,
                      const DecodeArgs<Layout>& a) {
  if (a.group < 1 || a.heads < 1 || a.heads > a.group) return (int)cudaErrorInvalidValue;
  if (kv_dtype != dtype && kv_dtype != kF8) return (int)cudaErrorInvalidValue;
  if (a.b < 1) return (int)cudaSuccess;
  if ((long long)a.n_split * DEC_SPLIT < limit || a.z < 1 || a.z > 65535)
    return (int)cudaErrorInvalidValue;
  const bool wide = head_dim == 128 || head_dim == 256;
  if (kv_dtype == kF8)
    return (int)(wide ? decode_f8_wide(dtype, head_dim, a) : decode_f8(dtype, head_dim, a));
  return (int)(wide ? decode_wide(dtype, head_dim, a)
                    : decode_by_dtype<void, false>(dtype, head_dim, a));
}

}  // namespace cake
