// One-query GQA attention (decode), shared by the dense and the paged cache.
//
// The kernel body of decode_attention.cu (dense head-major cache) and
// paged_decode_attention.cu (page pool through a block table). The two differ
// only in how a key slot j of (row, KV head) becomes an address, which a
// Layout type supplies (kv_layout.cuh). Everything else,
// including which warp reads which key slot, is this one body, so the paged
// kernel gives the dense kernel's bits on the same keys.
//
// Function: per batch row, the query heads of one KV-head group attend keys
// [start, length) with an f32 online softmax, optional score scale and tanh
// soft-cap; p is rounded to the cache dtype before p@v as in the reference.
//
// Bound on the H100: device-memory bytes. Each live K/V row is read once and
// used for `group` queries (4 for Llama-3-8B), about 1 FLOP per byte, far
// below the ~295 FLOP/byte where bf16 tensor cores would start to matter.
//
// Design against that bound:
//   * one block per (kv_head, row) holds all `group` query heads of the
//     group, so every K/V byte is read from device memory exactly once;
//   * the block walks only [start, length): pruning is the loop bound, the
//     dead tail and the window-folded head are never read;
//   * 8 warps stride over the live keys, TK keys per warp step (8 for
//     head_dim <= 128), each lane holding head_dim/32 contiguous elements
//     (8-byte loads at head_dim 128 in bf16, neighbouring lanes on
//     neighbouring addresses), so 2*TK independent loads are in flight per
//     lane; each warp keeps its own running (max, sum, acc) and the warps
//     merge once at the end through shared memory;
//   * the group size is a template parameter G (the group rounded up to 1,
//     2, 4 or 8; padded query heads are zeros and never written), so the
//     per-step warp reductions are straight-line shuffles with no branches.
// Known limit: at small batch the grid is b * n_kv blocks on 132 SMs, so a
// long cache streams through a small part of the card and the kernel is
// bound by load latency, not bandwidth. Splitting the key range over more
// blocks (flash-decoding) is the next step.
#pragma once

#include "common.cuh"
#include "kv_layout.cuh"

namespace cake {

constexpr int DEC_WARPS = 8;
constexpr int DEC_MAXG = 8;  // largest GQA group (query heads per KV head)

template <typename T, int D, int G, typename Layout>
__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, const int* __restrict__ lengths,
              const int* __restrict__ starts, Layout layout, int n_kv, int group, float scale,
              float softcap) {
  constexpr int N = D / 32;            // elements per lane
  constexpr int TK = N <= 4 ? 8 : 4;   // keys per warp step
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_q = n_kv * group;
  const int length = min(lengths[row], layout.limit());
  const int start = max(starts[row], 0);

  float qr[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      load_vec<T, N>(q + ((size_t)row * n_q + kvh * group + g) * D + lane * N, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) qr[g][i] = 0.f;
    }
  }

  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }

  const auto cur = layout.cursor(row, kvh);
  const T* kl = k + (size_t)lane * N;
  const T* vl = v + (size_t)lane * N;

  for (int j0 = start + warp * TK; j0 < length; j0 += DEC_WARPS * TK) {
    float kr[TK][N], vr[TK][N];
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      if (j0 + t < length) {
        load_vec<T, N>(kl + cur.template k<D>(j0 + t), kr[t]);
        load_vec<T, N>(vl + cur.template v<D>(j0 + t), vr[t]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) kr[t][i] = vr[t][i] = 0.f;
      }
    }
    float s[TK][G];
#pragma unroll
    for (int t = 0; t < TK; ++t) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) a = fmaf(qr[g][i], kr[t][i], a);
        s[t][g] = a;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < TK; ++t) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[t][g] += __shfl_xor_sync(0xffffffffu, s[t][g], off);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const float x = softcap_score(s[t][g] * scale, softcap);
        s[t][g] = (j0 + t < length) ? x : -INFINITY;
        tmax = fmaxf(tmax, s[t][g]);
      }
      // Key j0 is live, so tmax and m_new are finite.
      const float m_new = fmaxf(m[g], tmax);
      const float alpha = __expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const float p = __expf(s[t][g] - m_new);
        psum += p;
        const float pr = round_to<T>(p);
#pragma unroll
        for (int i = 0; i < N; ++i) acc[g][i] = fmaf(pr, vr[t][i], acc[g][i]);
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
    }
  }

  // Merge the warps' partial softmax states.
  float* s_acc = smem;                      // [DEC_WARPS][G][D]
  float* s_m = smem + DEC_WARPS * G * D;    // [DEC_WARPS][G]
  float* s_l = s_m + DEC_WARPS * G;         // [DEC_WARPS][G]
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
  for (int idx = threadIdx.x; idx < group * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, s_m[w * G + g]);
    // An empty [start, length) leaves every warp at -inf: the row is 0.
    const float ms = (mx == -INFINITY) ? 0.f : mx;
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float c = __expf(s_m[w * G + g] - ms);
      lsum += s_l[w * G + g] * c;
      a += s_acc[(w * G + g) * D + d] * c;
    }
    out[((size_t)row * n_q + kvh * group + g) * D + d] = from_f<T>(lsum > 0.f ? a / lsum : 0.f);
  }
}

// Everything a launch needs besides the element type, head_dim and group.
template <typename Layout>
struct DecodeArgs {
  const void *q, *k, *v;
  void* out;
  const int *lengths, *starts;  // [b] int32, window already folded into starts
  Layout layout;
  int b, n_kv, group;
  float scale, softcap;         // softcap <= 0: none
  cudaStream_t stream;
};

template <typename T, int D, int G, typename Layout>
static cudaError_t launch_decode(const DecodeArgs<Layout>& a) {
  auto kernel = decode_kernel<T, D, G, Layout>;
  const size_t smem = (size_t)DEC_WARPS * G * (D + 2) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_kv, a.b);
  kernel<<<grid, DEC_WARPS * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.lengths, a.starts, a.layout, a.n_kv, a.group, a.scale,
      a.softcap);
  return cudaGetLastError();
}

template <typename T, int D, typename Layout>
static cudaError_t decode_by_group(const DecodeArgs<Layout>& a) {
  if (a.group <= 1) return launch_decode<T, D, 1>(a);
  if (a.group <= 2) return launch_decode<T, D, 2>(a);
  if (a.group <= 4) return launch_decode<T, D, 4>(a);
  return launch_decode<T, D, DEC_MAXG>(a);
}

template <typename T, typename Layout>
static cudaError_t decode_by_head_dim(int head_dim, const DecodeArgs<Layout>& a) {
  switch (head_dim) {
    case 64: return decode_by_group<T, 64>(a);
    case 128: return decode_by_group<T, 128>(a);
    case 256: return decode_by_group<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The C entry points' common tail: validate, then dispatch on the dtype.
template <typename Layout>
static int run_decode(int dtype, int head_dim, const DecodeArgs<Layout>& a) {
  if (a.group < 1 || a.group > DEC_MAXG) return (int)cudaErrorInvalidValue;
  if (a.b < 1) return (int)cudaSuccess;
  switch (dtype) {
    case kF32: return (int)decode_by_head_dim<float>(head_dim, a);
    case kF16: return (int)decode_by_head_dim<__half>(head_dim, a);
    case kBF16: return (int)decode_by_head_dim<__nv_bfloat16>(head_dim, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cake
