// Fused sampling tail: repeat penalty + temperature + top-k threshold +
// gumbel-argmax, one pass of passes over each row's logits.
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/fused_sample_tail.py
// (fused_sample_tail). Bound on the H100: the bytes of the logits (and of
// the noise when sampled). Design (see ops/fused_sample_tail.py): one block
// per row; the ring becomes a V-bit bitmap in shared memory; the top-k
// threshold is a radix select over the order-preserving uint32 key of each
// scaled value (four 8-bit passes, per-warp shared histograms), exact with
// duplicates; the argmax takes the lowest index among equal maxima and NaN
// as the maximum, as torch.argmax does.
#include "common.cuh"

namespace cake {

constexpr int ST_THREADS = 1024;
constexpr int ST_WARPS = ST_THREADS / 32;

// torch's CUDA division of a tensor by a Python scalar multiplies by the
// scalar's reciprocal (div_true_kernel_cuda); the wrapper computes the
// reciprocals as torch does and the kernel repeats the products.
struct TailArgs {
  float pen, inv_pen, inv_temp;
};

// Order-preserving key of an f32 (NaN canonical, above every number: the
// key torch's radix top-k uses).
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t b = __float_as_uint(f);
  if (f != f) return 0xffffffffu;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Is (a, ia) ahead of (b, ib) in torch.argmax's order: NaN first, then the
// larger value, then the lower index.
__device__ __forceinline__ bool ahead(float a, int ia, float b, int ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && bn ? ia < ib : an;
  if (a != b) return a > b;
  return ia < ib;
}

template <bool PEN, bool SAMPLED>
__device__ __forceinline__ float scaled_at(const float* __restrict__ lrow,
                                           const uint32_t* __restrict__ seen, int v,
                                           const TailArgs& a) {
  float x = lrow[v];
  if (PEN && ((seen[v >> 5] >> (v & 31)) & 1u)) {
    x = x > 0.f ? __fmul_rn(x, a.inv_pen) : __fmul_rn(x, a.pen);
  }
  if (SAMPLED) x = __fmul_rn(x, a.inv_temp);
  return x;
}

template <bool PEN, bool SAMPLED, bool TOPK>
__global__ void __launch_bounds__(ST_THREADS)
tail_kernel(const float* __restrict__ logits, const long long* __restrict__ ring,
            const float* __restrict__ noise, long long* __restrict__ out, int V, int W,
            TailArgs args, int top_k) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* seen = smem;                                    // [ceil(V / 32)] when PEN
  uint32_t* hist = smem + (PEN ? (V + 31) / 32 : 0);        // [ST_WARPS][256] when TOPK
  __shared__ float best_v[ST_WARPS];
  __shared__ int best_i[ST_WARPS];
  __shared__ uint32_t sel_digit;
  __shared__ int sel_rank;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* lrow = logits + (size_t)b * V;

  if (PEN) {
    for (int i = tid; i < (V + 31) / 32; i += ST_THREADS) seen[i] = 0u;
    __syncthreads();
    for (int i = tid; i < W; i += ST_THREADS) {
      const long long tok = ring[(size_t)b * W + i];
      if (tok >= 0 && tok < V) atomicOr(&seen[tok >> 5], 1u << (tok & 31));
    }
    __syncthreads();
  }

  // The k-th largest scaled value counting duplicates: radix select from
  // the top byte down; `rank` is the k-th's rank among keys with `prefix`.
  float thresh = 0.f;
  if (TOPK) {
    uint32_t prefix = 0u, mask = 0u;
    int rank = top_k;
    uint32_t* my_hist = hist + warp * 256;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = tid; i < ST_WARPS * 256; i += ST_THREADS) hist[i] = 0u;
      __syncthreads();
#pragma unroll 4
      for (int v = tid; v < V; v += ST_THREADS) {
        const uint32_t k = order_key(scaled_at<PEN, true>(lrow, seen, v, args));
        if ((k & mask) == prefix) atomicAdd(&my_hist[(k >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (warp == 0) {
        // Digit d's count, summed over the warps; then, from the top digit
        // down, the first digit whose running count reaches `rank`.
        uint32_t cnt[8];
        uint32_t mine = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = 255 - (lane * 8 + j);
          uint32_t s = 0u;
          for (int wi = 0; wi < ST_WARPS; ++wi) s += hist[wi * 256 + d];
          cnt[j] = s;
          mine += s;
        }
        // Exclusive prefix of `mine` over the lanes (digits above this lane's).
        uint32_t incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        uint32_t run = incl - mine;
        const bool here = run < (uint32_t)rank && incl >= (uint32_t)rank;
        if (here) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (run + cnt[j] >= (uint32_t)rank) {
              sel_digit = 255u - (uint32_t)(lane * 8 + j);
              sel_rank = rank - (int)run;
              break;
            }
            run += cnt[j];
          }
        }
      }
      __syncthreads();
      prefix |= sel_digit << shift;
      mask |= 255u << shift;
      rank = sel_rank;
      __syncthreads();
    }
    thresh = key_value(prefix);
  }

  // Argmax of the scaled row (greedy) or of scaled + noise with the top-k
  // mask (sampled).
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  const float* nrow = SAMPLED ? noise + (size_t)b * V : nullptr;
#pragma unroll 4
  for (int v = tid; v < V; v += ST_THREADS) {
    const float s = scaled_at<PEN, SAMPLED>(lrow, seen, v, args);
    float val = s;
    if (SAMPLED) val = (TOPK && s < thresh) ? -INFINITY : __fadd_rn(s, nrow[v]);
    if (ahead(val, v, bv, bi)) {
      bv = val;
      bi = v;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ahead(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    best_v[warp] = bv;
    best_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = best_v[lane];
    bi = best_i[lane];
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ahead(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) out[b] = bi;
  }
}

template <bool PEN, bool SAMPLED, bool TOPK>
static cudaError_t launch_tail(const void* logits, const void* ring, const void* noise, void* out,
                               int b, int V, int W, const TailArgs& a, int top_k,
                               cudaStream_t stream) {
  auto kernel = tail_kernel<PEN, SAMPLED, TOPK>;
  const size_t smem = (PEN ? (size_t)((V + 31) / 32) * 4 : 0) +
                      (TOPK ? (size_t)ST_WARPS * 256 * 4 : 0);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<b, ST_THREADS, smem, stream>>>(
      static_cast<const float*>(logits), static_cast<const long long*>(ring),
      static_cast<const float*>(noise), static_cast<long long*>(out), V, W, a, top_k);
  return cudaGetLastError();
}

template <bool PEN>
static cudaError_t tail_by_mode(const void* logits, const void* ring, const void* noise,
                                void* out, int b, int V, int W, const TailArgs& a, int top_k,
                                cudaStream_t stream) {
  if (noise == nullptr) return launch_tail<PEN, false, false>(logits, ring, noise, out, b, V, W, a, 0, stream);
  if (top_k > 0) return launch_tail<PEN, true, true>(logits, ring, noise, out, b, V, W, a, top_k, stream);
  return launch_tail<PEN, true, false>(logits, ring, noise, out, b, V, W, a, 0, stream);
}

}  // namespace cake

// logits: [b, V] f32; ring: [b, W] int64 recent ids (-1 = empty); noise:
// [b, V] f32 gumbel rows, or NULL for greedy (argmax of the penalized
// logits). penalize != 0 applies the repeat penalty over the ring: positive
// logits times inv_penalty, the others times penalty; a sampled step then
// multiplies by inv_temperature. top_k > 0 masks below the k-th largest
// scaled value (1 <= top_k <= V). out: [b] int64 ids. All contiguous.
// Returns the launch's error.
extern "C" int cake_fused_sample_tail(const void* logits, const void* ring, const void* noise,
                                      void* out, int b, int V, int W, int penalize,
                                      float penalty, float inv_penalty, float inv_temperature,
                                      int top_k, void* stream) {
  using namespace cake;
  if (b < 1) return (int)cudaSuccess;
  if (V < 1 || W < 0 || top_k > V) return (int)cudaErrorInvalidValue;
  TailArgs a{penalty, inv_penalty, inv_temperature};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (penalize && W > 0) return (int)tail_by_mode<true>(logits, ring, noise, out, b, V, W, a, top_k, s);
  return (int)tail_by_mode<false>(logits, ring, noise, out, b, V, W, a, top_k, s);
}
