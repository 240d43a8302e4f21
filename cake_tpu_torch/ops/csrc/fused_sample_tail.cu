// Fused sampling tail: repeat penalty + temperature + top-k threshold +
// gumbel-argmax over each row's logits.
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/fused_sample_tail.py
// (fused_sample_tail). Bound on the H100: the bytes of the logits (and of
// the noise when sampled), read by as many SMs as the rows can keep busy.
// Design (see ops/fused_sample_tail.py): a thread-block cluster of C blocks
// a row, block r owning one contiguous slice of the vocabulary. A top-k
// row's slice of logits and noise comes into shared memory by one bulk
// copy each (cp.async.bulk on an mbarrier), so it is read from device
// memory once; the order keys of the penalized, scaled values are written
// over the staged logits. Each block builds the penalty bitmap of its own
// slice from the ring. The top-k threshold is an exact radix select (four
// 8-bit passes from the top byte): each block's 256-bin histogram (from
// per-warp sub-histograms) goes into one of two shared buffers, and after
// one cluster barrier every block sums all C histograms through
// distributed shared memory in rank order and picks the same digit. The
// argmax takes the lowest index among equal maxima and NaN as the maximum,
// as torch.argmax does: each block reduces its slice and stores its
// (value, index) into rank 0's shared memory, which combines the C
// partials, so the id does not depend on C.
#include "common.cuh"
#include "wgmma.cuh"

namespace cake {

constexpr int ST_THREADS = 512;
constexpr int ST_WARPS = ST_THREADS / 32;
constexpr int ST_BATCH = 16;      // loads in flight a thread in a pass over its slice
constexpr int MAX_CLUSTER = 16;   // blocks a row (16 takes the non-portable cluster size)

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

// Thread-block clusters: this block's rank, the cluster barrier (arrive
// then wait, release / acquire), and distributed shared memory (the
// address of the same variable in another block of the cluster).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ uint32_t ld_cluster(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// One bulk copy global -> shared completing on `bar` (both addresses and
// `bytes` multiples of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A slice of n floats staged at `pad` words into a 16-byte aligned buffer,
// pad = the slice start's word offset mod 4: the aligned middle (`mid`
// elements from `head`) goes by one bulk copy, the < 4 elements at each
// end by plain loads.
struct Staging {
  int pad, head, mid;
};
__device__ __forceinline__ Staging staging(const float* p, int n) {
  const int pad = (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
  const int head = min(n, (4 - pad) & 3);
  return {pad, head, (n - head) & ~3};
}
// Issued by one thread; `bar` expects the middle's bytes (none: it
// completes at once).
__device__ __forceinline__ void stage_middle(uint32_t* dst, const float* p, const Staging& g,
                                             uint64_t* bar) {
  mbar_expect_tx(bar, g.mid * 4);
  if (g.mid) bulk_load(dst + g.pad + g.head, p + g.head, g.mid * 4, bar);
}
__device__ __forceinline__ void stage_ends(uint32_t* dst, const float* p, const Staging& g, int n,
                                           int tid) {
  if (tid < g.head) dst[g.pad + tid] = __float_as_uint(p[tid]);
  const int i = g.head + g.mid + tid;
  if (tid < 4 && i < n) dst[g.pad + i] = __float_as_uint(p[i]);
}

// f(x, i) for each element i < n of p this thread owns, ST_BATCH loads in
// flight before the first call.
template <typename F>
__device__ __forceinline__ void each_global(const float* __restrict__ p, int n, int tid, F&& f) {
  for (int i0 = tid; i0 < n; i0 += ST_THREADS * ST_BATCH) {
    float x[ST_BATCH];
#pragma unroll
    for (int u = 0; u < ST_BATCH; ++u) {
      const int i = i0 + u * ST_THREADS;
      x[u] = i < n ? __ldg(p + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < ST_BATCH; ++u)
      if (i0 + u * ST_THREADS < n) f(x[u], i0 + u * ST_THREADS);
  }
}

// The same over two rows (logits and noise) at once.
template <typename F>
__device__ __forceinline__ void each_global2(const float* __restrict__ p,
                                             const float* __restrict__ q, int n, int tid, F&& f) {
  for (int i0 = tid; i0 < n; i0 += ST_THREADS * ST_BATCH) {
    float x[ST_BATCH], z[ST_BATCH];
#pragma unroll
    for (int u = 0; u < ST_BATCH; ++u) {
      const int i = i0 + u * ST_THREADS;
      x[u] = i < n ? __ldg(p + i) : 0.f;
      z[u] = i < n ? __ldg(q + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < ST_BATCH; ++u)
      if (i0 + u * ST_THREADS < n) f(x[u], z[u], i0 + u * ST_THREADS);
  }
}

// Dynamic shared memory of a block (the wrapper's smem_bytes() mirrors it):
// the slice's penalty bitmap, then with top-k the warps' sub-histograms,
// two block histograms and the cluster's sum, then when staged the slice's
// logits (its order keys, later) and noise.
__host__ __device__ inline int tail_bitmap_words(int slice) { return ((slice + 31) / 32 + 3) & ~3; }
__host__ __device__ inline int tail_buffer_words(int slice) { return (slice + 4 + 3) & ~3; }
inline size_t tail_smem_bytes(int slice, bool topk, bool staged) {
  return 4 * ((size_t)tail_bitmap_words(slice) + (topk ? ST_WARPS * 256 + 3 * 256 : 0) +
              (staged ? 2 * (size_t)tail_buffer_words(slice) : 0));
}

// grid (cluster, b), a cluster of gridDim.x blocks a row; block r owns
// elements [r * slice, min(V, (r + 1) * slice)). STAGED needs TOPK, TOPK
// needs SAMPLED.
template <bool PEN, bool SAMPLED, bool TOPK, bool STAGED>
__global__ void __launch_bounds__(ST_THREADS)
tail_kernel(const float* __restrict__ logits, const long long* __restrict__ ring,
            const float* __restrict__ noise, long long* __restrict__ out, int V, int W,
            TailArgs args, int top_k, int slice) {
  extern __shared__ __align__(16) uint32_t tail_smem[];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ uint32_t part_v[MAX_CLUSTER];  // rank 0's: each block's (value, index)
  __shared__ int part_i[MAX_CLUSTER];
  __shared__ float best_v[ST_WARPS];
  __shared__ int best_i[ST_WARPS];
  __shared__ uint32_t sel_digit;
  __shared__ int sel_rank;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, row = blockIdx.y;
  const uint32_t rank = cluster_rank();
  const int n_blocks = gridDim.x;
  const int lo = (int)rank * slice;
  const int n = max(0, min(V, lo + slice) - lo);
  uint32_t* seen = tail_smem;                                  // PEN
  uint32_t* sub = seen + tail_bitmap_words(slice);             // [ST_WARPS][256], TOPK
  uint32_t* hist = sub + (TOPK ? ST_WARPS * 256 : 0);          // [2][256], TOPK
  uint32_t* tot = hist + (TOPK ? 2 * 256 : 0);                 // [256], TOPK
  uint32_t* lbuf = tot + (TOPK ? 256 : 0);                     // STAGED
  uint32_t* nbuf = lbuf + (STAGED ? tail_buffer_words(slice) : 0);
  const float* lrow = logits + (size_t)row * V + lo;
  const float* nrow = SAMPLED ? noise + (size_t)row * V + lo : nullptr;

  // Every block of the cluster must have started before one reaches
  // another's shared memory: this arrival is waited for before the first
  // such access.
  cluster_arrive_relaxed();

  Staging gl{}, gn{};
  if constexpr (STAGED) {
    gl = staging(lrow, n);
    gn = staging(nrow, n);
    if (tid == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      fence_mbar_init();
      stage_middle(lbuf, lrow, gl, &bars[0]);
      stage_middle(nbuf, nrow, gn, &bars[1]);
    }
    stage_ends(lbuf, lrow, gl, n, tid);
    stage_ends(nbuf, nrow, gn, n, tid);
  }
  if constexpr (PEN)
    for (int i = tid; i < tail_bitmap_words(slice); i += ST_THREADS) seen[i] = 0u;
  if constexpr (TOPK)
    for (int i = tid; i < ST_WARPS * 256; i += ST_THREADS) sub[i] = 0u;
  __syncthreads();
  if constexpr (PEN) {
    // This slice's bitmap of the ring (a token twice is penalized once).
    const long long* rr = ring + (size_t)row * W;
    for (int i = tid; i < W; i += ST_THREADS) {
      const long long t = rr[i] - lo;
      if (t >= 0 && t < n) atomicOr(&seen[t >> 5], 1u << (t & 31));
    }
    __syncthreads();
  }
  auto scaled = [&](float x, int i) {
    if (PEN && ((seen[i >> 5] >> (i & 31)) & 1u))
      x = x > 0.f ? __fmul_rn(x, args.inv_pen) : __fmul_rn(x, args.pen);
    if (SAMPLED) x = __fmul_rn(x, args.inv_temp);
    return x;
  };

  // The k-th largest scaled value counting duplicates: radix select from
  // the top byte down; `rank_k` is the k-th's rank among keys with `prefix`.
  float thresh = 0.f;
  if constexpr (TOPK) {
    uint32_t* keys = lbuf + gl.pad;
    uint32_t prefix = 0u, mask = 0u;
    int rank_k = top_k;
    uint32_t* my = sub + warp * 256;
    if constexpr (STAGED) mbar_wait(&bars[0], 0);
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      if constexpr (STAGED) {
        if (pass == 0) {
          for (int i = tid; i < n; i += ST_THREADS) {
            const uint32_t k = order_key(scaled(__uint_as_float(keys[i]), i));
            keys[i] = k;
            atomicAdd(&my[k >> 24], 1u);
          }
        } else {
          // ST_BATCH keys read before the first add (measured faster
          // than one key an add: PERF.md).
          for (int i0 = tid; i0 < n; i0 += ST_THREADS * ST_BATCH) {
            uint32_t kb[ST_BATCH];
#pragma unroll
            for (int u = 0; u < ST_BATCH; ++u) {
              const int i = i0 + u * ST_THREADS;
              kb[u] = i < n ? keys[i] : 0u;
            }
#pragma unroll
            for (int u = 0; u < ST_BATCH; ++u)
              if (i0 + u * ST_THREADS < n && (kb[u] & mask) == prefix)
                atomicAdd(&my[(kb[u] >> shift) & 255u], 1u);
          }
        }
      } else {
        each_global(lrow, n, tid, [&](float x, int i) {
          const uint32_t k = order_key(scaled(x, i));
          if ((k & mask) == prefix) atomicAdd(&my[(k >> shift) & 255u], 1u);
        });
      }
      __syncthreads();
      // This block's histogram into this pass's buffer, the warps'
      // sub-histograms back to zero.
      uint32_t* mine = hist + (pass & 1) * 256;
      if (tid < 256) {
        uint32_t s = 0u;
#pragma unroll
        for (int w = 0; w < ST_WARPS; ++w) {
          s += sub[w * 256 + tid];
          sub[w * 256 + tid] = 0u;
        }
        mine[tid] = s;
      }
      if (pass == 0) cluster_wait();
      cluster_arrive();
      cluster_wait();
      // The cluster's histogram: every block's, in rank order. A block
      // rewrites this buffer two passes on, after the next barrier, which
      // no block passes before it has read this one.
      if (tid < 256) {
        uint32_t s = 0u;
        for (int r = 0; r < n_blocks; ++r) s += ld_cluster(map_rank(mine + tid, r));
        tot[tid] = s;
      }
      __syncthreads();
      if (warp == 0) {
        // Digit d's count; then, from the top digit down, the first digit
        // whose running count reaches `rank_k`.
        uint32_t cnt[8];
        uint32_t here_sum = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          cnt[j] = tot[255 - (lane * 8 + j)];
          here_sum += cnt[j];
        }
        // Inclusive prefix of the lanes' sums (digits at and above this lane's).
        uint32_t incl = here_sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        uint32_t run = incl - here_sum;
        if (run < (uint32_t)rank_k && incl >= (uint32_t)rank_k) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (run + cnt[j] >= (uint32_t)rank_k) {
              sel_digit = 255u - (uint32_t)(lane * 8 + j);
              sel_rank = rank_k - (int)run;
              break;
            }
            run += cnt[j];
          }
        }
      }
      __syncthreads();
      prefix |= sel_digit << shift;
      mask |= 255u << shift;
      rank_k = sel_rank;
    }
    thresh = key_value(prefix);
  }

  // Argmax of the scaled slice (greedy) or of scaled + noise with the
  // top-k mask (sampled).
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  auto take = [&](float val, int i) {
    if (ahead(val, lo + i, bv, bi)) {
      bv = val;
      bi = lo + i;
    }
  };
  if constexpr (STAGED) {
    mbar_wait(&bars[1], 0);  // the noise copy ran under the select passes
    const uint32_t* keys = lbuf + gl.pad;
    const float* nz = reinterpret_cast<const float*>(nbuf + gn.pad);
    for (int i = tid; i < n; i += ST_THREADS) {
      const float s = key_value(keys[i]);
      take(s < thresh ? -INFINITY : __fadd_rn(s, nz[i]), i);
    }
  } else if constexpr (SAMPLED) {
    each_global2(lrow, nrow, n, tid, [&](float x, float z, int i) {
      const float s = scaled(x, i);
      take((TOPK && s < thresh) ? -INFINITY : __fadd_rn(s, z), i);
    });
  } else {
    each_global(lrow, n, tid, [&](float x, int i) { take(scaled(x, i), i); });
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
  if constexpr (!TOPK) cluster_wait();  // the first arrival (a top-k block waited in its passes)
  if (warp == 0) {
    bv = lane < ST_WARPS ? best_v[lane] : -INFINITY;
    bi = lane < ST_WARPS ? best_i[lane] : 0x7fffffff;
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
      st_cluster(map_rank(&part_v[rank], 0), __float_as_uint(bv));
      st_cluster(map_rank(&part_i[rank], 0), (uint32_t)bi);
    }
  }
  cluster_arrive();
  cluster_wait();
  if (rank == 0 && warp == 0) {
    bv = lane < n_blocks ? __uint_as_float(part_v[lane]) : -INFINITY;
    bi = lane < n_blocks ? part_i[lane] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ahead(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) out[row] = bi;
  }
}

// A kernel's attributes for a cluster of `cluster` blocks and `smem`
// bytes, set once per instantiation (and again for more shared memory).
template <bool PEN, bool SAMPLED, bool TOPK, bool STAGED>
static cudaError_t tail_attributes(int cluster, size_t smem) {
  static size_t allowed = 0;
  static bool non_portable = false;
  auto kernel = tail_kernel<PEN, SAMPLED, TOPK, STAGED>;
  if (smem > allowed) {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  if (cluster > 8 && !non_portable) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  return cudaSuccess;
}

static cudaLaunchConfig_t tail_config(int cluster, int b, size_t smem, cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, b);
  cfg.blockDim = dim3(ST_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool P, bool S, bool T, bool G>
struct TailMode {
  static constexpr bool pen = P, sampled = S, topk = T, staged = G;
};

// f(TailMode<...>{}) for the instantiation the flags name.
template <typename F>
static auto tail_mode(bool pen, bool sampled, bool topk, bool staged, F&& f) {
#define CAKE_TAIL_MODES(P)                                       \
  if (!sampled) return f(TailMode<P, false, false, false>{});    \
  if (!topk) return f(TailMode<P, true, false, false>{});        \
  if (!staged) return f(TailMode<P, true, true, false>{});       \
  return f(TailMode<P, true, true, true>{});
  if (pen) {
    CAKE_TAIL_MODES(true)
  }
  CAKE_TAIL_MODES(false)
#undef CAKE_TAIL_MODES
}

static bool tail_geometry_ok(int V, int cluster, int slice, bool sampled, int top_k,
                             bool staged) {
  return V >= 1 && cluster >= 1 && cluster <= MAX_CLUSTER && slice >= 1 && slice % 4 == 0 &&
         (long long)cluster * slice >= V && top_k <= V && (top_k <= 0 || sampled) &&
         (!staged || top_k > 0);
}

}  // namespace cake

// logits: [b, V] f32; ring: [b, W] int64 recent ids (-1 = empty); noise:
// [b, V] f32 gumbel rows, or NULL for greedy (argmax of the penalized
// logits). penalize != 0 applies the repeat penalty over the ring: positive
// logits times inv_penalty, the others times penalty; a sampled step then
// multiplies by inv_temperature. top_k > 0 masks below the k-th largest
// scaled value (1 <= top_k <= V). out: [b] int64 ids. All contiguous. The
// geometry is ops/fused_sample_tail.plan()'s: a cluster of `cluster` blocks
// a row, `slice` elements a block (a multiple of 4), the top-k slice staged
// in shared memory when `staged`. Returns the launch's error.
extern "C" int cake_fused_sample_tail(const void* logits, const void* ring, const void* noise,
                                      void* out, int b, int V, int W, int penalize,
                                      float penalty, float inv_penalty, float inv_temperature,
                                      int top_k, int cluster, int slice, int staged,
                                      void* stream) {
  using namespace cake;
  if (b < 1) return (int)cudaSuccess;
  const bool sampled = noise != nullptr, pen = penalize && W > 0;
  if (W < 0 || (pen && ring == nullptr) ||
      !tail_geometry_ok(V, cluster, slice, sampled, top_k, staged))
    return (int)cudaErrorInvalidValue;
  const TailArgs a{penalty, inv_penalty, inv_temperature};
  const size_t smem = tail_smem_bytes(slice, top_k > 0, staged);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)tail_mode(pen, sampled, top_k > 0, staged, [&](auto m) {
    using M = decltype(m);
    cudaError_t err = tail_attributes<M::pen, M::sampled, M::topk, M::staged>(cluster, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = tail_config(cluster, b, smem, s, attr);
    return cudaLaunchKernelEx(&cfg, tail_kernel<M::pen, M::sampled, M::topk, M::staged>,
                              static_cast<const float*>(logits),
                              static_cast<const long long*>(ring),
                              static_cast<const float*>(noise), static_cast<long long*>(out), V,
                              W, a, top_k, slice);
  });
}

// How many clusters of `cluster` blocks of the kernel these flags name,
// with `slice` elements a block, the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0: none can be scheduled). A CUDA error
// is returned negated.
extern "C" int cake_fused_sample_tail_clusters(int cluster, int slice, int staged, int penalize,
                                               int sampled, int top_k) {
  using namespace cake;
  if (cluster < 1 || cluster > MAX_CLUSTER || slice < 1) return -(int)cudaErrorInvalidValue;
  const size_t smem = tail_smem_bytes(slice, top_k > 0, staged);
  return tail_mode(penalize, sampled, top_k > 0, staged, [&](auto m) {
    using M = decltype(m);
    cudaError_t err = tail_attributes<M::pen, M::sampled, M::topk, M::staged>(cluster, smem);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = tail_config(cluster, 1, smem, nullptr, attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(
        &n, (const void*)tail_kernel<M::pen, M::sampled, M::topk, M::staged>, &cfg);
    return err == cudaSuccess ? n : -(int)err;
  });
}
