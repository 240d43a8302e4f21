// Weight-only int4 matmul for Hopper (sm_90a): out = x @ dequant(packed, scale).
//
// Replaces the Pallas TPU kernel cake_tpu/ops/pallas/int4_matmul.py
// (int4_matmul). It computes that kernel's arithmetic: each logical in-row k
// of W is float(nibble) * scale[k / group] in f32, rounded once to the
// activation dtype, and out = that W times x with f32 accumulation, rounded
// to the activation dtype. packed is [K/2, N] int8 (byte i holds logical
// rows 2i in its low nibble and 2i+1 in its high one), scale [K/group, N] f32.
//
// What bounds it on the H100: at decode rows the bytes (only the packed
// nibbles and the f32 scales stream: 0.52 byte a weight; Llama-3-8B's w_gu
// is 62 MB, 0.019 ms at 3.35 TB/s); from a few hundred rows the tensor
// cores (w_gu at 256 rows: 60 GFLOP, 0.061 ms at 989 TFLOP/s).
//
// What the design does about it:
// - A block owns a 256-column strip of 16 rows (decode) or 64, and walks
//   its split of K in BK = 64-row steps. A ring of cp.async stages
//   carries the packed bytes (16-byte loads along N, neighbouring threads
//   on neighbouring addresses), the scale rows the step needs and the x
//   tile, several steps ahead (5 stages at decode rows, 4 past them). The
//   weight never exists in device memory in any other form, nor in shared
//   memory: each warp unpacks it straight into mma.sync m16n8k16 operand
//   registers.
// - The operand trick: a B fragment register holds two consecutive k rows
//   of one column, which is one packed byte (low nibble k = 2i, high
//   nibble 2i + 1). A thread reads one 32-bit word (4 columns of a packed
//   row) and so fills the fragments of 4 n8 tiles at once, whose columns
//   are a permutation of the warp's 32 (tile c holds columns 4j + c). The
//   permutation is undone at the store: a thread's accumulators cover 8
//   contiguous columns of each of its rows, one 16-byte store.
// - Unpacking is integer and f32 arithmetic only: a byte permute builds
//   2^23 + nibble as a float, one exact subtraction recentres it, one
//   f32 product applies the scale, one paired conversion rounds two values
//   to the activation dtype (round to nearest even), as the TPU kernel's
//   scale-then-cast does. f32 activations take a CUDA-core FMA body.
// - Row independence: a row's sum runs over the same K steps, in the same
//   order, with the same split points, whatever the row count. The split
//   of K is a function of (K, N) alone (the wrapper's split_steps: enough
//   blocks for decode rows; lm_head needs none): each split is a block of
//   its own, writing f32 partials to a [splits, M, N] scratch, and a
//   second kernel adds them in split order. No atomics.
// - Shapes: N and K multiples of 16, an even group dividing K; a ragged
//   last K step or column strip is zero-filled and masked.
#include "common.cuh"

namespace cake {
namespace int4mm {

constexpr int BN = 128;             // output columns of an f32 block
constexpr int BK = 64;              // logical K rows a step covers
constexpr int BKP = BK / 2;         // packed rows a step covers
constexpr int THREADS = 256;
constexpr int A_STRIDE = BK + 8;    // x tile row, elements (144 bytes: ldmatrix conflict-free)
constexpr int RAW_PAD = 32;         // packed tile row padding, bytes (word reads conflict-free)
constexpr int FM = 16;              // rows a block of the f32 body covers

// float(v - 8) for the byte v (0..15) at index i of `biased`: a byte
// permute builds the float 2^23 + v, and one exact subtraction removes
// 2^23 + 8 (no integer-to-float conversion, a quarter-rate instruction).
__device__ __forceinline__ float biased_nibble(uint32_t biased, int i) {
  return __int_as_float((int)__byte_perm(biased, 0x4B000000u, 0x7540u | (unsigned)i)) -
         8388616.0f;
}

// A thread's piece of a K step: 16 packed bytes (one packed row p, 16
// columns) -> logical rows 2p (the low nibbles, `lo`) and 2p+1 (`hi`),
// each sign-extended nibble times its column's f32 scale `s` (both rows
// lie in one group: groups are even). (n & 0xF) ^ 8 = n + 8 for the
// two's-complement nibble n in -8..7.
__device__ __forceinline__ void dequant16(uint4 raw, const float (&s)[16], float (&lo)[16],
                                          float (&hi)[16]) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo4 = (words[q] & 0x0F0F0F0Fu) ^ 0x08080808u;
    const uint32_t hi4 = ((words[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[4 * q + i] = __fmul_rn(biased_nibble(lo4, i), s[4 * q + i]);
      hi[4 * q + i] = __fmul_rn(biased_nibble(hi4, i), s[4 * q + i]);
    }
  }
}

// 16 f32 scales from 16-byte aligned memory (global or shared).
__device__ __forceinline__ void load16(const float* p, float (&s)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    s[4 * q] = v.x;
    s[4 * q + 1] = v.y;
    s[4 * q + 2] = v.z;
    s[4 * q + 3] = v.w;
  }
}

template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type make(float a, float b) { return __floats2bfloat162_rn(a, b); }
};
template <> struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ type make(float a, float b) { return __floats2half2_rn(a, b); }
};

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  *reinterpret_cast<typename Pair<T>::type*>(p) = Pair<T>::make(a, b);
}
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Two floats rounded to T as one 32-bit operand register (a in the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  typename Pair<T>::type h = Pair<T>::make(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 8 floats rounded to T (or kept f32), stored at a 16-byte aligned address.
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  uint4 raw;
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = pack2<T>(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
template <>
__device__ __forceinline__ void store8<float>(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d (one m16n8 f32 tile) += a (m16k16, row-major) x b (k16n8, column-major).
template <typename T> __device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4],
                                                               uint32_t b0, uint32_t b1);
template <> __device__ __forceinline__ void mma16816<__nv_bfloat16>(float* d, const uint32_t (&a)[4],
                                                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <> __device__ __forceinline__ void mma16816<__half>(float* d, const uint32_t (&a)[4],
                                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The K steps a block walks: split blockIdx.z, `per` steps long.
struct StepRange {
  int lo, hi;
  __device__ StepRange(int steps, int per) {
    lo = (int)blockIdx.z * per;
    hi = min(steps, lo + per);
  }
};

// Scale rows a K step can touch: 64 consecutive rows span at most
// 63 / group + 2 groups.
__host__ __device__ inline int scale_slots(int group) { return min(BKP + 1, (BK - 1) / group + 2); }

// Stages of the cp.async ring: deep at decode rows (bytes in flight),
// shallower past them (the 64-row x tiles take the shared memory).
template <int BM> __host__ __device__ constexpr int stages() { return BM <= 16 ? 5 : 4; }
// The block's 8 warps split its 256 columns, 32 each; every warp covers
// all BM rows, so each weight element is unpacked once a block.
constexpr int BNB = 32 * (THREADS / 32);

template <int BM>
inline size_t mma_smem_bytes(int elem, int group) {
  return (size_t)stages<BM>() *
         (BKP * (BNB + RAW_PAD) + scale_slots(group) * BNB * 4 + BM * A_STRIDE * elem);
}

// One block: a BM x 256 output tile over one split of K; its f32 sums go
// to `scratch` (several splits) or, rounded, to `out` (one).
template <typename T, int BM>
__global__ void __launch_bounds__(THREADS)
int4_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
                const float* __restrict__ scale, T* __restrict__ out, float* __restrict__ scratch,
                int M, int K, int N, int group, int per) {
  constexpr int NSTAGE = stages<BM>();
  constexpr int RS = BNB + RAW_PAD;        // packed tile row stride, bytes
  constexpr int MI = BM / 16;
  constexpr int NACC = MI * 4 * 4;         // MI x 4 n8 tiles x 4 registers
  const int slots = scale_slots(group);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem;                                         // [NSTAGE][BKP][RS]
  float* sc = reinterpret_cast<float*>(raw + (size_t)NSTAGE * BKP * RS);  // [NSTAGE][slots][BNB]
  T* As = reinterpret_cast<T*>(sc + (size_t)NSTAGE * slots * BNB);   // [NSTAGE][BM][A_STRIDE]

  const int tid = threadIdx.x, lane = tid & 31, warp_n = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread in group
  const int n0 = blockIdx.x * BNB, m0 = blockIdx.y * BM;
  const int wcol = warp_n * 32 + 4 * g;  // this thread's 4 columns (in the block)
  const int steps = (K + BK - 1) / BK, half = K / 2, groups = K / group;
  const StepRange range(steps, per);
  // Scale slots of this thread's k rows (kk * 16 + 2t and + 8) where groups
  // align with K steps (a multiple or a divisor of BK): the same each step.
  const bool aligned = group % BK == 0 || BK % group == 0;
  int slot_of[BK / 16][2];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) slot_of[kk][h] = group >= BK ? 0 : 2 * (kk * 8 + t + 4 * h) / group;

  auto load_stage = [&](int step, int stage) {
    constexpr int CHUNKS = BNB / 16;  // 16-byte chunks of a packed row
    for (int c = tid; c < BKP * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS, col = n0 + (c % CHUNKS) * 16, p = step * BKP + r;
      const bool ok = col < N && p < half;
      cp_async16(raw + ((size_t)stage * BKP + r) * RS + (c % CHUNKS) * 16,
                 ok ? packed + (size_t)p * N + col : packed, ok);
    }
    const int g0 = step * BK / group;
    const int n_g = min(groups, (min(K, step * BK + BK) - 1) / group + 1) - g0;
    for (int c = tid; c < n_g * (BNB / 4); c += THREADS) {
      const int j = c / (BNB / 4), col = n0 + (c % (BNB / 4)) * 4;
      const bool ok = col < N;
      cp_async16(sc + ((size_t)stage * slots + j) * BNB + (c % (BNB / 4)) * 4,
                 ok ? scale + (size_t)(g0 + j) * N + col : scale, ok);
    }
    constexpr int PER_ROW = BK * (int)sizeof(T) / 16;
    constexpr int ELEMS = 16 / (int)sizeof(T);
    for (int c = tid; c < BM * PER_ROW; c += THREADS) {
      const int r = c / PER_ROW, kc = (c % PER_ROW) * ELEMS;
      const int gr = m0 + r, gk = step * BK + kc;
      const bool ok = gr < M && gk < K;
      cp_async16(As + ((size_t)stage * BM + r) * A_STRIDE + kc,
                 ok ? x + (size_t)gr * K + gk : x, ok);
    }
  };

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (range.lo + i < range.hi) load_stage(range.lo + i, i);
    cp_async_commit();
  }
  for (int step = range.lo; step < range.hi; ++step) {
    const int it = step - range.lo, stage = it % NSTAGE;
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // this stage landed; every warp is done with the stage refilled next
    if (step + NSTAGE - 1 < range.hi) load_stage(step + NSTAGE - 1, (it + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    const unsigned char* rt = raw + (size_t)stage * BKP * RS;
    const float* st = sc + (size_t)stage * slots * BNB;
    const T* at = As + (size_t)stage * BM * A_STRIDE;
    const int g0 = step * BK / group;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B: packed rows kk*8 + t (k = 2t, 2t+1 of this k16) and + 4 (k + 8).
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int prow = kk * 8 + t + 4 * h;
        const int k = step * BK + 2 * prow;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(rt + (size_t)prow * RS + wcol);
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if (k < K) {
          const int slot = aligned ? slot_of[kk][h] : k / group - g0;
          const float4 v = *reinterpret_cast<const float4*>(st + (size_t)slot * BNB + wcol);
          s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
        }
        const uint32_t lo4 = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t hi4 = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          b[h][c] = pack2<T>(__fmul_rn(biased_nibble(lo4, c), s[c]),
                             __fmul_rn(biased_nibble(hi4, c), s[c]));
      }
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(a[mi], at + (size_t)(mi * 16 + (lane & 15)) * A_STRIDE + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int c = 0; c < 4; ++c) mma16816<T>(acc + (mi * 4 + c) * 4, a[mi], b[0][c], b[1][c]);
    }
  }
  cp_async_wait<0>();

  // Tile c, registers 0 and 1: row g at tile columns 2t and 2t+1, that is
  // block columns 4 (2t) + c and 4 (2t+1) + c; registers 2, 3: row g + 8.
  // Over the 4 tiles a thread holds columns 8t .. 8t+7 of its warp's 32.
  const int col = n0 + warp_n * 32 + 8 * t;
  if (col >= N) return;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mi * 16 + g + 8 * h;
      if (row >= M) continue;
      float v[8];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = acc[(mi * 4 + c) * 4 + 2 * h];
        v[4 + c] = acc[(mi * 4 + c) * 4 + 2 * h + 1];
      }
      if (scratch)
        store8<float>(scratch + ((size_t)blockIdx.z * M + row) * N + col, v);
      else
        store8<T>(out + (size_t)row * N + col, v);
    }
  }
}

// f32 activations: the same steps and splits on the CUDA cores. A thread
// owns one column and FM / 2 rows; its sum runs over k in order.
__global__ void __launch_bounds__(THREADS)
int4_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ packed,
                const float* __restrict__ scale, float* __restrict__ out,
                float* __restrict__ scratch, int M, int K, int N, int group, int per) {
  __shared__ __align__(16) float xs[FM][BK];
  __shared__ __align__(16) float ws[BK][BN];
  constexpr int RPT = FM / (THREADS / BN);  // rows a thread owns
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * FM;
  const int steps = (K + BK - 1) / BK, half = K / 2;
  const StepRange range(steps, per);
  const int prow = tid / (BN / 16), pcol = (tid % (BN / 16)) * 16;
  const bool col_ok = n0 + pcol < N;
  const int c = tid % BN, rsub = tid / BN;

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  for (int step = range.lo; step < range.hi; ++step) {
    {
      const int r = tid / (BK / 4), kc = (tid % (BK / 4)) * 4;
      const int gr = m0 + r, gk = step * BK + kc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < M && gk < K) v = __ldg(reinterpret_cast<const float4*>(x + (size_t)gr * K + gk));
      *reinterpret_cast<float4*>(&xs[r][kc]) = v;
    }
    {
      const int p = step * BKP + prow;
      const bool ok = col_ok && p < half;
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (ok) r = __ldg(reinterpret_cast<const uint4*>(packed + (size_t)p * N + n0 + pcol));
      float s[16], lo[16], hi[16];
      if (ok) {
        load16(scale + (size_t)(2 * p / group) * N + n0 + pcol, s);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) s[j] = 0.f;
      }
      dequant16(r, s, lo, hi);
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        *reinterpret_cast<float4*>(&ws[2 * prow][pcol + j]) = make_float4(lo[j], lo[j + 1], lo[j + 2], lo[j + 3]);
        *reinterpret_cast<float4*>(&ws[2 * prow + 1][pcol + j]) = make_float4(hi[j], hi[j + 1], hi[j + 2], hi[j + 3]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float w = ws[k][c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(xs[rsub + 2 * i][k], w, acc[i]);
    }
    __syncthreads();
  }
  const int col = n0 + c;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = m0 + rsub + 2 * i;
    if (row >= M) continue;
    if (scratch)
      scratch[((size_t)blockIdx.z * M + row) * N + col] = acc[i];
    else
      out[(size_t)row * N + col] = acc[i];
  }
}

// out = the [splits, M, N] partials added in split order, rounded to T.
template <typename T>
__global__ void int4_reduce_kernel(const float* __restrict__ scratch, T* __restrict__ out,
                                   int splits, long long mn) {
  const long long i = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= mn) return;
  float2 s = *reinterpret_cast<const float2*>(scratch + i);
  for (int z = 1; z < splits; ++z) {
    const float2 v = *reinterpret_cast<const float2*>(scratch + z * mn + i);
    s.x = __fadd_rn(s.x, v.x);
    s.y = __fadd_rn(s.y, v.y);
  }
  store_pair<T>(out + i, s.x, s.y);
}

template <typename T>
static cudaError_t reduce(const float* scratch, void* out, int splits, int M, int N,
                          cudaStream_t stream) {
  const long long pairs = (long long)M * N / 2;
  int4_reduce_kernel<T><<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      scratch, static_cast<T*>(out), splits, (long long)M * N);
  return cudaGetLastError();
}

template <typename T, int BM>
static cudaError_t launch_mma(const void* x, const int8_t* packed, const float* scale, void* out,
                              float* scratch, int M, int K, int N, int group, int per, int splits,
                              cudaStream_t stream) {
  auto kernel = int4_mma_kernel<T, BM>;
  const size_t smem = mma_smem_bytes<BM>((int)sizeof(T), group);
  // Opt in once to the most any group size asks (two rows a group).
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = allow_smem(kernel, mma_smem_bytes<BM>((int)sizeof(T), 2));
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  dim3 grid((N + BNB - 1) / BNB, (M + BM - 1) / BM, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), packed, scale,
                                          static_cast<T*>(out), scratch, M, K, N, group, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !scratch) return err;
  return reduce<T>(scratch, out, splits, M, N, stream);
}

// 16-row blocks up to 16 rows, 64-row blocks past them. The row tile
// changes no bits: each row's sum is the same either way.
template <typename T>
static cudaError_t launch_tc(const void* x, const int8_t* packed, const float* scale, void* out,
                             float* scratch, int M, int K, int N, int group, int per, int splits,
                             cudaStream_t stream) {
  if (M <= 16)
    return launch_mma<T, 16>(x, packed, scale, out, scratch, M, K, N, group, per, splits, stream);
  return launch_mma<T, 64>(x, packed, scale, out, scratch, M, K, N, group, per, splits, stream);
}

static cudaError_t launch_f32(const void* x, const int8_t* packed, const float* scale, void* out,
                              float* scratch, int M, int K, int N, int group, int per, int splits,
                              cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + FM - 1) / FM, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int4_f32_kernel<<<grid, THREADS, 0, stream>>>(static_cast<const float*>(x), packed, scale,
                                                static_cast<float*>(out), scratch, M, K, N, group,
                                                per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !scratch) return err;
  return reduce<float>(scratch, out, splits, M, N, stream);
}

}  // namespace int4mm
}  // namespace cake

// x: [rows, K] (dtype); packed: [K/2, N] int8; scale: [K/group, N] f32;
// out: [rows, N] (dtype); all contiguous and 16-byte aligned, K and N
// multiples of 16, group even and dividing K. per: K steps (of 64 rows) a
// split covers, a function of (K, N) alone. scratch: a [ceil(steps / per),
// rows, N] f32 buffer when there is more than one split (NULL for one).
// Returns the first launch error.
extern "C" int cake_int4_matmul(const void* x, const void* packed, const void* scale, void* out,
                                void* scratch, int rows, int K, int N, int group, int per,
                                int dtype, void* stream) {
  using namespace cake;
  using namespace cake::int4mm;
  if (rows < 1) return (int)cudaSuccess;
  if (K < 16 || N < 16 || K % 16 || N % 16 || group < 2 || group % 2 || K % group || per < 1)
    return (int)cudaErrorInvalidValue;
  const int steps = (K + BK - 1) / BK;
  const int splits = (steps + per - 1) / per;
  if (splits > 1 && !scratch) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  float* scr = static_cast<float*>(scratch);
  switch (dtype) {
    case kF32: return (int)launch_f32(x, p, sc, out, scr, rows, K, N, group, per, splits, s);
    case kF16:
      return (int)launch_tc<__half>(x, p, sc, out, scr, rows, K, N, group, per, splits, s);
    case kBF16:
      return (int)launch_tc<__nv_bfloat16>(x, p, sc, out, scr, rows, K, N, group, per, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
