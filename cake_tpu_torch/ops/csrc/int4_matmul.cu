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
// Three bodies, chosen by the wrapper (ops/int4_matmul.py plan):
// - Decode rows (up to 16), mma.sync m16n8k16: a block owns a 256-column
//   strip of 16 rows and walks its split of K in BK = 64-row steps through a
//   5-stage cp.async ring of the packed bytes, their scales and the x tile.
//   Each warp unpacks one 32-bit word (4 columns of a packed row) straight
//   into the B fragments of 4 n8 tiles (a B register is two consecutive k of
//   one column: one packed byte); their column permutation is undone by one
//   16-byte store a row.
// - Past 16 rows, wgmma ("swap AB": out^T = W^T x^T): a block holds 128
//   output columns, two warpgroups of 64, and R = 32, 64, 128 or 256 rows
//   of x as the product's N. The x tile of a step comes by TMA, K-major and
//   128-byte swizzled, the B operand; the packed bytes and scales by
//   cp.async. Each thread unpacks a 16-bit read (its two A rows, two
//   adjacent columns) of four packed rows into the register A operand of the
//   step's four m64nRk16 products, once for all R rows; a step's products
//   stay in flight while the next step unpacks (two A register sets).
// - f32 activations: a CUDA-core FMA body.
// Unpacking is integer and f32 arithmetic only: a byte permute builds
// 2^23 + nibble as a float, one exact subtraction recentres it, one f32
// product applies the scale, one paired conversion rounds two values to the
// activation dtype (round to nearest even), as the TPU kernel's
// scale-then-cast does.
//
// Row independence, bitwise: a row's sum runs over the same K steps, in the
// same order, with the same split points, whatever the row count and the
// body. The split of K is a function of (K, N) alone (split_steps). At
// decode rows each split is a block writing f32 partials to a [splits, M,
// N] scratch and a second kernel adds them in split order; past them, where
// the blocks fill at least half the card, one block walks every split and
// folds each split's sums into a running f32 total (total = p0; total +=
// p1; ...), the ordered reduce's bits with no scratch. Measured on the card
// (PERF.md; the bits probe of chip_smoke.py): wgmma at every product width
// N = 8 .. 256 and mma.sync m16n8k16 give a row the same bits, so the body
// and the row tile follow the row count. Decode rows keep mma.sync: wgmma
// at row tile 8 or 16 is no faster there over a decode token's products
// (measured, PERF.md), and mma.sync also takes the scale groups wgmma does
// not. No atomics.
//
// Shapes: N and K multiples of 16, an even group dividing K; the wgmma body
// takes groups of 16 rows or more that divide or are multiples of BK. A
// ragged last K step or column strip is zero-filled and masked.
#include <cuda.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

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

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  *reinterpret_cast<typename Pair<T>::type*>(p) = Pair<T>::make(a, b);
}
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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

constexpr int BM = 16;      // rows a block of the decode body covers
constexpr int NSTAGE = 5;   // its cp.async ring: deep, for the bytes in flight
// The block's 8 warps split its 256 columns, 32 each; every warp covers
// all BM rows, so each weight element is unpacked once a block.
constexpr int BNB = 32 * (THREADS / 32);

inline size_t mma_smem_bytes(int elem, int group) {
  return (size_t)NSTAGE *
         (BKP * (BNB + RAW_PAD) + scale_slots(group) * BNB * 4 + BM * A_STRIDE * elem);
}

// One block: a BM x 256 output tile over one split of K; its f32 sums go
// to `scratch` (several splits) or, rounded, to `out` (one).
template <typename T>
__global__ void __launch_bounds__(THREADS)
int4_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
                const float* __restrict__ scale, T* __restrict__ out, float* __restrict__ scratch,
                int M, int K, int N, int group, int per) {
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

// ------------------------------------------------------------------ wgmma

// Past the decode rows: out^T = W^T x^T on Hopper's warpgroup products. A
// block holds 128 output columns (two warpgroups, one m64 product tile of
// 64 columns each) and R rows of x, the product's N; each warpgroup unpacks
// its 64 columns of a K step straight into wgmma's register A operand, once
// for all R rows, and x lands K-major in 128-byte swizzled shared memory as
// the B operand. One m64nRk16 product a 16-deep step covers all R rows.
constexpr int WGS = 2;                 // consumer warpgroups a block, 64 columns each
constexpr int WG_COLS = 64 * WGS;
constexpr int WG_THREADS = 128 * WGS;
constexpr int WG_RAW = WG_COLS + 16;  // packed tile row stride, bytes (u16 reads conflict-free)
constexpr int WG_STAGES = 4;          // the ring: two steps in flight ahead of the one in use

// One stage: the x tile [R][128 bytes], the packed tile [BKP][WG_RAW] and
// the scale rows of the step's groups [groups][WG_COLS] f32, rounded to the
// swizzle's 1024 bytes. Groups align with the K steps and hold 16 rows or
// more, so a step spans at most 4.
__host__ __device__ inline int wg_step_groups(int group) { return group >= BK ? 1 : BK / group; }
template <int R>
__host__ __device__ inline int wg_stage_bytes(int group) {
  return (R * 128 + BKP * WG_RAW + wg_step_groups(group) * WG_COLS * 4 + 1023) & ~1023;
}
// The ring, a fold's running totals ([R / 2][WG_THREADS] f32, a thread's
// own column of them) and the 1024-byte alignment.
template <int R, bool FOLD> inline size_t wg_smem_bytes(int group) {
  return (size_t)WG_STAGES * wg_stage_bytes<R>(group) + (FOLD ? R * 2 * WG_THREADS : 0) + 1024;
}

// FOLD: one block walks every split of K and folds each split's sums into
// a running f32 total in split order (the ordered reduce's bits); without
// it a block walks its split blockIdx.z (f32 partials to `scratch`) or,
// with one split, all of K. Groups align with the K steps (a multiple or a
// divisor of BK): a thread's scale slots are the same every step.
template <typename T, int R, bool FOLD>
__global__ void __launch_bounds__(WG_THREADS, 1)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ packed,
                  const float* __restrict__ scale, T* __restrict__ out,
                  float* __restrict__ scratch, int M, int K, int N, int group, int per) {
  constexpr int ACC = R / 2;  // f32 accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t x_landed[WG_STAGES];  // a stage's x tile arrived (TMA)
  // 1024-byte aligned stages (the swizzle repeats every 8 rows of 128
  // bytes), reached by an offset from smem_raw so that every access stays a
  // shared-memory one.
  unsigned char* base =
      smem_raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023)) & 1023);
  const int stage_bytes = wg_stage_bytes<R>(group);
  float* totals = reinterpret_cast<float*>(base + WG_STAGES * stage_bytes) + threadIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // A rows g and g + 8 of warp (warp & 3) are this thread's two adjacent
  // columns: one 16-bit read of a packed row gives both.
  const int ccol = (warp >> 2) * 64 + (warp & 3) * 16 + 2 * g;
  const int n0 = blockIdx.x * WG_COLS, m0 = blockIdx.y * R;
  const int steps = (K + BK - 1) / BK, half = K / 2, groups = K / group;
  int lo = 0, hi = steps;
  if (!FOLD && scratch) {
    const StepRange range(steps, per);
    lo = range.lo;
    hi = range.hi;
  }
  // The offsets of this thread's scale rows (k = 2 (kk 8 + t + 4 h), +1)
  // among a step's groups.
  const int step_groups = wg_step_groups(group);
  int sc_off[BK / 16][2];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sc_off[kk][h] = (group >= BK ? 0 : 2 * (kk * 8 + t + 4 * h) / group) * WG_COLS;

  // The x tile [R rows][64 k] of a step comes in one TMA copy (issued by
  // thread 0, rows past M and k past K zero-filled, 128-byte swizzled as
  // the B descriptors read it). Each thread's other copies are the same
  // every step but for the step's offset: packed row xr at 16 columns xc,
  // scale row sj (+ 8 i) at 4 columns sc4.
  constexpr int PCH = WG_COLS / 16, SCH = WG_COLS / 4;  // 16-byte chunks of a packed / scale row
  static_assert(BKP * PCH == WG_THREADS, "one packed chunk a thread");
  const int xr = tid / PCH, xc = tid % PCH, sj = tid / SCH, sc4 = (tid % SCH) * 4;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) mbar_init(&x_landed[s], 1);
    fence_mbar_init();
  }
  __syncthreads();
  const int8_t* psrc = packed + (size_t)xr * N + n0 + xc * 16;
  const size_t pjump = (size_t)BKP * N;  // one step down
  const bool pcol_ok = n0 + xc * 16 < N;
  const int pdst = R * 128 + xr * WG_RAW + xc * 16;
  const float* ssrc = scale + n0 + sc4;
  const bool scol_ok = n0 + sc4 < N;
  const int sdst = R * 128 + BKP * WG_RAW + (sj * WG_COLS + sc4) * 4;

  // In a ragged last step the rows past K read as zeros (x) times zero
  // nibbles (packed) times finite scales: every slot of the step is
  // written, the ones past the last group as zeros.
  const int steps_per_group = group >= BK ? group / BK : 1;
  auto load_stage = [&](int step, int s) {
    unsigned char* st = base + (size_t)s * stage_bytes;
    if (tid == 0) {
      mbar_expect_tx(&x_landed[s], R * 128);
      tma_load_2d(st, &xmap, step * BK, m0, &x_landed[s]);
    }
    const bool pok = pcol_ok && step * BKP + xr < half;
    cp_async16(st + pdst, pok ? psrc + step * pjump : packed, pok);
    const int g0 = group >= BK ? step / steps_per_group : step * step_groups;
    for (int j = sj; j < step_groups; j += WG_THREADS / SCH) {
      const bool ok = scol_ok && g0 + j < groups;
      cp_async16(st + sdst + (j - sj) * WG_COLS * 4, ok ? ssrc + (size_t)(g0 + j) * N : scale, ok);
    }
  };

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

#pragma unroll
  for (int i = 0; i < WG_STAGES - 2; ++i) {
    if (lo + i < hi) load_stage(lo + i, i);
    cp_async_commit();
  }
  // One step into the A operands `as`. Steps alternate between two sets,
  // so a step's products stay in flight while the next step unpacks.
  auto run_step = [&](int step, uint32_t (&as)[BK / 16][4]) {
    const int it = step - lo, s = it % WG_STAGES;
    cp_async_wait<WG_STAGES - 3>();
    mbar_wait(&x_landed[s], (it / WG_STAGES) & 1);
    // Stage s landed for every thread. The stage refilled next was read by
    // the products of step - 2, done in both warpgroups: each waited for
    // them after issuing step - 1's.
    __syncthreads();
    if (step + WG_STAGES - 2 < hi) load_stage(step + WG_STAGES - 2, (it + WG_STAGES - 2) % WG_STAGES);
    cp_async_commit();
    const unsigned char* xs = base + (size_t)s * stage_bytes;
    const unsigned char* rb = xs + R * 128 + t * WG_RAW + ccol;
    const float* sc = reinterpret_cast<const float*>(xs + R * 128 + BKP * WG_RAW) + ccol;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w = *reinterpret_cast<const uint16_t*>(rb + (kk * 8 + 4 * h) * WG_RAW);
        const float2 sv = *reinterpret_cast<const float2*>(sc + sc_off[kk][h]);
        const uint32_t lo4 = (w & 0x0F0Fu) ^ 0x0808u;
        const uint32_t hi4 = ((w >> 4) & 0x0F0Fu) ^ 0x0808u;
        as[kk][2 * h] = pack2<T>(__fmul_rn(biased_nibble(lo4, 0), sv.x),
                                 __fmul_rn(biased_nibble(hi4, 0), sv.x));
        as[kk][2 * h + 1] = pack2<T>(__fmul_rn(biased_nibble(lo4, 1), sv.y),
                                     __fmul_rn(biased_nibble(hi4, 1), sv.y));
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<R, T>(acc, as[kk], wg_desc(xs + kk * 32, 16, 1024));
    wg_commit();
    wg_wait<1>();
    if constexpr (FOLD) {
      if ((step + 1) % per == 0 || step + 1 == hi) {  // a split ends: total (+)= its sums
        wg_wait<0>();
        const bool first = step < per;
        wg_fence_acc(acc);
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          float* tot = totals + i * WG_THREADS;
          *tot = first ? acc[i] : __fadd_rn(*tot, acc[i]);
          acc[i] = 0.f;
        }
      }
    }
  };
  uint32_t a0[BK / 16][4], a1[BK / 16][4];  // a set is free once its step's products are done
  int step = lo;
  for (; step + 1 < hi; step += 2) {
    run_step(step, a0);
    run_step(step + 1, a1);
  }
  if (step < hi) run_step(step, a0);
  wg_wait<0>();
  wg_fence_acc(acc);
  cp_async_wait<0>();

  // Accumulator 4i + e (e = 0, 1): column ccol, x row 8i + 2t + e;
  // 4i + 2 + e: column ccol + 1, the same row.
  const int col = n0 + ccol;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < R / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * i + 2 * t + e;
      if (row >= M) continue;
      float v0, v1;
      if constexpr (FOLD) {
        v0 = totals[(4 * i + e) * WG_THREADS];
        v1 = totals[(4 * i + 2 + e) * WG_THREADS];
      } else {
        v0 = acc[4 * i + e];
        v1 = acc[4 * i + 2 + e];
      }
      if (scratch)
        store_pair<float>(scratch + ((size_t)blockIdx.z * M + row) * N + col, v0, v1);
      else
        store_pair<T>(out + (size_t)row * N + col, v0, v1);
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

// The decode rows' body: 16-row blocks on mma.sync.
template <typename T>
static cudaError_t launch_mma(const void* x, const int8_t* packed, const float* scale, void* out,
                              float* scratch, int M, int K, int N, int group, int per, int splits,
                              cudaStream_t stream) {
  auto kernel = int4_mma_kernel<T>;
  const size_t smem = mma_smem_bytes((int)sizeof(T), group);
  // Opt in once to the most any group size asks (two rows a group).
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = allow_smem(kernel, mma_smem_bytes((int)sizeof(T), 2));
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

// The TMA map of x [M, K] in tiles of R rows by one K step (128 bytes),
// 128-byte swizzled, zeros past the edges.
template <typename T>
static cudaError_t x_tile_map(CUtensorMap* map, const void* x, int M, int K, int R) {
  return tile_map_2d<T>(map, x, M, K, R, BK);
}

template <typename T, int R, bool FOLD>
static cudaError_t launch_wgmma(const void* x, const int8_t* packed, const float* scale,
                                void* out, float* scratch, int M, int K, int N, int group,
                                int per, int splits, cudaStream_t stream) {
  auto kernel = int4_wgmma_kernel<T, R, FOLD>;
  const size_t smem = wg_smem_bytes<R, FOLD>(group);
  static size_t allowed = 0;  // the most this kernel has opted into so far
  if (smem > allowed) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  dim3 grid((N + WG_COLS - 1) / WG_COLS, (M + R - 1) / R, scratch ? splits : 1);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  CUtensorMap xmap;
  cudaError_t err = x_tile_map<T>(&xmap, x, M, K, R);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WG_THREADS, smem, stream>>>(
      xmap, packed, scale, static_cast<T*>(out), scratch, M, K, N, group, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || !scratch) return err;
  return reduce<T>(scratch, out, splits, M, N, stream);
}

// Row tile R. Several splits and no scratch: one block walks them all and
// folds (R up to 128: the total doubles the accumulators); a scratch: a
// block a split, then the ordered reduce. Tiles 8 and 16 serve the bits
// probe and the decode-rows comparison (PERF.md).
template <typename T>
static cudaError_t launch_tiled(int tile, const void* x, const int8_t* packed, const float* scale,
                                void* out, float* scratch, int M, int K, int N, int group,
                                int per, int splits, cudaStream_t stream) {
  const bool fold = splits > 1 && !scratch;
#define CAKE_WG(R)                                                                             \
  if (tile == R)                                                                              \
    return fold ? launch_wgmma<T, R, true>(x, packed, scale, out, scratch, M, K, N, group, per, \
                                           splits, stream)                                    \
                : launch_wgmma<T, R, false>(x, packed, scale, out, scratch, M, K, N, group, per, \
                                            splits, stream);
#define CAKE_WG_NOFOLD(R)                                                                      \
  if (tile == R && !fold)                                                                     \
    return launch_wgmma<T, R, false>(x, packed, scale, out, scratch, M, K, N, group, per, splits, \
                                     stream);
  CAKE_WG(32)
  CAKE_WG(64)
  CAKE_WG(128)
  CAKE_WG_NOFOLD(256)
  CAKE_WG_NOFOLD(8)
  CAKE_WG_NOFOLD(16)
#undef CAKE_WG
#undef CAKE_WG_NOFOLD
  return cudaErrorInvalidValue;
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

template <typename T>
static cudaError_t launch_tc(int tile, const void* x, const int8_t* packed,
                             const float* scale, void* out, float* scratch, int M, int K, int N,
                             int group, int per, int splits, cudaStream_t stream) {
  if (tile == 0) {
    if (splits > 1 && !scratch) return cudaErrorInvalidValue;
    return launch_mma<T>(x, packed, scale, out, scratch, M, K, N, group, per, splits, stream);
  }
  if ((group % BK && BK % group) || group < 16) return cudaErrorInvalidValue;  // see wg_stage_bytes
  return launch_tiled<T>(tile, x, packed, scale, out, scratch, M, K, N, group, per, splits, stream);
}

}  // namespace int4mm
}  // namespace cake

// x: [rows, K] (dtype); packed: [K/2, N] int8; scale: [K/group, N] f32;
// out: [rows, N] (dtype); all contiguous and 16-byte aligned, K and N
// multiples of 16, group even and dividing K. per: K steps (of 64 rows) a
// split covers, a function of (K, N) alone. tile: 0 for the decode body
// (mma.sync, 16-row blocks; f32: the CUDA-core body, always), else the row
// tile of the wgmma body (f16/bf16), the width of its products.
// scratch: a [ceil(steps / per), rows, N] f32 buffer, each split a block of
// its own and an ordered reduce after them; NULL with one split, or, for
// the wgmma body, a block walks every split and folds them in order.
// Returns the first launch error.
extern "C" int cake_int4_matmul(const void* x, const void* packed, const void* scale, void* out,
                                void* scratch, int rows, int K, int N, int group, int per,
                                int tile, int dtype, void* stream) {
  using namespace cake;
  using namespace cake::int4mm;
  if (rows < 1) return (int)cudaSuccess;
  if (K < 16 || N < 16 || K % 16 || N % 16 || group < 2 || group % 2 || K % group || per < 1)
    return (int)cudaErrorInvalidValue;
  const int steps = (K + BK - 1) / BK;
  const int splits = (steps + per - 1) / per;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  float* scr = static_cast<float*>(scratch);
  switch (dtype) {
    case kF32:
      if (tile != 0 || (splits > 1 && !scratch)) return (int)cudaErrorInvalidValue;
      return (int)launch_f32(x, p, sc, out, scr, rows, K, N, group, per, splits, s);
    case kF16:
      return (int)launch_tc<__half>(tile, x, p, sc, out, scr, rows, K, N, group, per, splits, s);
    case kBF16:
      return (int)launch_tc<__nv_bfloat16>(tile, x, p, sc, out, scr, rows, K, N, group, per,
                                           splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
