// Weight-only quantized matmul for Hopper (sm_90a) on wgmma: W8A16 and
// W4A16 with bf16 or fp16 activations, the "narrow" (decode) and "wide"
// (prefill) routes of kernels/weight_only.py:_route.
//
// Replaces _wo_kernel in paddle_tpu/kernels/weight_only.py (:28, pallas_call
// :77) for every bf16/fp16 shape that TMA can map (n a multiple of 16, k of
// 8, x and the weight 16-byte aligned); fp32 x ("fma") and the shapes TMA
// cannot map ("legacy") stay on csrc/weight_only.cu.  ptt_weight_only_sm90
// computes what the plain _wo_reference computes,
//
//     out[m, n] = cast(scale[n] * sum_k x[m, k] * q[k, n])
//
// with q int8 [k, n] or int4 packed [k / 2, n] (low nibble = even row), the
// sum in fp32 and the scale applied once after it.  int8 codes in [-127, 127]
// and int4 codes in [-8, 7] are exact in bf16 and fp16, so the dequantized
// tile times x, summed in fp32 by the tensor cores, is the reference's fp32
// dot up to summation order.
//
// What bounds it on this card (3.35 TB/s, 989 TFLOP/s):
// - decode (m <= 64): bytes, the weight read once: llama2_7b's gate/up
//   [4096, 11008] is 45.1 MB in int8 (0.0135 ms) and 22.5 MB in int4
//   (0.0068 ms);
// - prefill (m > 64): operations, 2 m k n: 46.2 GFLOP at m 512 (0.047 ms).
//
// What the design does about it:
// - Narrow form (decode): the operands swap, as gmm's narrow form does:
//   out^T [64 columns x TM rows] = deq(W)^T x^T, so the dequantized weight
//   tile is wgmma's A (64 rows, MN-major, tnsp-a 1) and the TM = 8 .. 64 rows
//   of x are wgmma's n: no padding rows are computed.  A producer warp's
//   one thread issues TMA for the raw codes ([128 k x 64 columns] of int8 or
//   [64 packed rows x 64] of int4, no swizzle: a 2-D uint8 map) and the x
//   tile into a ring of 6-8 stages (4 at TM >= 32), ~32-48 KB of raw codes
//   in flight a CTA and two CTAs an SM.  Turning codes into bf16/fp16 is
//   most of the work an SM does here (every byte read becomes one or two
//   values), so two consumer warpgroups share it: each takes one 64-row
//   half of every step, turns its raw half into its own tile in the 128-byte
//   swizzle (packed conversions: an int8 code placed in a float's mantissa
//   by one PRMT, one FADD to remove the offset, one F2FP for two values; two
//   int4 codes in the mantissas of a bf16/fp16 pair by one LOP3 and one
//   packed subtraction), fences
//   the proxy, meets its own warps at a named barrier and issues its wgmma
//   over its half of x, which runs while it dequantizes its next half into
//   the other of its two tiles.  Consumer 1's fp32 sums are added to
//   consumer 0's at the end.
// - Split-K where the column tiles do not fill the card (kernels/
//   weight_only.py:wo_plan, a pure function of m, k, n: n 4096 gives 64
//   tiles): each split writes fp32 partials to a workspace [splits, m, n]
//   and wo_splitk_finish sums them in split order (0, 1, 2, ...), applies
//   the scale and casts.  No atomics: two runs give the same bits.
// - Wide form (prefill): the matmul's tile body (wide_sm90.cuh) with its B
//   operand dequantized on the way in: one thread issues TMA for each
//   64-deep k-step's x tile (A, K-major) and raw codes into a 5-deep ring;
//   the two consumer warpgroups each dequantize half of the step's codes
//   into the MN-major swizzled B tile, fence, meet at a named barrier and
//   run their wgmma (128 x 128 tiles), so the conversion of step k + 1
//   overlaps the products of step k.  The per-column scale multiplies the
//   fp32 sums in the epilogue, before the one cast.
// - Ragged shapes run here: k and n off the tiles load zeros by TMA's
//   out-of-bounds fill (k past its end reads zero x, so an int4 padding
//   nibble adds nothing) and are never stored.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "grouped_sm90.cuh"
#include "sm90.cuh"
#include "wide_sm90.cuh"

namespace {

using namespace sm90;
using gsm90::swz;

// ---- dequantization: codes to x's type, two values a packed conversion ----

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 4 bytes of u, each a code plus `bias` (0 .. 255), as 4 values of T:
// byte i placed in the mantissa of 2^23 (0x4B0000bb, one PRMT) is 2^23 + b
// exactly, and one FADD removes 2^23 + bias.
template <typename T>
__device__ __forceinline__ uint2 conv4(uint32_t u, float bias) {
  const float base = 8388608.f + bias;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - base;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - base;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - base;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - base;
  return make_uint2(pack2<T>(f0, f1), pack2<T>(f2, f3));
}

// 16 int8 codes (one 16-byte chunk along n) -> 16 values of T (two chunks)
template <typename T>
__device__ __forceinline__ void deq_int8(uint4 raw, uint4 (&v)[2]) {
  const uint2 a = conv4<T>(raw.x ^ 0x80808080u, 128.f), b = conv4<T>(raw.y ^ 0x80808080u, 128.f);
  const uint2 c = conv4<T>(raw.z ^ 0x80808080u, 128.f), d = conv4<T>(raw.w ^ 0x80808080u, 128.f);
  v[0] = make_uint4(a.x, a.y, b.x, b.y);
  v[1] = make_uint4(c.x, c.y, d.x, d.y);
}

// Two nibbles u (code + 8, 0 .. 15) at bits 0-3 and 16-19 of t as a pair of
// T: u in the mantissa of 128.0 (bf16 0x4300) or 1024.0 (fp16 0x6400) is
// 128 + u or 1024 + u exactly (one LOP3), and one packed subtraction of
// 136 or 1032 leaves the code, exactly
template <typename T>
__device__ __forceinline__ uint32_t nib2(uint32_t t);
template <>
__device__ __forceinline__ uint32_t nib2<__nv_bfloat16>(uint32_t t) {
  uint32_t v = (t & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&r);
}
template <>
__device__ __forceinline__ uint32_t nib2<__half>(uint32_t t) {
  uint32_t v = (t & 0x000F000Fu) | 0x64006400u;
  __half2 r = __hsub2(*reinterpret_cast<__half2*>(&v), __floats2half2_rn(1032.f, 1032.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

// 16 packed int4 bytes -> the even row's 16 values (the low nibbles) and
// the odd row's (the high ones); xor 8 turns each nibble into its code + 8,
// and a PRMT spreads a word's bytes 0, 1 (then 2, 3) to bits 0 and 16
template <typename T>
__device__ __forceinline__ void deq_int4(uint4 raw, uint4 (&even)[2], uint4 (&odd)[2]) {
  const uint32_t w[4] = {raw.x ^ 0x88888888u, raw.y ^ 0x88888888u, raw.z ^ 0x88888888u,
                         raw.w ^ 0x88888888u};
  uint32_t e[8], o[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t t01 = __byte_perm(w[q], 0u, 0x4140), t23 = __byte_perm(w[q], 0u, 0x4342);
    e[2 * q] = nib2<T>(t01);
    e[2 * q + 1] = nib2<T>(t23);
    o[2 * q] = nib2<T>(t01 >> 4);
    o[2 * q + 1] = nib2<T>(t23 >> 4);
  }
  even[0] = make_uint4(e[0], e[1], e[2], e[3]);
  even[1] = make_uint4(e[4], e[5], e[6], e[7]);
  odd[0] = make_uint4(o[0], o[1], o[2], o[3]);
  odd[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// v (the 16 values of one raw chunk) into row r of a swizzled [rows x 64]
// block at `blk`, chunks c and c + 1; `flip` writes the second chunk first,
// so that the 8 threads of a store wavefront whose rows share a swizzle
// phase still hit distinct banks
__device__ __forceinline__ void put_row(unsigned char* blk, int r, int c, const uint4 (&v)[2],
                                        bool flip) {
  // selects, not v[flip]: an index that is not a constant would put v in
  // local memory
  const int f = flip ? 1 : 0;
  *reinterpret_cast<uint4*>(blk + swz(r, c + f)) = flip ? v[1] : v[0];
  *reinterpret_cast<uint4*>(blk + swz(r, c + 1 - f)) = flip ? v[0] : v[1];
}

// ROWS raw rows of COLS bytes (int8 k rows, or int4 packed rows) at `raw`
// -> the swizzled tile of T at `dst`: COLS / 64 column blocks `blk_bytes`
// apart, raw row r at tile row r (int8) or rows 2r and 2r + 1 (int4), by a
// warpgroup's 128 threads.
template <typename T, bool INT4, int COLS, int ROWS>
__device__ __forceinline__ void dequant_rows(const unsigned char* raw, unsigned char* dst,
                                             uint32_t blk_bytes, int t) {
  constexpr int kPerRow = COLS / 16;          // raw chunks a row
  static_assert(ROWS * kPerRow % 128 == 0, "whole chunks a thread");
#pragma unroll
  for (int id = t; id < ROWS * kPerRow; id += 128) {
    const int r = id / kPerRow, q = id % kPerRow;
    unsigned char* blk = dst + (q >> 2) * blk_bytes;
    const int c = 2 * (q & 3);
    const bool flip = INT4 ? ((r ^ (q >> 2)) & 1) : ((q >> 2) & 1);
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * COLS + q * 16);
    if constexpr (INT4) {
      uint4 even[2], odd[2];
      deq_int4<T>(v, even, odd);
      put_row(blk, 2 * r, c, even, flip);
      put_row(blk, 2 * r + 1, c, odd, flip);
    } else {
      uint4 d[2];
      deq_int8<T>(v, d);
      put_row(blk, r, c, d, flip);
    }
  }
}

__device__ __forceinline__ void store_out(void* out, int64_t i, float v, int code) {
  if (code == 0)
    static_cast<float*>(out)[i] = v;
  else if (code == 1)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(out)[i] = __float2half_rn(v);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ------------------------------------------------------------ narrow form ---

constexpr int kNarrowCols = 64;          // output columns of a CTA
constexpr int kNarrowRaw = 128;          // raw rows a step (int8 k, int4 packed), 64 a consumer
constexpr int kNarrowThreads = 288;      // two consumer warpgroups + a producer warp
constexpr uint32_t kNarrowBudget = 110 * 1024;   // ring + tiles: two CTAs an SM

template <int TM, bool INT4>
struct NarrowSmem {
  static constexpr int k_step = INT4 ? 2 * kNarrowRaw : kNarrowRaw;   // logical k a step
  static constexpr int boxes = k_step / 64;                    // x boxes a step
  static constexpr uint32_t xbox = TM * 128;                    // TM rows x 64 k
  static constexpr uint32_t raw = kNarrowRaw * kNarrowCols;     // 8 KB of codes
  static constexpr uint32_t stage = boxes * xbox + raw;         // a multiple of 1024
  static constexpr uint32_t deq = k_step / 2 * 128;             // a consumer's [k x 64]
  static constexpr uint32_t off_deq = 0;
  // as many stages as fit the budget, 2 to 10 (int4 at TM 64 takes 2 and
  // goes over it: one CTA an SM)
  static constexpr int stages_fit = (kNarrowBudget - 2 * deq) / stage;
  static constexpr int stages = stages_fit < 2 ? 2 : stages_fit > 10 ? 10 : stages_fit;
  static constexpr uint32_t off_ring = 2 * deq;
  static constexpr uint32_t off_bar = off_ring + stages * stage;
  static constexpr uint32_t bytes = off_bar + 2 * stages * 8 + 1024;
  static_assert(stage % 1024 == 0 && deq % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(TM * 64 * 4 <= stages * stage, "the partial sums fit in the ring");
};

// Consumer w takes the raw rows [64 w, 64 w + 64) of every step (its half
// of the step's k): it turns them into its own swizzled [k x 64] tile, meets
// its own warps at named barrier 1 + w, issues out^T += tile^T x^T over its
// x boxes, waits for the products and releases the stage.  Consumer 1's
// sums are added to consumer 0's at the end, in that order.
template <typename T, bool INT4, int TM>
__global__ void __launch_bounds__(kNarrowThreads)
wo_narrow_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                 const float* __restrict__ scale, void* __restrict__ out, float* __restrict__ ws,
                 int M, int K, int N, int out_code, int steps_per_split) {
  using S = NarrowSmem<TM, INT4>;
  constexpr int kSt = S::stages;
  constexpr int kHalfK = S::k_step / 2;        // a consumer's logical k a step
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + S::off_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::off_bar);
  uint64_t* empty = full + kSt;
  const int n0 = blockIdx.x * kNarrowCols, split = blockIdx.y;
  const int kt0 = split * steps_per_split;
  const int nk = min((K + S::k_step - 1) / S::k_step - kt0, steps_per_split);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);             // the consumers' warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                // ---- producer warp: one thread
    if (threadIdx.x == 256) {
      tma_prefetch_map(&tm_x);
      tma_prefetch_map(&tm_w);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kSt, kt = kt0 + j;
        unsigned char* st = ring + s * S::stage;
        mbar_wait(&empty[s], ((j / kSt) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], S::stage);
#pragma unroll
        for (int b = 0; b < S::boxes; ++b)
          tma_load_2d(st + b * S::xbox, &tm_x, &full[s], kt * S::k_step + 64 * b, 0);
        tma_load_2d(st + S::boxes * S::xbox, &tm_w, &full[s], n0, kt * kNarrowRaw);
      }
    }
    return;
  }

  // ---- consumers: out^T += deq(W)^T x^T over their half of each step
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  float acc[TM / 2];
#pragma unroll
  for (int i = 0; i < TM / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  unsigned char* deq = smem + S::off_deq + w * S::deq;
  for (int j = 0; j < nk; ++j) {
    const int s = j % kSt;
    const unsigned char* st = ring + s * S::stage;
    mbar_wait(&full[s], (j / kSt) & 1);
    dequant_rows<T, INT4, kNarrowCols, kNarrowRaw / 2>(
        st + S::boxes * S::xbox + w * (kNarrowRaw / 2) * kNarrowCols, deq, S::deq, t);
    fence_proxy_async();
    bar_sync(1 + w, 128);                  // this consumer's tile is written
    const uint64_t da = desc_sw128(deq, 64 * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHalfK / 16; ++kk)
      WgmmaSS<TM, 1, 0, T>::mma(
          acc, desc_advance(da, kk * 16 * 128),
          desc_advance(desc_sw128(st + (w * kHalfK / 64 + kk / 4) * S::xbox, 16, 1024),
                       (kk % 4) * 32));
    wgmma_commit();
    wgmma_wait<0>();                       // the tile and the stage are read
    if ((t & 31) == 0) mbar_arrive(&empty[s]);
  }
  fence_regs(acc);
  // consumer 1's sums through the ring (every stage consumed), element-major
  float* red = reinterpret_cast<float*>(ring);
  bar_sync(3, 256);
  if (w == 1) {
#pragma unroll
    for (int i = 0; i < TM / 2; ++i) red[i * 128 + t] = acc[i];
  }
  bar_sync(3, 256);
  if (w == 1) return;
  // the fragment holds out^T: element i is column n0 + frag_row, row frag_col
#pragma unroll
  for (int i = 0; i < TM / 2; ++i) {
    const float v = acc[i] + red[i * 128 + t];
    const int col = n0 + frag_row(t, i), row = frag_col(t, i);
    if (row < M && col < N) {
      if (ws != nullptr)
        ws[((int64_t)split * M + row) * N + col] = v;
      else
        store_out(out, (int64_t)row * N + col, v * __ldg(scale + col), out_code);
    }
  }
}

// out = cast(scale * (ws[0] + ws[1] + ... + ws[splits - 1])), in that order
__global__ void __launch_bounds__(256)
wo_splitk_finish(const float* __restrict__ ws, const float* __restrict__ scale,
                 void* __restrict__ out, int M, int N, int splits, int out_code) {
  const int64_t total = (int64_t)M * N;
  for (int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * 256) {
    float acc = ws[i];
    for (int s = 1; s < splits; ++s) acc += ws[s * total + i];
    store_out(out, i, acc * __ldg(scale + i % N), out_code);
  }
}

// ------------------------------------------------------------- wide form ---

constexpr int kWideBN = 128;
constexpr int kWideStages = 5;

// the raw codes of a wide step: [32 packed | 64 k rows x 128 columns]
template <bool INT4>
constexpr int kWideRaw = INT4 ? 32 * kWideBN : 64 * kWideBN;

// the per-column scale on each fp32 sum
struct ScaleEpi {
  const float* scale;
  int N;
  __device__ __forceinline__ float operator()(float a, int col) const {
    return col < N ? a * __ldg(scale + col) : 0.f;
  }
};

// The consumers' stage hook: consumer w dequantizes raw rows [R w, R w + R)
// of the stage (R: half its rows) into the stage's B tile, fences the proxy
// and meets the other consumer at named barrier 1 before the products.
template <typename T, bool INT4>
struct WideDequant {
  int w, t;
  __device__ __forceinline__ void operator()(unsigned char* a_s) const {
    using S = wide90::Smem<kWideBN, kWideRaw<INT4>, kWideStages>;
    constexpr int kHalf = INT4 ? 16 : 32;
    dequant_rows<T, INT4, kWideBN, kHalf>(a_s + S::a + S::b + w * kHalf * kWideBN,
                                          a_s + S::a + w * 32 * 128, 64 * 128, t);
    fence_proxy_async();
    bar_sync(1, 256);
  }
};

// wide90's tile body: warpgroup 0's thread 0 issues TMA for each step's x
// tile and raw codes into a kWideStages-deep ring; the two consumer
// warpgroups dequantize the codes into B (WideDequant), run the wgmma and
// the epilogue with the per-column scale.
template <typename T, bool INT4>
__global__ void __launch_bounds__(wide90::kThreads, 1)
wo_wide_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ scale, void* __restrict__ out, int M, int K, int N,
               int out_code) {
  namespace w9 = wide90;
  using S = w9::Smem<kWideBN, kWideRaw<INT4>, kWideStages>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::off_bar);
  uint64_t* empty = full + kWideStages;
  int m0, n0;
  w9::tile_origin(M, N, kWideBN, m0, n0);
  const int nk = (K + w9::kBK - 1) / w9::kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);             // the consumers' warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup_idx() == 0) {              // ---- producer: one thread
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_x);
      tma_prefetch_map(&tm_w);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kWideStages;
        unsigned char* a_s = smem + s * S::stage;
        mbar_wait(&empty[s], ((kt / kWideStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], S::a + kWideRaw<INT4>);
        tma_load_2d(a_s, &tm_x, &full[s], kt * w9::kBK, m0);
        tma_load_2d(a_s + S::a + S::b, &tm_w, &full[s], n0, INT4 ? kt * 32 : kt * w9::kBK);
      }
    }
  } else {                                 // ---- consumers: rows m0 + 64 w ..
    const int w = warpgroup_idx() - 1, t = threadIdx.x % 128;
    float acc[kWideBN / 2];
    w9::mainloop<kWideBN, T, kWideStages>(acc, smem, S::stage, full, empty, nk, w, t,
                                          WideDequant<T, INT4>{w, t});
    w9::epilogue<kWideBN>(acc, smem, out, out_code, M, N, m0, n0, w, t, ScaleEpi{scale, N});
  }
}

// ---------------------------------------------------------------- launch ---

// the codes as a 2-D uint8 map [rows x n], box `cols` columns x `rows_box`
// rows, no swizzle (the dequant reads them in place)
bool encode_codes(CUtensorMap* map, const void* w, int rows, int n, int cols, int rows_box) {
  const uint64_t dims[2] = {(uint64_t)n, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)n};
  const uint32_t box[2] = {(uint32_t)cols, (uint32_t)rows_box};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_NONE, w, 2, dims,
                    strides, box);
}

template <typename T>
bool encode_rows(CUtensorMap* map, const void* x, int m, int k, int rows_box) {
  const uint64_t dims[2] = {(uint64_t)k, (uint64_t)m};
  const uint64_t strides[1] = {(uint64_t)k * 2};
  const uint32_t box[2] = {64, (uint32_t)rows_box};
  return encode_bf16(map, x, 2, dims, strides, box, wide90::map_type<T>());
}

template <typename T, bool INT4, int TM>
cudaError_t launch_narrow(const void* x, const void* w, const float* scale, void* out, float* ws,
                          int m, int k, int n, int out_code, int splits, int sps,
                          cudaStream_t s) {
  CUtensorMap tx, tw;
  if (!encode_rows<T>(&tx, x, m, k, TM) ||
      !encode_codes(&tw, w, INT4 ? (k + 1) / 2 : k, n, kNarrowCols, kNarrowRaw))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = NarrowSmem<TM, INT4>::bytes;
  const cudaError_t attr = allow_dynamic_smem<wo_narrow_kernel<T, INT4, TM>>(bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + kNarrowCols - 1) / kNarrowCols, splits);
  wo_narrow_kernel<T, INT4, TM><<<grid, kNarrowThreads, bytes, s>>>(
      tx, tw, scale, out, splits > 1 ? ws : nullptr, m, k, n, out_code, sps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int64_t total = (int64_t)m * n;
  const int blocks = static_cast<int>(total / 256 + 1 < 132 * 8 ? total / 256 + 1 : 132 * 8);
  wo_splitk_finish<<<blocks, 256, 0, s>>>(ws, scale, out, m, n, splits, out_code);
  return cudaGetLastError();
}

template <typename T, bool INT4>
cudaError_t launch_wide(const void* x, const void* w, const float* scale, void* out, int m, int k,
                        int n, int out_code, cudaStream_t s) {
  CUtensorMap tx, tw;
  if (!encode_rows<T>(&tx, x, m, k, wide90::kRows) ||
      !encode_codes(&tw, w, INT4 ? (k + 1) / 2 : k, n, kWideBN, INT4 ? 32 : wide90::kBK))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = wide90::Smem<kWideBN, kWideRaw<INT4>, kWideStages>::bytes;
  const cudaError_t e =
      prepare_warp_specialized<wo_wide_kernel<T, INT4>>(bytes, wide90::kThreads, 0);
  if (e != cudaSuccess) return e;
  wo_wide_kernel<T, INT4><<<wide90::grid_size(m, n, kWideBN), wide90::kThreads, bytes, s>>>(
      tx, tw, scale, out, m, k, n, out_code);
  return cudaGetLastError();
}

template <typename T, bool INT4>
cudaError_t launch_as(const void* x, const void* w, const float* scale, void* out, float* ws,
                      int m, int k, int n, int out_code, int tm, int splits, int sps,
                      cudaStream_t s) {
#define PTT_ARGS x, w, scale, out, ws, m, k, n, out_code, splits, sps, s
  switch (tm) {
    case 0: return launch_wide<T, INT4>(x, w, scale, out, m, k, n, out_code, s);
    case 8: return launch_narrow<T, INT4, 8>(PTT_ARGS);
    case 16: return launch_narrow<T, INT4, 16>(PTT_ARGS);
    case 32: return launch_narrow<T, INT4, 32>(PTT_ARGS);
    case 64: return launch_narrow<T, INT4, 64>(PTT_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PTT_ARGS
}

}  // namespace

// ptt_weight_only_sm90: out [m, n] = cast(scale * (x [m, k] @ q)) with
// ptt_weight_only's operands (q int8 [k, n], or packed [ceil(k/2), n] with
// int4 = 1; scale fp32 [n]; x_dtype 1 bf16 or 2 fp16; out_dtype 0 fp32, 1
// bf16, 2 fp16), plus the plan of kernels/weight_only.py:wo_plan: tm 0 runs
// the wide form, tm 8/16/32/64 (>= m) the narrow one over `splits` splits of
// `steps_per_split` 128-deep k-steps, with ws an fp32 workspace [splits, m,
// n] when splits > 1.  k must be a multiple of 8, n of 16, and x, q and out
// 16-byte aligned (the wrapper's route rule).  Returns cudaErrorInvalidValue
// for anything else or when a tensor map cannot be encoded, otherwise the
// cudaError_t of the launches (0 = success).
extern "C" int ptt_weight_only_sm90(const void* x, const void* w, const void* scale, void* out,
                                    void* ws, int m, int k, int n, int int4, int x_dtype,
                                    int out_dtype, int tm, int splits, int steps_per_split,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || k <= 0 || n <= 0 || k % 8 || n % 16 || out_dtype < 0 || out_dtype > 2 ||
      (x_dtype != 1 && x_dtype != 2) || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tm != 0) {
    const int k_step = int4 ? 2 * kNarrowRaw : kNarrowRaw;
    const int nk = (k + k_step - 1) / k_step;
    if (m > tm || splits < 1 || steps_per_split < 1 || (int64_t)splits * steps_per_split < nk ||
        (splits - 1) * steps_per_split >= nk || (splits > 1 && ws == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* sc = static_cast<const float*>(scale);
  float* wsp = static_cast<float*>(ws);
#define PTT_ARGS x, w, sc, out, wsp, m, k, n, out_dtype, tm, splits, steps_per_split, s
  if (x_dtype == 1)
    return static_cast<int>(int4 ? launch_as<__nv_bfloat16, true>(PTT_ARGS)
                                 : launch_as<__nv_bfloat16, false>(PTT_ARGS));
  return static_cast<int>(int4 ? launch_as<__half, true>(PTT_ARGS)
                               : launch_as<__half, false>(PTT_ARGS));
#undef PTT_ARGS
}
