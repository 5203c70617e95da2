// The wide wgmma tile body that the primitive library's matmul
// (primitives.cu, the "sm90" route) and the weight-only matmul's prefill form
// (weight_only_sm90.cu, the "wide" route) share.
//
// A CTA computes out[m0 .. m0 + 128, n0 .. n0 + BN) = epi(x @ B) with an fp32
// sum: 384 threads, warpgroup 0 the producer, warpgroups 1 and 2 the
// consumers of 64 rows each (m64nBNk16, both operands in shared memory).
// Each of kStages ring stages holds
//   - A, the x tile [128 rows x 64 k] K-major (TMA, 128-byte swizzle, 16 KB),
//   - B, the weight tile [64 k x BN] MN-major: BN / 64 column blocks of
//     [64 k rows x 64 columns] in the 128-byte swizzle, 8 KB each (TMA writes
//     it for the matmul; the weight-only consumers dequantize into it),
//   - RAW further bytes the kernel may use (the weight-only raw codes).
// The consumers wait on full[s], run the caller's `prep` on the stage (the
// weight-only form dequantizes its half of B there), run the stage's four
// k16 products, keep one stage's products in flight and release a stage on
// empty[s] (one arrival a consumer warp) when its products are done.  The
// epilogue applies the caller's functor to each fp32 sum (with its column),
// casts once to the output dtype, stages the tile in the ring (its rows
// padded by 16 bytes) and writes it out 16 bytes at a time, masked to
// [M, N].
//
// The tile walk goes in groups of kGroupRows row tiles, all column tiles of
// a group before the next, so the CTAs that run together share their x rows
// and weight columns through L2.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace wide90 {

using namespace sm90;

constexpr int kRows = 128;              // rows of a CTA's tile, 64 a consumer
constexpr int kBK = 64;                 // contraction per k-step: one 128-byte row
constexpr uint32_t kRowBytes = 128;
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kGroupRows = 16;          // row tiles a raster group walks
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kRegsNeeded = kProducerRegs * 128 + kConsumerRegs * 256;   // setmaxnreg

template <int BN, int RAW = 0, int STAGES = kStages>
struct Smem {
  static constexpr uint32_t a = kRows * kRowBytes;          // 16 KB
  static constexpr uint32_t b = BN * kRowBytes;             // BN / 64 blocks of 8 KB
  static constexpr uint32_t stage = a + b + RAW;            // a multiple of 1024
  static constexpr uint32_t off_bar = STAGES * stage;
  static constexpr uint32_t bytes = off_bar + 2 * STAGES * 8 + 1024;   // + alignment
  static_assert(RAW % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(bytes <= 232448, "wide stages exceed shared memory");
};

// This CTA's tile origin: groups of kGroupRows row tiles, column tiles outer.
__device__ __forceinline__ void tile_origin(int M, int N, int BN, int& m0, int& n0) {
  const int n_mt = (M + kRows - 1) / kRows, n_nt = (N + BN - 1) / BN;
  const int per_group = kGroupRows * n_nt;
  const int group = blockIdx.x / per_group, first = group * kGroupRows;
  const int g_rows = min(kGroupRows, n_mt - first);
  const int in = blockIdx.x % per_group;
  m0 = (first + in % g_rows) * kRows;
  n0 = (in / g_rows) * BN;
}

inline int grid_size(int M, int N, int BN) {
  return ((M + kRows - 1) / kRows) * ((N + BN - 1) / BN);
}

// nothing to do to a stage before its products (the matmul's TMA wrote it)
struct NoPrep {
  __device__ __forceinline__ void operator()(unsigned char*) const {}
};

// The consumers' k-loop: acc = x rows [64 w, 64 w + 64) of the tile @ B over
// nk stages of a STAGES-deep ring (stage_bytes apart), prep(stage) after
// each stage has landed.  w is the consumer (0, 1), t its thread (0 .. 127).
template <int BN, typename T, int STAGES, typename Prep>
__device__ __forceinline__ void mainloop(float (&acc)[BN / 2], unsigned char* smem,
                                         uint32_t stage_bytes, uint64_t* full, uint64_t* empty,
                                         int nk, int w, int t, const Prep& prep) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    unsigned char* a_s = smem + s * stage_bytes;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    prep(a_s);
    const uint64_t da = desc_sw128(a_s + w * 64 * kRowBytes, 16, 1024);
    const uint64_t db = desc_sw128(a_s + kRows * kRowBytes, 64 * kRowBytes, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      WgmmaSS<BN, 0, 1, T>::mma(acc, desc_advance(da, kk * 32),
                                desc_advance(db, kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait<1>();                       // the previous stage's products are done
    if (kt > 0 && (t & 31) == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

template <typename O>
__device__ __forceinline__ void put2(unsigned char* p, float a, float b);
template <>
__device__ __forceinline__ void put2<float>(unsigned char* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void put2<__nv_bfloat16>(unsigned char* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ void put2<__half>(unsigned char* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The epilogue in output type O: epi(sum, column) on each fp32 sum, one
// cast, staged in the ring (which both consumers have finished reading:
// named barrier 1 over their 256 threads), then 16-byte stores of this
// consumer's 64 rows (named barrier 2 + w over its 128 threads).  N must be
// a multiple of 8 and out 16-byte aligned.
template <int BN, typename O, typename Epi>
__device__ __forceinline__ void epilogue_as(const float (&acc)[BN / 2], unsigned char* smem,
                                            O* __restrict__ out, int M, int N, int m0, int n0,
                                            int w, int t, const Epi& epi) {
  constexpr int kRowB = BN * (int)sizeof(O) + 16;           // padded: 4 banks a row apart
  constexpr int kChunks = BN * (int)sizeof(O) / 16;         // 16-byte chunks a row
  constexpr int kPer = 16 / (int)sizeof(O);
  unsigned char* stage = smem + w * 64 * kRowB;
  bar_sync(1, 256);
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = frag_row(t, i), c = frag_col(t, i);
    put2<O>(stage + r * kRowB + c * (int)sizeof(O), epi(acc[i], n0 + c),
            epi(acc[i + 1], n0 + c + 1));
  }
  bar_sync(2 + w, 128);
  for (int i = t; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const int row = m0 + 64 * w + r, col = n0 + c;
    if (row < M && col < N)
      *reinterpret_cast<uint4*>(out + (int64_t)row * N + col) =
          *reinterpret_cast<const uint4*>(stage + r * kRowB + c * (int)sizeof(O));
  }
}

// The epilogue for an output dtype code (0 fp32, 1 bf16, 2 fp16).
template <int BN, typename Epi>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], unsigned char* smem,
                                         void* out, int out_code, int M, int N, int m0, int n0,
                                         int w, int t, const Epi& epi) {
  if (out_code == 0)
    epilogue_as<BN, float>(acc, smem, static_cast<float*>(out), M, N, m0, n0, w, t, epi);
  else if (out_code == 1)
    epilogue_as<BN, __nv_bfloat16>(acc, smem, static_cast<__nv_bfloat16*>(out), M, N, m0, n0,
                                   w, t, epi);
  else
    epilogue_as<BN, __half>(acc, smem, static_cast<__half*>(out), M, N, m0, n0, w, t, epi);
}

// CUtensorMapDataType of a wgmma operand type
template <typename T>
constexpr CUtensorMapDataType map_type() {
  return kWgmmaF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// x [M, K] (K contiguous) as A's map: box 64 k x 128 rows, 128-byte swizzle.
template <typename T>
inline bool encode_x(CUtensorMap* map, const void* x, int M, int K) {
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t strides[1] = {(uint64_t)K * 2};
  const uint32_t box[2] = {64, kRows};
  return encode_bf16(map, x, 2, dims, strides, box, map_type<T>());
}

}  // namespace wide90
