// Grouped (ragged) expert matmul for Hopper (sm_90a), the MoE compute op.
//
// Replaces: paddle_tpu/kernels/grouped_matmul.py:_gmm_kernel (the Pallas TPU
// kernel, forward form) together with its fused row gather _gather_rows,
// both launched there by gmm.  It computes what the plain _gmm_reference
// computes:
//
//   out[m, :] = lhs[rows[m], :] @ rhs[tile_groups[m / bm]]      (rows given)
//   out[m, :] = lhs[m, :]       @ rhs[tile_groups[m / bm]]      (rows null)
//
// lhs [L, C] (the un-permuted token buffer when rows are given, else
// [M, C]), rhs [E, C, O] row-major, tile_groups [M / bm] int32, rows [M]
// int32; out [M, O] in lhs's dtype, accumulated in fp32.  Rows are sorted
// by expert outside the kernel so every bm-row tile belongs to one expert.
// The trans_rhs and row_scale modes (the MoE backward) are not here.
//
// What bounds it on this card:
// - decode (a handful of rows per expert): bytes.  Every expert that owns
//   a tile has its whole [C, O] weight read; at Mixtral widths that is
//   8 x 4096 x 14336 x 2 B = 940 MB per call, 0.28 ms at 3.35 TB/s, against
//   a few hundred MFLOP.
// - prefill (hundreds of rows per expert): operations.  2 M C O flops at
//   989 TFLOP/s (bf16 tensor cores); fp32 inputs use plain FMA (67 TFLOP/s)
//   because the fp32 path must match fp32 references to 1e-5, which TF32
//   would not.
//
// What the design does about it (simple first, fast later):
// - One thread block per (row tile of TM rows, 64 output columns).  TM is
//   the largest of 64/32/16/8 that divides bm, so a block never straddles
//   two experts; the block reads its expert id once.  blockIdx.x walks the
//   row tiles, so blocks that run together share one expert's weight
//   columns through L2.
// - The dispatch gather is fused: each block reads its TM source-row
//   indices from rows[] on the device and loads those lhs rows straight
//   into shared memory (16-byte vector loads), so no [M, C] permuted copy
//   is ever written.  Rows that point at the caller's zero sentinel row
//   come out exactly 0.
// - bf16: WMMA 16x16x16 bf16 fragments (mma.sync on the tensor cores) with
//   fp32 accumulators, K staged 32 at a time; a TM of 8 pads the MMA's
//   rows 8-15 with zeros.  fp32: a register-tiled FMA loop, 4 columns by
//   TM/8 rows per thread.
// - The epilogue stages the fp32 tile in shared memory and writes it back
//   in lhs's dtype with 16-byte stores.
// Later work (not here): wgmma with TMA-fed multi-stage shared-memory
// rings, a persistent grid, and skipping tiles made only of padding rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // contraction depth staged per step
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ int expert_of(const int32_t* tile_groups, int m0, int bm,
                                         int E) {
  const int g = tile_groups[m0 / bm];
  return min(max(g, 0), E - 1);
}

__device__ __forceinline__ int64_t source_row(const int32_t* rows, int m, int L) {
  const int src = rows ? rows[m] : m;
  return (int64_t)min(max(src, 0), L - 1);
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                const __nv_bfloat16* __restrict__ rhs,
                const int32_t* __restrict__ tile_groups,
                const int32_t* __restrict__ rows, __nv_bfloat16* __restrict__ out,
                int C, int O, int E, int L, int bm) {
  constexpr int TMP = TM < 16 ? 16 : TM;      // MMA rows; rows >= TM stay 0
  constexpr int WM = TMP >= 32 ? 2 : 1;       // warps along M
  constexpr int WN = 4 / WM;                  // warps along N
  constexpr int FM = TMP / 16 / WM;           // 16-row fragments per warp
  constexpr int FN = kBN / WN / 16;           // 16-col fragments per warp
  constexpr int LDA = kBK + 8;                // +16 bytes: fewer bank conflicts
  constexpr int LDB = kBN + 8;
  constexpr int LDC = kBN + 4;
  __shared__ __align__(32) __nv_bfloat16 a_s[TMP][LDA];
  __shared__ __align__(32) __nv_bfloat16 b_s[kBK][LDB];
  __shared__ __align__(32) float c_s[TMP][LDC];
  __shared__ int64_t src_row[TM];

  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const __nv_bfloat16* w =
      rhs + (int64_t)expert_of(tile_groups, m0, bm, E) * C * O;

  for (int r = tid; r < TM; r += kThreads) src_row[r] = source_row(rows, m0 + r, L);
  for (int i = tid; i < (TMP - TM) * LDA; i += kThreads)
    a_s[TM + i / LDA][i % LDA] = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  __syncthreads();

  for (int k0 = 0; k0 < C; k0 += kBK) {
    // gathered lhs rows: TM x kBK, 8 bf16 (16 bytes) per load
    for (int i = tid; i < TM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c8 = (i % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&a_s[r][c8]) =
          *reinterpret_cast<const uint4*>(lhs + src_row[r] * C + k0 + c8);
    }
    // the expert's weight tile: kBK x kBN
    for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c8 = (i % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(&b_s[r][c8]) =
          *reinterpret_cast<const uint4*>(w + (int64_t)(k0 + r) * O + n0 + c8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &a_s[(wm * FM + i) * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &b_s[kk][(wn * FN + j) * 16], LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&c_s[(wm * FM + i) * 16][(wn * FN + j) * 16], acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TM * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c8 = (i % (kBN / 8)) * 8;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(c_s[r][c8 + e]);
    *reinterpret_cast<uint4*>(out + (int64_t)(m0 + r) * O + n0 + c8) =
        *reinterpret_cast<const uint4*>(v);
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               const int32_t* __restrict__ tile_groups,
               const int32_t* __restrict__ rows, float* __restrict__ out, int C,
               int O, int E, int L, int bm) {
  constexpr int RM = TM / 8;                  // rows per thread
  __shared__ float a_s[TM][kBK + 1];          // +1: distinct banks per row
  __shared__ __align__(16) float b_s[kBK][kBN];
  __shared__ int64_t src_row[TM];

  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;     // columns tx + 16 j, rows ty + 8 i
  const float* w = rhs + (int64_t)expert_of(tile_groups, m0, bm, E) * C * O;

  for (int r = tid; r < TM; r += kThreads) src_row[r] = source_row(rows, m0 + r, L);
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < C; k0 += kBK) {
    for (int i = tid; i < TM * (kBK / 4); i += kThreads) {
      const int r = i / (kBK / 4), c4 = (i % (kBK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(lhs + src_row[r] * C + k0 + c4);
      a_s[r][c4] = v.x;
      a_s[r][c4 + 1] = v.y;
      a_s[r][c4 + 2] = v.z;
      a_s[r][c4 + 3] = v.w;
    }
    for (int i = tid; i < kBK * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), c4 = (i % (kBN / 4)) * 4;
      *reinterpret_cast<float4*>(&b_s[r][c4]) =
          *reinterpret_cast<const float4*>(w + (int64_t)(k0 + r) * O + n0 + c4);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = a_s[ty + 8 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(int64_t)(m0 + ty + 8 * i) * O + n0 + tx + 16 * j] = acc[i][j];
}

template <typename T, int TM>
cudaError_t launch(const void* lhs, const void* rhs, const void* tg, const void* rows,
                   void* out, int M, int C, int O, int E, int L, int bm,
                   cudaStream_t stream) {
  dim3 grid(M / TM, O / kBN);
  if constexpr (sizeof(T) == 2) {
    gmm_bf16_kernel<TM><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(rhs),
        static_cast<const int32_t*>(tg), static_cast<const int32_t*>(rows),
        static_cast<__nv_bfloat16*>(out), C, O, E, L, bm);
  } else {
    gmm_f32_kernel<TM><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs),
        static_cast<const int32_t*>(tg), static_cast<const int32_t*>(rows),
        static_cast<float*>(out), C, O, E, L, bm);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tm(int tm, const void* lhs, const void* rhs, const void* tg,
                      const void* rows, void* out, int M, int C, int O, int E, int L,
                      int bm, cudaStream_t s) {
  switch (tm) {
    case 8: return launch<T, 8>(lhs, rhs, tg, rows, out, M, C, O, E, L, bm, s);
    case 16: return launch<T, 16>(lhs, rhs, tg, rows, out, M, C, O, E, L, bm, s);
    case 32: return launch<T, 32>(lhs, rhs, tg, rows, out, M, C, O, E, L, bm, s);
    case 64: return launch<T, 64>(lhs, rhs, tg, rows, out, M, C, O, E, L, bm, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16 (lhs, rhs and out alike).  rows may be null (lhs is then
// [M, C]); L is lhs's row count.  tm (8, 16, 32 or 64) must divide bm, M
// must be a multiple of bm, C of 32 and O of 64, and lhs/rhs/out must be
// 16-byte aligned; the Python wrapper checks all of it.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int ptt_gmm(const void* lhs, const void* rhs, const void* tile_groups,
                       const void* rows, void* out, int M, int C, int O, int E,
                       int L, int bm, int tm, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_tm<float>(tm, lhs, rhs, tile_groups, rows, out, M, C, O, E, L, bm, s);
  else if (dtype == 1)
    err = launch_tm<__nv_bfloat16>(tm, lhs, rhs, tile_groups, rows, out, M, C, O, E,
                                   L, bm, s);
  return static_cast<int>(err);
}
