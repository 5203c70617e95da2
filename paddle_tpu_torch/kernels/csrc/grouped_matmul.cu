// Grouped (ragged) expert matmuls for Hopper (sm_90a): the MoE compute ops,
// forward and backward.
//
// Replaces, in paddle_tpu/kernels/grouped_matmul.py (the Pallas TPU
// kernels):
// - _gmm_kernel (with its fused row gather _gather_rows), launched there by
//   gmm, in all its modes, for fp32 operands (bf16 takes the "sm90" route,
//   grouped_matmul_sm90.cu; kernels/grouped_matmul.py:_route): ptt_gmm
//   computes what the plain _gmm_reference computes,
//
//     out[m, :] = s[m] * lhs[rows[m], :] @ W[tile_groups[m / bm]]
//
//   with W = rhs[e] ([C, O], the forward) or rhs[e]^T (trans_rhs: rhs
//   [E, O, C], the backward's dlhs); rows null reads lhs[m]; s null is 1,
//   else s[m] multiplies the gathered row in lhs's dtype before the MMA
//   (row_scale: the combine weight of the backward).
// - _tgmm_kernel, launched there by tgmm: ptt_tgmm computes what the plain
//   _tgmm_reference computes, the per-expert weight gradient
//
//     out[e] = sum over the rows m of e's tiles of
//              lhs[lrows[m], :]^T (x) s[m] * rhs[rrows[m], :]      [K, N]
//
//   (lrows/rrows null read row m; s null is 1, else s[m] multiplies the
//   gathered rhs row in rhs's dtype), and zeros for an expert that owns no
//   tile (the reference's `visited` mask).
// Rows are sorted by expert outside the kernels so every bm-row tile
// belongs to one expert (tile_groups [M / bm] int32, nondecreasing).  All
// outputs are in lhs's dtype, accumulated in fp32.
//
// What bounds them on this card:
// - decode (a handful of rows per expert, gmm only): bytes.  Every expert
//   that owns a tile has its whole [C, O] weight read; at Mixtral widths
//   that is 8 x 4096 x 14336 x 2 B = 940 MB per call, 0.28 ms at 3.35 TB/s.
// - prefill and training (hundreds to thousands of rows per expert):
//   operations.  2 M C O (gmm) or 2 M K N (tgmm) flops at 989 TFLOP/s
//   (bf16 tensor cores), counting the live rows: at the Mixtral training
//   shape (M = 20480 padded rows, 16384 of them live, H 4096, I 14336)
//   1.95 ms a call.  The padding rows read the zero sentinel and add
//   nothing; these kernels still compute them (2.43 ms of work on all M
//   rows).  fp32 inputs use plain FMA (67 TFLOP/s), not TF32,
//   because the fp32 path must match fp32 references to 1e-5.
//
// What the designs do about it (simple first, fast later):
// - gmm (fp32): one thread block per (row tile of TM rows, 64 output
//   columns).  TM is the largest of 64/32/16/8 that divides bm, so a block never
//   straddles two experts; the block reads its expert id once.  blockIdx.x
//   walks the row tiles, so blocks that run together share one expert's
//   weight columns through L2.  The dispatch gather is fused: each block
//   reads its TM source-row indices from rows[] on the device and loads
//   those lhs rows straight into shared memory (16-byte vector loads), so
//   no [M, C] permuted copy is ever written; rows that point at the
//   caller's zero sentinel row come out exactly 0.  The row scale is
//   applied as a row is staged.  trans_rhs stages a [64 out, 32 contract]
//   slice of W^T row by row from the [O, C] layout (16-byte loads along
//   C), so nothing is transposed element by element.
// - tgmm: one thread block per (output tile, expert), the output tile
//   128 x 128 (8 warps) when K and N allow it, else 64 x 64 (4 warps).
//   The block finds its expert's contiguous row span with a binary search
//   over tile_groups on the device (no host read), then walks it 32 rows
//   at a time: it gathers lhs columns [k0, k0 + TK) and the scaled rhs
//   columns [n0, n0 + TN) of each row into shared memory (the next rows'
//   loads are issued into registers before the current rows' MMAs) and
//   accumulates lhs^T rhs in fp32 fragments for the whole span, so the
//   reduction over thousands of rows never leaves registers.  lhs goes in
//   as a col_major matrix_a fragment (that is lhs^T).  Rows past the span
//   read as zeros; sentinel rows point at the caller's zero row.
// - tgmm bf16: WMMA 16x16x16 bf16 fragments (mma.sync on the tensor
//   cores) with fp32 accumulators.  fp32: register-tiled FMA loops.
// - Epilogues stage fp32 results in shared memory and write them in lhs's
//   dtype with 16-byte stores (bf16).
// Later work (not here): tgmm on wgmma with TMA-fed shared-memory rings,
// as grouped_matmul_sm90.cu does for gmm.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBN = 64;        // gmm: output columns per block
constexpr int kBK = 32;        // gmm: contraction depth staged per step
constexpr int kThreads = 128;  // gmm: 4 warps
constexpr int kRows = 32;      // tgmm: rows staged per step

__device__ __forceinline__ int expert_of(const int32_t* tile_groups, int m0, int bm,
                                         int E) {
  const int g = tile_groups[m0 / bm];
  return min(max(g, 0), E - 1);
}

__device__ __forceinline__ int64_t source_row(const int32_t* rows, int m, int L) {
  const int src = rows ? rows[m] : m;
  return (int64_t)min(max(src, 0), L - 1);
}

// 8 bf16 (16 bytes) times a bf16 scale, each product rounded to bf16 (the
// product of two bf16 values is exact in fp32, so this is bf16 arithmetic).
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = __float2bfloat16(__bfloat162float(x[e]) * s);
  return v;
}

// First tile t in [0, T) with tile_groups[t] >= g (tile_groups nondecreasing).
__device__ __forceinline__ int first_tile(const int32_t* tile_groups, int T, int g) {
  int lo = 0, hi = T;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (tile_groups[mid] < g) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ------------------------------------------------------------------- gmm ---

template <int TM, bool TRANS>
__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               const int32_t* __restrict__ tile_groups,
               const int32_t* __restrict__ rows, const float* __restrict__ scale,
               float* __restrict__ out, int C, int O, int E, int L, int bm) {
  constexpr int RM = TM / 8;                  // rows per thread
  __shared__ float a_s[TM][kBK + 1];          // +1: distinct banks per row
  // [k][n] (forward) or [n][k] (trans_rhs; +1: column reads hit distinct banks)
  __shared__ __align__(16) float b_s[TRANS ? kBN : kBK][TRANS ? kBK + 1 : kBN];
  __shared__ int64_t src_row[TM];
  __shared__ float row_scale[TM];

  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;     // columns tx + 16 j, rows ty + 8 i
  const float* w = rhs + (int64_t)expert_of(tile_groups, m0, bm, E) * C * O;

  for (int r = tid; r < TM; r += kThreads) {
    src_row[r] = source_row(rows, m0 + r, L);
    row_scale[r] = scale ? scale[m0 + r] : 1.f;
  }
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < C; k0 += kBK) {
    for (int i = tid; i < TM * (kBK / 4); i += kThreads) {
      const int r = i / (kBK / 4), c4 = (i % (kBK / 4)) * 4;
      float4 v = *reinterpret_cast<const float4*>(lhs + src_row[r] * C + k0 + c4);
      if (scale) {
        const float s = row_scale[r];
        v.x *= s; v.y *= s; v.z *= s; v.w *= s;
      }
      a_s[r][c4] = v.x;
      a_s[r][c4 + 1] = v.y;
      a_s[r][c4 + 2] = v.z;
      a_s[r][c4 + 3] = v.w;
    }
    if constexpr (!TRANS) {
      for (int i = tid; i < kBK * (kBN / 4); i += kThreads) {
        const int r = i / (kBN / 4), c4 = (i % (kBN / 4)) * 4;
        *reinterpret_cast<float4*>(&b_s[r][c4]) =
            *reinterpret_cast<const float4*>(w + (int64_t)(k0 + r) * O + n0 + c4);
      }
    } else {
      for (int i = tid; i < kBN * (kBK / 4); i += kThreads) {
        const int r = i / (kBK / 4), c4 = (i % (kBK / 4)) * 4;
        const float4 v =
            *reinterpret_cast<const float4*>(w + (int64_t)(n0 + r) * C + k0 + c4);
        b_s[r][c4] = v.x;
        b_s[r][c4 + 1] = v.y;
        b_s[r][c4 + 2] = v.z;
        b_s[r][c4 + 3] = v.w;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (TRANS)
          b[j] = b_s[tx + 16 * j][kk];
        else
          b[j] = b_s[kk][tx + 16 * j];
      }
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

template <int TM, bool TRANS>
cudaError_t launch_gmm(const void* lhs, const void* rhs, const void* tg,
                       const void* rows, const void* scale, void* out, int M, int C,
                       int O, int E, int L, int bm, cudaStream_t stream) {
  dim3 grid(M / TM, O / kBN);
  gmm_f32_kernel<TM, TRANS><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(rhs),
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(rows),
      static_cast<const float*>(scale), static_cast<float*>(out), C, O, E, L, bm);
  return cudaGetLastError();
}

template <bool TRANS>
cudaError_t launch_gmm_tm(int tm, const void* lhs, const void* rhs, const void* tg,
                          const void* rows, const void* scale, void* out, int M,
                          int C, int O, int E, int L, int bm, cudaStream_t s) {
  switch (tm) {
    case 8:
      return launch_gmm<8, TRANS>(lhs, rhs, tg, rows, scale, out, M, C, O, E, L, bm, s);
    case 16:
      return launch_gmm<16, TRANS>(lhs, rhs, tg, rows, scale, out, M, C, O, E, L, bm, s);
    case 32:
      return launch_gmm<32, TRANS>(lhs, rhs, tg, rows, scale, out, M, C, O, E, L, bm, s);
    case 64:
      return launch_gmm<64, TRANS>(lhs, rhs, tg, rows, scale, out, M, C, O, E, L, bm, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ tgmm ---

// bf16: a TK x TN output tile per block, WK x WN warps, each warp FK x FN
// 16 x 16 fragments.  Shared memory: two 32-row staging tiles and one
// 16 x 16 fp32 epilogue tile per warp.
template <int TK, int TN, int WK, int WN>
__global__ void __launch_bounds__(WK * WN * 32)
tgmm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                 const __nv_bfloat16* __restrict__ rhs,
                 const int32_t* __restrict__ tile_groups,
                 const int32_t* __restrict__ lrows, const int32_t* __restrict__ rrows,
                 const __nv_bfloat16* __restrict__ rscale,
                 __nv_bfloat16* __restrict__ out, int K, int N, int Ll, int Lr, int bm,
                 int T) {
  constexpr int NT = WK * WN * 32;
  constexpr int FK = TK / 16 / WK, FN = TN / 16 / WN;
  constexpr int LDA = TK + 8, LDB = TN + 8;   // +16 bytes: fewer bank conflicts
  constexpr int CA = TK / 8, CB = TN / 8;     // 16-byte chunks per staged row
  constexpr int NA = kRows * CA / NT, NB = kRows * CB / NT;
  static_assert(NA * NT == kRows * CA && NB * NT == kRows * CB, "staging split");
  __shared__ __align__(32) __nv_bfloat16 a_s[kRows][LDA];   // lhs rows: A^T
  __shared__ __align__(32) __nv_bfloat16 b_s[kRows][LDB];   // rhs rows
  __shared__ __align__(32) float c_s[WK * WN][16][20];

  const int k0 = blockIdx.x * TK, n0 = blockIdx.y * TN, e = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wk = warp / WN, wn = warp % WN;
  const int r0 = first_tile(tile_groups, T, e) * bm;
  const int r1 = first_tile(tile_groups, T, e + 1) * bm;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FK][FN];
#pragma unroll
  for (int i = 0; i < FK; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // rows [m0, m0 + kRows) of the span into registers; past the span: zeros
  uint4 ra[NA], rb[NB];
  float sb[NB];
  auto fetch = [&](int m0) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int idx = tid + i * NT, r = idx / CA, c8 = (idx % CA) * 8, m = m0 + r;
      ra[i] = make_uint4(0, 0, 0, 0);
      if (m < r1)
        ra[i] = *reinterpret_cast<const uint4*>(lhs + source_row(lrows, m, Ll) * K +
                                                k0 + c8);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int idx = tid + i * NT, r = idx / CB, c8 = (idx % CB) * 8, m = m0 + r;
      rb[i] = make_uint4(0, 0, 0, 0);
      sb[i] = 1.f;
      if (m < r1) {
        rb[i] = *reinterpret_cast<const uint4*>(rhs + source_row(rrows, m, Lr) * N +
                                                n0 + c8);
        if (rscale) sb[i] = __bfloat162float(rscale[m]);
      }
    }
  };

  if (r0 < r1) fetch(r0);
  for (int m0 = r0; m0 < r1; m0 += kRows) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int idx = tid + i * NT;
      *reinterpret_cast<uint4*>(&a_s[idx / CA][(idx % CA) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int idx = tid + i * NT;
      *reinterpret_cast<uint4*>(&b_s[idx / CB][(idx % CB) * 8]) =
          rscale ? scale8(rb[i], sb[i]) : rb[i];
    }
    __syncthreads();
    if (m0 + kRows < r1) fetch(m0 + kRows);   // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < kRows; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[FK];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FK; ++i)
        wmma::load_matrix_sync(a[i], &a_s[kk][(wk * FK + i) * 16], LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &b_s[kk][(wn * FN + j) * 16], LDB);
#pragma unroll
      for (int i = 0; i < FK; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: one 16 x 16 fragment at a time through the warp's own tile
  __nv_bfloat16* o = out + (int64_t)e * K * N;
  const int row = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FK; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(&c_s[warp][0][0], acc[i][j], 20, wmma::mem_row_major);
      __syncwarp();
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) v[x] = __float2bfloat16(c_s[warp][row][c8 + x]);
      *reinterpret_cast<uint4*>(o + (int64_t)(k0 + (wk * FK + i) * 16 + row) * N + n0 +
                                (wn * FN + j) * 16 + c8) =
          *reinterpret_cast<const uint4*>(v);
      __syncwarp();
    }
}

// fp32: a 64 x 64 output tile per block of 256 threads, 4 x 4 outputs per
// thread on FMA, rows staged 32 at a time as in the bf16 kernel.
constexpr int kTF = 64;
constexpr int kTFThreads = 256;

__global__ void __launch_bounds__(kTFThreads)
tgmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
                const int32_t* __restrict__ tile_groups,
                const int32_t* __restrict__ lrows, const int32_t* __restrict__ rrows,
                const float* __restrict__ rscale, float* __restrict__ out, int K, int N,
                int Ll, int Lr, int bm, int T) {
  constexpr int C4 = kTF / 4;                          // float4 per staged row
  constexpr int NL = kRows * C4 / kTFThreads;          // float4 per thread
  __shared__ __align__(16) float a_s[kRows][kTF];
  __shared__ __align__(16) float b_s[kRows][kTF];

  const int k0 = blockIdx.x * kTF, n0 = blockIdx.y * kTF, e = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;  // n tx + 16 j, k ty + 16 i
  const int r0 = first_tile(tile_groups, T, e) * bm;
  const int r1 = first_tile(tile_groups, T, e + 1) * bm;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = r0; m0 < r1; m0 += kRows) {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int idx = tid + i * kTFThreads, r = idx / C4, c4 = (idx % C4) * 4;
      const int m = m0 + r;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (m < r1) {
        a = *reinterpret_cast<const float4*>(lhs + source_row(lrows, m, Ll) * K + k0 +
                                             c4);
        b = *reinterpret_cast<const float4*>(rhs + source_row(rrows, m, Lr) * N + n0 +
                                             c4);
        if (rscale) {
          const float s = rscale[m];
          b.x *= s; b.y *= s; b.z *= s; b.w *= s;
        }
      }
      *reinterpret_cast<float4*>(&a_s[r][c4]) = a;
      *reinterpret_cast<float4*>(&b_s[r][c4]) = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = out + (int64_t)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[(int64_t)(k0 + ty + 16 * i) * N + n0 + tx + 16 * j] = acc[i][j];
}

template <int TK, int TN, int WK, int WN>
cudaError_t launch_tgmm_bf16(const void* lhs, const void* rhs, const void* tg,
                             const void* lrows, const void* rrows, const void* rscale,
                             void* out, int K, int N, int E, int Ll, int Lr, int bm,
                             int T, cudaStream_t stream) {
  dim3 grid(K / TK, N / TN, E);
  tgmm_bf16_kernel<TK, TN, WK, WN><<<grid, WK * WN * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(rhs),
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(lrows),
      static_cast<const int32_t*>(rrows), static_cast<const __nv_bfloat16*>(rscale),
      static_cast<__nv_bfloat16*>(out), K, N, Ll, Lr, bm, T);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16 (every float operand alike).  Each returns the cudaError_t of
// its launch (0 = success).
//
// ptt_gmm: dtype 0 only (bf16 gmm is grouped_matmul_sm90.cu's
// ptt_gmm_sm90; dtype 1 returns cudaErrorInvalidValue).  rows and scale may
// be null (lhs is then [M, C]; no scale); L is lhs's row count; trans != 0
// reads rhs as [E, O, C].  tm (8, 16, 32 or 64) must divide bm, M must be a
// multiple of bm, C of 32 and O of 64, and the float operands must be
// 16-byte aligned; the Python wrapper checks all of it.
extern "C" int ptt_gmm(const void* lhs, const void* rhs, const void* tile_groups,
                       const void* rows, const void* scale, void* out, int M, int C,
                       int O, int E, int L, int bm, int tm, int trans, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* tg = tile_groups;
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      trans ? launch_gmm_tm<true>(tm, lhs, rhs, tg, rows, scale, out, M, C, O, E, L, bm, s)
            : launch_gmm_tm<false>(tm, lhs, rhs, tg, rows, scale, out, M, C, O, E, L, bm,
                                   s));
}

// ptt_tgmm: out [E, K, N]; lhs [Ll, K] and rhs [Lr, N], read at lrows[m] /
// rrows[m] (or row m when null) for m < M; rscale [M] or null.  T = M / bm
// tiles; K and N must be multiples of 64 and the float operands 16-byte
// aligned; the Python wrapper checks all of it.
extern "C" int ptt_tgmm(const void* lhs, const void* rhs, const void* tile_groups,
                        const void* lrows, const void* rrows, const void* rscale,
                        void* out, int M, int K, int N, int E, int Ll, int Lr, int bm,
                        int T, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)M;
  if (K % 64 || N % 64 || E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    dim3 grid(K / kTF, N / kTF, E);
    tgmm_f32_kernel<<<grid, kTFThreads, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs),
        static_cast<const int32_t*>(tile_groups), static_cast<const int32_t*>(lrows),
        static_cast<const int32_t*>(rrows), static_cast<const float*>(rscale),
        static_cast<float*>(out), K, N, Ll, Lr, bm, T);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) {
    if (K % 128 == 0 && N % 128 == 0)
      return static_cast<int>(launch_tgmm_bf16<128, 128, 4, 2>(
          lhs, rhs, tile_groups, lrows, rrows, rscale, out, K, N, E, Ll, Lr, bm, T, s));
    return static_cast<int>(launch_tgmm_bf16<64, 64, 2, 2>(
        lhs, rhs, tile_groups, lrows, rrows, rscale, out, K, N, E, Ll, Lr, bm, T, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
