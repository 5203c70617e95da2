// Grouped (ragged) expert matmuls for Hopper (sm_90a), fp32: the MoE
// compute ops, forward and backward, for fp32 operands (bf16 takes the
// "sm90" route of kernels/grouped_matmul.py:_route: grouped_matmul_sm90.cu
// for gmm, tgmm_sm90.cu for tgmm).
//
// Replaces, in paddle_tpu/kernels/grouped_matmul.py (the Pallas TPU
// kernels):
// - _gmm_kernel (with its fused row gather _gather_rows), launched there by
//   gmm, in all its modes: ptt_gmm computes what the plain _gmm_reference
//   computes,
//
//     out[m, :] = s[m] * lhs[rows[m], :] @ W[tile_groups[m / bm]]
//
//   with W = rhs[e] ([C, O], the forward) or rhs[e]^T (trans_rhs: rhs
//   [E, O, C], the backward's dlhs); rows null reads lhs[m]; s null is 1,
//   else s[m] multiplies the gathered row in lhs's dtype before the MMA
//   (row_scale: the combine weight of the backward).
// - _tgmm_kernel, launched there by tgmm: ptt_tgmm computes what the
//   plain _tgmm_reference computes, the per-expert weight gradient
//
//     out[e] = sum over the rows m of e's tiles of
//              lhs[lrows[m], :]^T (x) s[m] * rhs[rrows[m], :]      [K, N]
//
//   (lrows/rrows null read row m; s null is 1, else s[m] multiplies the
//   gathered rhs row in rhs's dtype), and zeros for an expert that owns no
//   tile (the reference's `visited` mask).
// Rows are sorted by expert outside the kernels so every bm-row tile
// belongs to one expert (tile_groups [M / bm] int32, nondecreasing).  All
// outputs are fp32, accumulated in fp32.
//
// What bounds them on this card: operations, fp32 on plain FMA (67
// TFLOP/s), not TF32, because the fp32 path must match fp32 references to
// 1e-5.  The fp32 route serves the tests and the fp32 parity runs; the
// bf16 route's kernels carry the shapes of the serving and training paths.
//
// What the designs do about it (simple first, fast later):
// - gmm: one thread block per (row tile of TM rows, 64 output columns).
//   TM is the largest of 64/32/16/8 that divides bm, so a block never
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
// - tgmm: one thread block per (64 x 64 output tile, expert), 4 x 4
//   outputs a thread on FMA.  The block finds its expert's contiguous row
//   span with a binary search over tile_groups on the device (no host
//   read), then walks it 32 rows at a time, staging lhs columns
//   [k0, k0 + 64) and the scaled rhs columns [n0, n0 + 64) of each row in
//   shared memory, and accumulates lhs^T rhs in registers for the whole
//   span, so the reduction over thousands of rows never leaves registers.
//   Rows past the span read as zeros; sentinel rows point at the caller's
//   zero row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// a 64 x 64 output tile per block of 256 threads, 4 x 4 outputs per thread
// on FMA, rows staged 32 at a time
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

// ptt_tgmm: dtype 0 only (bf16 tgmm is tgmm_sm90.cu's ptt_tgmm_sm90, with
// these arguments; dtype 1 returns cudaErrorInvalidValue).  out [E, K, N];
// lhs [Ll, K] and rhs [Lr, N], read at lrows[m] / rrows[m] (or row m when
// null) for m < M; rscale [M] or null.  T = M / bm tiles; K and N must be
// multiples of 64 and the float operands 16-byte aligned; the Python
// wrapper checks all of it.
extern "C" int ptt_tgmm(const void* lhs, const void* rhs, const void* tile_groups,
                        const void* lrows, const void* rrows, const void* rscale,
                        void* out, int M, int K, int N, int E, int Ll, int Lr, int bm,
                        int T, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)M;
  if (dtype != 0 || K % 64 || N % 64 || E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(K / kTF, N / kTF, E);
  tgmm_f32_kernel<<<grid, kTFThreads, 0, s>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(rhs),
      static_cast<const int32_t*>(tile_groups), static_cast<const int32_t*>(lrows),
      static_cast<const int32_t*>(rrows), static_cast<const float*>(rscale),
      static_cast<float*>(out), K, N, Ll, Lr, bm, T);
  return static_cast<int>(cudaGetLastError());
}
