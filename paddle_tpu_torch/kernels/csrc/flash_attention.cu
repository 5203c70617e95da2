// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels of paddle_tpu/kernels/flash_attention.py:
//   - _fa_fwd_kernel      (launched by _fwd_call)            -> flash_fwd_kernel
//   - _fa_bwd_dq_kernel   (launched by _fa_pallas_backward)  -> flash_bwd_dq_kernel
//   - _fa_bwd_dkv_kernel  (launched by _fa_pallas_backward)  -> flash_bwd_dkv_kernel
// They compute what the plain versions in flash_attention.py compute:
//
//   s = scale * q k^T (causal: s = -1e30 where k_pos > q_pos + (sk - sq))
//   forward:  out = softmax(s) v,  lse = logsumexp(s)       (online softmax)
//   backward: p = exp(s - lse),  ds = p * (dO v^T - delta),  delta = rowsum(dO * out)
//             dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO
//
// Layout [b, s, h, d] (d contiguous, 64 or 128) for q, k, v, out, dO, dq, dk and
// dv, read in place: a row of one head is h*d elements from the next.  lse and
// delta are fp32 [b, hq, sq].  GQA: q-head h reads kv-head h / (hq / hkv).
// float32 inputs stay float32 end to end (plain FMA, not TF32); bfloat16
// inputs go through the tensor cores with fp32 accumulation, and the
// probabilities (and ds) are rounded to bf16 before their products.
//
// What bounds them on this card: operations.  At the training shape (b 4,
// s 2048, 32 heads, d 128, causal) the forward is 2 matmuls of b*h*s^2*d/2 =
// 68.7 GFLOP each, 0.139 ms at 989 TFLOP/s (bf16); dQ 3 of them, 0.208 ms;
// dK/dV 4, 0.278 ms; while each reads and writes a few tens of MB (0.02 ms at
// 3.35 TB/s).
//
// What the design does about it (simple first, fast later):
// - The TPU grid carries the online-softmax state in VMEM from one kv block
//   to the next; here one CTA (4 warps) owns a 64-row tile and walks the
//   other sequence in a loop, with its state in shared memory and registers.
//   forward and dQ: one CTA per (q tile, q-head, batch), walking kv tiles of
//   64 rows; dK/dV: one CTA per (kv tile, kv-head, batch), walking the q
//   tiles of every q-head of its GQA group, so the group's dK/dV is summed in
//   fp32 inside the CTA (no per-q-head fp32 partials in device memory, no
//   second pass).
// - Causal tiles past the diagonal are never visited (the reference's
//   _needed); the tiles with the most work are scheduled first.
// - bf16: WMMA 16x16x16 fragments (mma.sync) on shared-memory tiles, each
//   warp a 16-row strip; fp32: a register-tiled FMA loop.  Scores and
//   accumulators live in fp32 shared memory, so the forward's per-row rescale
//   is a plain loop.  Two threads own each row for the row max and sum.
// - Rows and columns past the sequence ends are zero-filled and masked, so
//   any lengths work.
// Later work (not here): wgmma with TMA-fed multi-stage rings, warp
// specialization, accumulators in registers, more than one CTA per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps
constexpr int kTile = 64;       // rows of the CTA's own tile, and kv rows per step
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory row strides (elements).  fp32 tiles get an odd stride, so
// the FMA loops read down a column without bank conflicts; bf16 tiles and
// fp32 WMMA accumulators keep WMMA's rules (ldm a multiple of 8 / 4, every
// 16-row strip 32-byte aligned).
template <typename T, int D>
struct Ld {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int tile = D + (kBf16 ? 8 : 1);     // T, D wide
  static constexpr int acc = D + (kBf16 ? 4 : 1);      // fp32, D wide
  __host__ __device__ static constexpr int score(int n) { return n + (kBf16 ? 4 : 1); }  // fp32
  __host__ __device__ static constexpr int prob(int n) { return kBf16 ? n + 8 : score(n); }  // T
};

struct Carve {
  unsigned char* p;
  template <typename U>
  __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += align128(n * sizeof(U));
    return r;
  }
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// rows [r0, r0 + rows) of a [n, *] operand whose rows are `stride` elements
// apart, D wide, into dst[rows][ld]; rows >= n are zero.
template <typename T, int D>
__device__ void load_tile(T* dst, int ld, const T* src, int64_t stride, int r0, int rows,
                          int n) {
  constexpr int V = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int PER_ROW = D / V;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * stride + c);
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    } else {
      const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[r * ld + c + e] = f[e];
    }
  }
}

// ---- tile products over shared memory, M = 64 rows ------------------------
// mm_nt:     C[64][N]  = A[64][K] . B[N][K]^T      (C written)
// mm_nn_acc: C[64][N] += A[64][K] . B[K][N]        (C read and written)

template <int N, int K>
__device__ void mm_nt(const bf16* A, int lda, const bf16* B, int ldb, float* C, int ldc) {
  const int w = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[N / 16];
#pragma unroll
  for (int j = 0; j < N / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + 16 * w * lda + kk, lda);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, B + 16 * j * ldb + kk, ldb);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
    wmma::store_matrix_sync(C + 16 * w * ldc + 16 * j, acc[j], ldc, wmma::mem_row_major);
}

template <int N, int K>
__device__ void mm_nn_acc(const bf16* A, int lda, const bf16* B, int ldb, float* C, int ldc) {
  const int w = threadIdx.x / 32;
#pragma unroll 1
  for (int j = 0; j < N / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + 16 * w * ldc + 16 * j, ldc, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + 16 * w * lda + kk, lda);
      wmma::load_matrix_sync(b, B + kk * ldb + 16 * j, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + 16 * w * ldc + 16 * j, acc, ldc, wmma::mem_row_major);
  }
}

// fp32: thread (tr, tc) = (tid / 16, tid % 16) owns rows tr + 8 i, columns tc + 16 j
template <int N, int K>
__device__ void mm_nt(const float* A, int lda, const float* B, int ldb, float* C, int ldc) {
  constexpr int NJ = N / 16;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[8], b[NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = A[(tr + 8 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[(tc + 16 * j) * ldb + k];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) C[(tr + 8 * i) * ldc + tc + 16 * j] = acc[i][j];
}

template <int N, int K>
__device__ void mm_nn_acc(const float* A, int lda, const float* B, int ldb, float* C, int ldc) {
  constexpr int NJ = N / 16;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = C[(tr + 8 * i) * ldc + tc + 16 * j];
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[8], b[NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = A[(tr + 8 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * ldb + tc + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) C[(tr + 8 * i) * ldc + tc + 16 * j] = acc[i][j];
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
}

__device__ __forceinline__ bool masked(int qi, int kj, int Sq, int Sk, int causal) {
  return qi >= Sq || kj >= Sk || (causal && kj > qi + (Sk - Sq));
}

// number of kv tiles a q tile starting at q0 needs (reference: _needed)
__device__ __forceinline__ int kv_tiles(int q0, int Sq, int Sk, int causal) {
  const int n = (Sk + kTile - 1) / kTile;
  if (!causal) return n;
  const int last = min(q0 + kTile - 1, Sq - 1) + (Sk - Sq);
  return min(n, last / kTile + 1);
}

// ---- forward --------------------------------------------------------------

template <typename T, int D>
struct FwdSmem {
  using L = Ld<T, D>;
  static constexpr size_t tile = align128(sizeof(T) * kTile * L::tile);
  static constexpr size_t score = align128(4 * kTile * L::score(kTile));
  static constexpr size_t prob = L::kBf16 ? align128(2 * kTile * L::prob(kTile)) : 0;
  static constexpr size_t acc = align128(4 * kTile * L::acc);
  static constexpr size_t bytes = 3 * tile + score + prob + acc;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int Hq,
                 int Hkv, int causal, float scale) {
  using L = Ld<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* q_s = cv.take<T>(kTile * L::tile);
  T* k_s = cv.take<T>(kTile * L::tile);
  T* v_s = cv.take<T>(kTile * L::tile);
  float* s_s = cv.take<float>(kTile * L::score(kTile));
  T* p_s;
  if constexpr (L::kBf16) p_s = cv.take<T>(kTile * L::prob(kTile));
  else p_s = reinterpret_cast<T*>(s_s);           // fp32: p overwrites s in place
  float* o_s = cv.take<float>(kTile * L::acc);
  constexpr int LDS = L::score(kTile), LDP = L::prob(kTile);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int64_t qs = (int64_t)Hq * D, ks = (int64_t)Hkv * D;
  const T* qb = q + (int64_t)b * Sq * qs + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Sk * ks + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * Sk * ks + (int64_t)hk * D;

  load_tile<T, D>(q_s, L::tile, qb, qs, q0, kTile, Sq);
  zero(o_s, kTile * L::acc);
  // two threads per row: row = tid / 2, columns [half * 32, half * 32 + 32)
  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  float m = kNegInf, l = 0.f;

  const int n_kt = kv_tiles(q0, Sq, Sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(k_s, L::tile, kb, ks, k0, kTile, Sk);
    load_tile<T, D>(v_s, L::tile, vb, ks, k0, kTile, Sk);
    __syncthreads();
    mm_nt<kTile, D>(q_s, L::tile, k_s, L::tile, s_s, LDS);
    __syncthreads();
    float sv[kTile / 2];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kTile / 2; ++c) {
      const int col = half * (kTile / 2) + c;
      float x = s_s[row * LDS + col] * scale;
      if (k0 + col >= Sk || (causal && k0 + col > q0 + row + (Sk - Sq))) x = kNegInf;
      sv[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kTile / 2; ++c) {
      const float p = expf(sv[c] - m_new);
      sum += p;
      p_s[row * LDP + half * (kTile / 2) + c] = from_f<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m - m_new);
    l = alpha * l + sum;
    m = m_new;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) o_s[row * L::acc + c] *= alpha;
    __syncthreads();
    mm_nn_acc<D, kTile>(p_s, LDP, v_s, L::tile, o_s, L::acc);
  }
  __syncthreads();
  if (q0 + row < Sq) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    T* ob = out + ((int64_t)b * Sq + q0 + row) * qs + (int64_t)h * D;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      ob[c] = from_f<T>(o_s[row * L::acc + c] * inv);
    if (half == 0) lse[((int64_t)b * Hq + h) * Sq + q0 + row] = m + logf(lc);
  }
}

// ---- dQ -------------------------------------------------------------------

template <typename T, int D>
struct DqSmem {
  using L = Ld<T, D>;
  static constexpr size_t tile = align128(sizeof(T) * kTile * L::tile);
  static constexpr size_t score = align128(4 * kTile * L::score(kTile));
  static constexpr size_t prob = L::kBf16 ? align128(2 * kTile * L::prob(kTile)) : 0;
  static constexpr size_t acc = align128(4 * kTile * L::acc);
  static constexpr size_t rows = align128(4 * kTile);
  static constexpr size_t bytes = 4 * tile + 2 * score + prob + acc + 2 * rows;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
                    int Hq, int Hkv, int causal, float scale) {
  using L = Ld<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* q_s = cv.take<T>(kTile * L::tile);
  T* do_s = cv.take<T>(kTile * L::tile);
  T* k_s = cv.take<T>(kTile * L::tile);
  T* v_s = cv.take<T>(kTile * L::tile);
  float* s_s = cv.take<float>(kTile * L::score(kTile));
  float* dp_s = cv.take<float>(kTile * L::score(kTile));
  T* ds_s;
  if constexpr (L::kBf16) ds_s = cv.take<T>(kTile * L::prob(kTile));
  else ds_s = reinterpret_cast<T*>(s_s);          // fp32: ds overwrites s in place
  float* acc = cv.take<float>(kTile * L::acc);
  float* lse_s = cv.take<float>(kTile);
  float* delta_s = cv.take<float>(kTile);
  constexpr int LDS = L::score(kTile), LDP = L::prob(kTile);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int64_t qs = (int64_t)Hq * D, ks = (int64_t)Hkv * D;
  const int64_t qoff = (int64_t)b * Sq * qs + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Sk * ks + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * Sk * ks + (int64_t)hk * D;
  const int64_t roff = ((int64_t)b * Hq + h) * Sq;

  load_tile<T, D>(q_s, L::tile, q + qoff, qs, q0, kTile, Sq);
  load_tile<T, D>(do_s, L::tile, dout + qoff, qs, q0, kTile, Sq);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = q0 + r < Sq;
    lse_s[r] = in ? lse[roff + q0 + r] : 0.f;
    delta_s[r] = in ? delta[roff + q0 + r] : 0.f;
  }
  zero(acc, kTile * L::acc);

  const int n_kt = kv_tiles(q0, Sq, Sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(k_s, L::tile, kb, ks, k0, kTile, Sk);
    load_tile<T, D>(v_s, L::tile, vb, ks, k0, kTile, Sk);
    __syncthreads();
    mm_nt<kTile, D>(q_s, L::tile, k_s, L::tile, s_s, LDS);
    mm_nt<kTile, D>(do_s, L::tile, v_s, L::tile, dp_s, LDS);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      const float p = masked(q0 + r, k0 + c, Sq, Sk, causal)
                          ? 0.f : expf(s_s[r * LDS + c] * scale - lse_s[r]);
      ds_s[r * LDP + c] = from_f<T>(p * (dp_s[r * LDS + c] - delta_s[r]));
    }
    __syncthreads();
    mm_nn_acc<D, kTile>(ds_s, LDP, k_s, L::tile, acc, L::acc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < Sq) dq[qoff + (int64_t)(q0 + r) * qs + c] = from_f<T>(acc[r * L::acc + c] * scale);
  }
}

// ---- dK / dV --------------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  using L = Ld<T, D>;
  static constexpr int BQ = L::kBf16 ? 64 : 32;   // q rows per step (fp32: fits 227 KB)
  static constexpr size_t kv_tile = align128(sizeof(T) * kTile * L::tile);
  static constexpr size_t q_tile = align128(sizeof(T) * BQ * L::tile);
  static constexpr size_t score = align128(4 * kTile * L::score(BQ));
  static constexpr size_t prob = L::kBf16 ? align128(2 * kTile * L::prob(BQ)) : 0;
  static constexpr size_t acc = align128(4 * kTile * L::acc);
  static constexpr size_t rows = align128(4 * BQ);
  static constexpr size_t bytes = 2 * kv_tile + 2 * q_tile + 2 * score + 2 * prob + 2 * acc +
                                  2 * rows;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Sq, int Sk, int Hq, int Hkv, int causal, float scale) {
  using L = Ld<T, D>;
  using S = DkvSmem<T, D>;
  constexpr int BQ = S::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* k_s = cv.take<T>(kTile * L::tile);
  T* v_s = cv.take<T>(kTile * L::tile);
  T* q_s = cv.take<T>(BQ * L::tile);
  T* do_s = cv.take<T>(BQ * L::tile);
  float* st_s = cv.take<float>(kTile * L::score(BQ));     // s^T  [kv][q]
  float* dpt_s = cv.take<float>(kTile * L::score(BQ));    // dp^T [kv][q]
  T *pt_s, *dst_s;
  if constexpr (L::kBf16) {
    pt_s = cv.take<T>(kTile * L::prob(BQ));
    dst_s = cv.take<T>(kTile * L::prob(BQ));
  } else {                                                // fp32: in place
    pt_s = reinterpret_cast<T*>(st_s);
    dst_s = reinterpret_cast<T*>(dpt_s);
  }
  float* dk_acc = cv.take<float>(kTile * L::acc);
  float* dv_acc = cv.take<float>(kTile * L::acc);
  float* lse_s = cv.take<float>(BQ);
  float* delta_s = cv.take<float>(BQ);
  constexpr int LDS = L::score(BQ), LDP = L::prob(BQ);

  const int k0 = blockIdx.x * kTile;                      // heaviest (first) tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int64_t qs = (int64_t)Hq * D, ks = (int64_t)Hkv * D;
  const int64_t koff = (int64_t)b * Sk * ks + (int64_t)hk * D;

  load_tile<T, D>(k_s, L::tile, k + koff, ks, k0, kTile, Sk);
  load_tile<T, D>(v_s, L::tile, v + koff, ks, k0, kTile, Sk);
  zero(dk_acc, kTile * L::acc);
  zero(dv_acc, kTile * L::acc);

  // first q tile whose last row reaches this kv tile
  const int first = k0 - (Sk - Sq);
  const int jq0 = (causal && first > 0) ? first / BQ : 0;
  const int n_qt = (Sq + BQ - 1) / BQ;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const int64_t qoff = (int64_t)b * Sq * qs + (int64_t)h * D;
    const int64_t roff = ((int64_t)b * Hq + h) * Sq;
    for (int jq = jq0; jq < n_qt; ++jq) {
      const int q0 = jq * BQ;
      __syncthreads();
      load_tile<T, D>(q_s, L::tile, q + qoff, qs, q0, BQ, Sq);
      load_tile<T, D>(do_s, L::tile, dout + qoff, qs, q0, BQ, Sq);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < Sq;
        lse_s[r] = in ? lse[roff + q0 + r] : 0.f;
        delta_s[r] = in ? delta[roff + q0 + r] : 0.f;
      }
      __syncthreads();
      mm_nt<BQ, D>(k_s, L::tile, q_s, L::tile, st_s, LDS);
      mm_nt<BQ, D>(v_s, L::tile, do_s, L::tile, dpt_s, LDS);
      __syncthreads();
      for (int i = threadIdx.x; i < kTile * BQ; i += kThreads) {
        const int r = i / BQ, c = i % BQ;                 // kv row r, q column c
        const float p = masked(q0 + c, k0 + r, Sq, Sk, causal)
                            ? 0.f : expf(st_s[r * LDS + c] * scale - lse_s[c]);
        const float ds = p * (dpt_s[r * LDS + c] - delta_s[c]);
        pt_s[r * LDP + c] = from_f<T>(p);
        dst_s[r * LDP + c] = from_f<T>(ds);
      }
      __syncthreads();
      mm_nn_acc<D, BQ>(pt_s, LDP, do_s, L::tile, dv_acc, L::acc);   // dV += P^T dO
      mm_nn_acc<D, BQ>(dst_s, LDP, q_s, L::tile, dk_acc, L::acc);   // dK += dS^T Q
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (k0 + r < Sk) {
      const int64_t o = koff + (int64_t)(k0 + r) * ks + c;
      dk[o] = from_f<T>(dk_acc[r * L::acc + c] * scale);
      dv[o] = from_f<T>(dv_acc[r * L::acc + c]);
    }
  }
}

// ---- launches -------------------------------------------------------------

struct Dims {
  int B, Sq, Sk, Hq, Hkv, D, causal;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                const Dims& d, cudaStream_t s) {
  constexpr size_t bytes = FwdSmem<T, D>::bytes;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((d.Sq + kTile - 1) / kTile, d.Hq, d.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, d.Sq, d.Sk, d.Hq, d.Hkv, d.causal, static_cast<float>(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, const Dims& d,
                   cudaStream_t s) {
  constexpr size_t bytes = DqSmem<T, D>::bytes;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((d.Sq + kTile - 1) / kTile, d.Hq, d.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), d.Sq, d.Sk, d.Hq, d.Hkv,
      d.causal, static_cast<float>(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, const Dims& d,
                    cudaStream_t s) {
  constexpr size_t bytes = DkvSmem<T, D>::bytes;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((d.Sk + kTile - 1) / kTile, d.Hkv, d.B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      d.Sq, d.Sk, d.Hq, d.Hkv, d.causal, static_cast<float>(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

// Calls F<T, D>::run(args...) for dtype (0 float32, 1 bfloat16) and D (64, 128).
#define PTT_DISPATCH(FN, ...)                                                 \
  do {                                                                        \
    if (dtype == 0 && d.D == 64) return static_cast<int>(FN<float, 64>(__VA_ARGS__)); \
    if (dtype == 0 && d.D == 128) return static_cast<int>(FN<float, 128>(__VA_ARGS__)); \
    if (dtype == 1 && d.D == 64) return static_cast<int>(FN<bf16, 64>(__VA_ARGS__)); \
    if (dtype == 1 && d.D == 128) return static_cast<int>(FN<bf16, 128>(__VA_ARGS__)); \
    return static_cast<int>(cudaErrorInvalidValue);                           \
  } while (0)

}  // namespace

// Plain C entry points, loaded with ctypes.  Tensors are contiguous
// [b, s, h, d] (q, out, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv,
// D]) and 16-byte aligned; lse and delta are fp32 [B, Hq, Sq].  dtype: 0 =
// float32, 1 = bfloat16 (all of q, k, v, dout and the outputs).  D is 64 or
// 128, Hkv divides Hq, Sq and Sk are positive, and a causal call has
// Sq <= Sk; the Python wrapper checks all of it.  Each returns the
// cudaError_t of its launch (0 = success).
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             void* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                             int causal, int dtype, void* stream) {
  const Dims d{B, Sq, Sk, Hq, Hkv, D, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(fwd, q, k, v, out, static_cast<float*>(lse), d, s);
}

extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                int causal, int dtype, void* stream) {
  const Dims d{B, Sq, Sk, Hq, Hkv, D, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(bwd_dq, q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, d, s);
}

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                                 int Hkv, int D, int causal, int dtype, void* stream) {
  const Dims d{B, Sq, Sk, Hq, Hkv, D, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(bwd_dkv, q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, d, s);
}
