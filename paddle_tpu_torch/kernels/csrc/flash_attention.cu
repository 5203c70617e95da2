// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV, every mode,
// for fp32 and for bf16 at d 96 and 256 (the "mma" route).
//
// Replaces the Pallas TPU kernels of paddle_tpu/kernels/flash_attention.py:
//   - _fa_fwd_kernel      (launched by _fwd_call)            -> flash_fwd_kernel
//   - _fa_bwd_dq_kernel   (launched by _fa_pallas_backward)  -> flash_bwd_dq_kernel
//   - _fa_bwd_dkv_kernel  (launched by _fa_pallas_backward)  -> flash_bwd_dkv_kernel
// for those dtypes and head dims, with all their modes, each composable with
// the others: causal, GQA, an additive fp32 mask, segment ids (varlen) and
// dropout on the probabilities.
// They compute what the plain versions in flash_attention.py compute:
//
//   s = scale * q k^T + mask;  s = -1e30 where k_pos > q_pos + (sk - sq) (causal)
//                              or where seg_q[q_pos] != seg_k[k_pos]
//   forward:  out = (keep(p) / (1 - rate)) v / sum(p), p = exp(s - max),
//             lse = max + log(sum(p))                          (online softmax)
//   backward: p = exp(s - lse),  dp = keep(dO v^T) / (1 - rate),
//             ds = p * (dp - delta),  delta = rowsum(dO * out)
//             dq = scale * ds k,  dk = scale * ds^T q,  dv = (keep(p) / (1 - rate))^T dO
//
// keep(b, h, row, col) is the reference's counter hash (_drop_mix) of the seed,
// the batch, the q-head and the global row and column, >= rate * 2^32: the same
// bits in the three kernels and in the plain version, whatever the tiling.  The
// seed is read from a one-element device int32 (no host value in the step).  A
// row whose every key is at -1e30 gets the average of the keys it visits (p = 1
// for each), as in the reference's kernel; keys past the sequence end are never
// counted (-inf, p = 0).
//
// Layout [b, s, h, d] (d contiguous; 64, 96, 128 or 256) for q, k, v, out, dO,
// dq, dk and dv, read in place: a row of one head is h*d elements from the
// next.  lse and delta are fp32 [b, hq, sq].  GQA: q-head h reads kv-head
// h / (hq / hkv).  The mask is fp32 [b|1, hq|1, sq, sk] (a batch and a head
// stride, 0 where it broadcasts); segment ids are int32 [b, sq] and [b, sk].
// float32 inputs stay float32 end to end (plain FMA, not TF32); bfloat16
// inputs go through the tensor cores with fp32 accumulation, and the
// probabilities (and ds) are rounded to bf16 before their products.
//
// What bounds them on this card: operations.  At the training shape (b 4,
// s 2048, 32 heads, d 128, causal) the forward is 2 matmuls of b*h*s^2*d/2 =
// 68.7 GFLOP each, 0.139 ms at 989 TFLOP/s (bf16); dQ 3 of them, 0.208 ms;
// dK/dV 4, 0.278 ms; while each reads and writes a few tens of MB (0.02 ms at
// 3.35 TB/s).  Per mode:
// - full (non-causal) attention, as with a mask: twice the causal work;
// - the mask adds its bytes once: b*sq*sk*4 (67 MB at b 4, s 2048, one head
//   plane, 0.020 ms).  Every q-head of a batch row reads the same plane; the
//   grid keeps the q tile fastest, then the head, so the CTAs that share a
//   plane run together and L2 (50 MB) serves the repeats;
// - segments: the live (query, key) pairs are those of each segment, the sum
//   of its length squared (halved with causal), not s^2; ids add 4 bytes a
//   token;
// - dropout: no bytes; about 15 integer operations per score for the hash.
//
// What the design does about it (simple first, fast later):
// - The TPU grid carries the online-softmax state in VMEM from one kv block
//   to the next; here one CTA (4 warps) owns a tile of BM rows and walks the
//   other sequence in steps of BN rows, with its state in shared memory and
//   registers.  forward and dQ: one CTA per (q tile, q-head, batch), walking
//   kv tiles; dK/dV: one CTA per (kv tile, kv-head, batch), walking the q
//   tiles of every q-head of its GQA group, so the group's dK/dV is summed in
//   fp32 inside the CTA (no per-q-head fp32 partials in device memory, no
//   second pass); dropout hashes with each q-head's own index.
// - BM and BN are 64, and 32 where a tile set would not fit the 227 KB of
//   shared memory (d 256: Cfg below).
// - Causal tiles past the diagonal are never visited (the reference's
//   _needed); the tiles with the most work are scheduled first.  Tiles that
//   hold only other segments' keys are visited (a row with no live key must
//   still average the keys it visits).
// - Each kernel is compiled twice: without the modes' code, so causal/full
//   attention (the training step) carries none of it, and with it.
// - The mask and the segment test go into the score tile in one pass over
//   shared memory.  Each thread's mask entries (coalesced rows) are read into
//   registers before the tile's products, so their latency overlaps the
//   matmul; the tile's segment ids are staged in shared memory.
// - bf16: WMMA 16x16x16 fragments (mma.sync) on shared-memory tiles, each
//   warp a 16-row strip (and half the columns when BM is 32); fp32: a
//   register-tiled FMA loop.  Scores and accumulators live in fp32 shared
//   memory, so the forward's per-row rescale is a plain loop.  Two threads
//   own each row for the row max and sum.
// - Rows and columns past the sequence ends are zero-filled and masked, so
//   any lengths work.
// bf16 at d 64 and 128 (the "sm90" route: the wrapper's _route) runs the
// wgmma kernels of flash_attention_fwd_sm90.cu and flash_attention_bwd_sm90.cu
// instead, and is not built here.  Later work (not here): fp32 and d 96/256
// on wgmma; skipping tiles with no live pair of a segment.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace nvcuda;
using namespace ptt_flash;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemMax = 232448;   // 227 KB a block

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

// Tile rows of each kernel: BM the CTA's own tile, BN the rows of each step.
template <typename T, int D>
struct Cfg {
  static constexpr bool kBig = D > 128;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int fwd_bm = 64, fwd_bn = (kF32 && kBig) ? 32 : 64;
  static constexpr int dq_bm = (kF32 && kBig) ? 32 : 64, dq_bn = kBig ? 32 : 64;
  static constexpr int dkv_bm = kBig ? 32 : 64, dkv_bn = kF32 ? 32 : 64;   // kv rows, q rows
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

// ---- tile products over shared memory, M = 64 or 32 rows ------------------
// mm_nt:     C[M][N]  = A[M][K] . B[N][K]^T      (C written)
// mm_nn_acc: C[M][N] += A[M][K] . B[K][N]        (C read and written)

// bf16: warp w takes the 16-row strip w % (M / 16) and, when M is 32, half
// of the 16-column fragments
template <int M, int N>
struct WarpSplit {
  static constexpr int strips = M / 16;
  static constexpr int groups = 4 / strips;
  static constexpr int nf = N / 16 / groups;     // fragments per warp
  static_assert(M == 64 || M == 32, "M is 64 or 32");
  static_assert((N / 16) % groups == 0, "N splits over the warps");
};

template <int M, int N, int K>
__device__ void mm_nt(const bf16* A, int lda, const bf16* B, int ldb, float* C, int ldc) {
  using W = WarpSplit<M, N>;
  const int w = threadIdx.x / 32, strip = W::groups == 1 ? w : w % W::strips;
  const int j0 = W::groups == 1 ? 0 : (w / W::strips) * W::nf;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[W::nf];
#pragma unroll
  for (int j = 0; j < W::nf; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + 16 * strip * lda + kk, lda);
#pragma unroll
    for (int j = 0; j < W::nf; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, B + 16 * (j0 + j) * ldb + kk, ldb);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < W::nf; ++j)
    wmma::store_matrix_sync(C + 16 * strip * ldc + 16 * (j0 + j), acc[j], ldc,
                            wmma::mem_row_major);
}

template <int M, int N, int K>
__device__ void mm_nn_acc(const bf16* A, int lda, const bf16* B, int ldb, float* C, int ldc) {
  using W = WarpSplit<M, N>;
  const int w = threadIdx.x / 32, strip = W::groups == 1 ? w : w % W::strips;
  const int j0 = W::groups == 1 ? 0 : (w / W::strips) * W::nf;
#pragma unroll 1
  for (int j = j0; j < j0 + W::nf; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + 16 * strip * ldc + 16 * j, ldc, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + 16 * strip * lda + kk, lda);
      wmma::load_matrix_sync(b, B + kk * ldb + 16 * j, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + 16 * strip * ldc + 16 * j, acc, ldc, wmma::mem_row_major);
  }
}

// fp32: thread (tr, tc) = (tid / 16, tid % 16) owns rows tr + 8 i, columns
// tc + 16 j (mm_nn_acc: in chunks of at most 128 columns, to bound registers)
template <int M, int N, int K>
__device__ void mm_nt(const float* A, int lda, const float* B, int ldb, float* C, int ldc) {
  constexpr int MI = M / 8, NJ = N / 16;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[MI], b[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = A[(tr + 8 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[(tc + 16 * j) * ldb + k];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) C[(tr + 8 * i) * ldc + tc + 16 * j] = acc[i][j];
}

template <int M, int N, int K>
__device__ void mm_nn_acc(const float* A, int lda, const float* B, int ldb, float* C, int ldc) {
  constexpr int MI = M / 8, CH = N < 128 ? N : 128, NJ = CH / 16;
  static_assert(N % CH == 0, "column chunks");
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll 1
  for (int n0 = 0; n0 < N; n0 += CH) {
    float acc[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = C[(tr + 8 * i) * ldc + n0 + tc + 16 * j];
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[MI], b[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) a[i] = A[(tr + 8 * i) * lda + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = B[k * ldb + n0 + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) C[(tr + 8 * i) * ldc + n0 + tc + 16 * j] = acc[i][j];
  }
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
}

// The mask and the segment test on a score tile in shared memory, with the
// scale: s = scale * s + mask, then -1e30 where the segments differ.  The
// tile is [q][kv] (rows q0 + r, columns k0 + c) or, when KV_ROWS, [kv][q].
// Each thread takes N entries, consecutive threads consecutive keys, so the
// mask rows are read coalesced; prefetch() issues all N reads into
// registers before the tile's products, apply() adds them after.  The
// segment ids of the tile's rows and columns sit in shared memory (-1 / -2
// past the ends).  Entries past a sequence end are masked later.
template <int ROWS, int COLS, bool KV_ROWS>
struct ModeTile {
  static constexpr int N = ROWS * COLS / kThreads;
  static_assert(N * kThreads == ROWS * COLS, "whole tile");
  float add[N];

  __device__ static void at(int e, int& r, int& c) {
    const int i = threadIdx.x + e * kThreads;
    if constexpr (KV_ROWS) {
      r = i % ROWS; c = i / ROWS;
    } else {
      r = i / COLS; c = i % COLS;
    }
  }

  __device__ void prefetch(const float* mp, int q0, int k0, int Sq, int Sk) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      int r, c;
      at(e, r, c);
      const int qi = q0 + (KV_ROWS ? c : r), kj = k0 + (KV_ROWS ? r : c);
      add[e] = (qi < Sq && kj < Sk) ? __ldg(mp + (int64_t)qi * Sk + kj) : 0.f;
    }
  }

  __device__ void apply(float* s, int lds, bool has_mask, const int* segq_s,
                        const int* segk_s, bool has_seg, float scale) const {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      int r, c;
      at(e, r, c);
      float x = s[r * lds + c] * scale;
      if (has_mask) x += add[e];
      if (has_seg && segq_s[KV_ROWS ? c : r] != segk_s[KV_ROWS ? r : c]) x = kNegInf;
      s[r * lds + c] = x;
    }
  }
};

// segment ids of rows [r0, r0 + n) into dst (pad past the end)
__device__ __forceinline__ void load_seg(int* dst, const int* ids, int r0, int n, int len,
                                         int pad) {
  for (int r = threadIdx.x; r < n; r += kThreads) dst[r] = r0 + r < len ? ids[r0 + r] : pad;
}

// ---- forward --------------------------------------------------------------

template <typename T, int D, int BM, int BN>
struct FwdSmem {
  using L = Ld<T, D>;
  static constexpr size_t q_tile = align128(sizeof(T) * BM * L::tile);
  static constexpr size_t kv_tile = align128(sizeof(T) * BN * L::tile);
  static constexpr size_t score = align128(4 * BM * L::score(BN));
  static constexpr size_t prob = L::kBf16 ? align128(2 * BM * L::prob(BN)) : 0;
  static constexpr size_t acc = align128(4 * BM * L::acc);
  static constexpr size_t segs = align128(4 * BM) + align128(4 * BN);
  static constexpr size_t bytes = q_tile + 2 * kv_tile + score + prob + acc + segs;
  static_assert(bytes <= kSmemMax, "forward tiles exceed shared memory");
};

template <typename T, int D, int BM, int BN, bool kModes>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, Modes md, int Sq, int Sk,
                 int Hq, int Hkv, int causal, float scale) {
  using L = Ld<T, D>;
  constexpr int TPR = kThreads / BM;        // threads per row
  constexpr int CPT = BN / TPR;             // score columns per thread
  constexpr int DPT = D / TPR;              // output columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* q_s = cv.take<T>(BM * L::tile);
  T* k_s = cv.take<T>(BN * L::tile);
  T* v_s = cv.take<T>(BN * L::tile);
  float* s_s = cv.take<float>(BM * L::score(BN));
  T* p_s;
  if constexpr (L::kBf16) p_s = cv.take<T>(BM * L::prob(BN));
  else p_s = reinterpret_cast<T*>(s_s);           // fp32: p overwrites s in place
  float* o_s = cv.take<float>(BM * L::acc);
  int* segq_s = cv.take<int>(BM);
  int* segk_s = cv.take<int>(BN);
  constexpr int LDS = L::score(BN), LDP = L::prob(BN);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int64_t qs = (int64_t)Hq * D, ks = (int64_t)Hkv * D;
  const T* qb = q + (int64_t)b * Sq * qs + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Sk * ks + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * Sk * ks + (int64_t)hk * D;
  const bool has_seg = kModes && md.seg_q != nullptr;
  const bool modes = has_seg || (kModes && md.mask != nullptr);
  const float sc = modes ? 1.f : scale;            // the modes' pass scales
  const float* mp = kModes && md.mask ? md.mask + b * md.mask_sb + h * md.mask_sh : nullptr;
  const bool drop = kModes && md.seed != nullptr;
  const uint32_t dbase = drop ? drop_base((uint32_t)*md.seed, b, h) : 0u;
  ModeTile<BM, BN, false> mt;

  load_tile<T, D>(q_s, L::tile, qb, qs, q0, BM, Sq);
  if (has_seg) load_seg(segq_s, md.seg_q + (int64_t)b * Sq, q0, BM, Sq, -1);
  zero(o_s, BM * L::acc);
  // TPR threads per row: row = tid / TPR, columns [part * CPT, part * CPT + CPT)
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  float m = kNegInf, l = 0.f;

  const int n_kt = kv_tiles<BM, BN>(q0, Sq, Sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<T, D>(k_s, L::tile, kb, ks, k0, BN, Sk);
    load_tile<T, D>(v_s, L::tile, vb, ks, k0, BN, Sk);
    if (has_seg) load_seg(segk_s, md.seg_k + (int64_t)b * Sk, k0, BN, Sk, -2);
    if (mp) mt.prefetch(mp, q0, k0, Sq, Sk);
    __syncthreads();
    mm_nt<BM, BN, D>(q_s, L::tile, k_s, L::tile, s_s, LDS);
    __syncthreads();
    if (modes) {
      mt.apply(s_s, LDS, mp != nullptr, segq_s, segk_s, has_seg, scale);
      __syncthreads();
    }
    float sv[CPT];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = part * CPT + c;
      float x = s_s[row * LDS + col] * sc;
      if (k0 + col >= Sk) x = -CUDART_INF_F;                  // no key: never counted
      else if (causal && k0 + col > q0 + row + (Sk - Sq)) x = kNegInf;
      sv[c] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = part * CPT + c;
      float p = expf(sv[c] - m_new);
      sum += p;                                  // l keeps the undropped sum
      if (drop) p = drop_keep(dbase, q0 + row, k0 + col, md.thresh) ? p * md.inv : 0.f;
      p_s[row * LDP + col] = from_f<T>(p);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float alpha = expf(m - m_new);
    l = alpha * l + sum;
    m = m_new;
    for (int c = part * DPT; c < (part + 1) * DPT; ++c) o_s[row * L::acc + c] *= alpha;
    __syncthreads();
    mm_nn_acc<BM, D, BN>(p_s, LDP, v_s, L::tile, o_s, L::acc);
  }
  __syncthreads();
  if (q0 + row < Sq) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    T* ob = out + ((int64_t)b * Sq + q0 + row) * qs + (int64_t)h * D;
    for (int c = part * DPT; c < (part + 1) * DPT; ++c)
      ob[c] = from_f<T>(o_s[row * L::acc + c] * inv);
    if (part == 0) lse[((int64_t)b * Hq + h) * Sq + q0 + row] = m + logf(lc);
  }
}

// ---- dQ -------------------------------------------------------------------

template <typename T, int D, int BM, int BN>
struct DqSmem {
  using L = Ld<T, D>;
  static constexpr size_t q_tile = align128(sizeof(T) * BM * L::tile);
  static constexpr size_t kv_tile = align128(sizeof(T) * BN * L::tile);
  static constexpr size_t score = align128(4 * BM * L::score(BN));
  static constexpr size_t prob = L::kBf16 ? align128(2 * BM * L::prob(BN)) : 0;
  static constexpr size_t acc = align128(4 * BM * L::acc);
  static constexpr size_t rows = align128(4 * BM);
  static constexpr size_t segs = align128(4 * BM) + align128(4 * BN);
  static constexpr size_t bytes = 2 * q_tile + 2 * kv_tile + 2 * score + prob + acc + 2 * rows +
                                  segs;
  static_assert(bytes <= kSmemMax, "dQ tiles exceed shared memory");
};

template <typename T, int D, int BM, int BN, bool kModes>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Modes md, int Sq,
                    int Sk, int Hq, int Hkv, int causal, float scale) {
  using L = Ld<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* q_s = cv.take<T>(BM * L::tile);
  T* do_s = cv.take<T>(BM * L::tile);
  T* k_s = cv.take<T>(BN * L::tile);
  T* v_s = cv.take<T>(BN * L::tile);
  float* s_s = cv.take<float>(BM * L::score(BN));
  float* dp_s = cv.take<float>(BM * L::score(BN));
  T* ds_s;
  if constexpr (L::kBf16) ds_s = cv.take<T>(BM * L::prob(BN));
  else ds_s = reinterpret_cast<T*>(s_s);          // fp32: ds overwrites s in place
  float* acc = cv.take<float>(BM * L::acc);
  float* lse_s = cv.take<float>(BM);
  float* delta_s = cv.take<float>(BM);
  int* segq_s = cv.take<int>(BM);
  int* segk_s = cv.take<int>(BN);
  constexpr int LDS = L::score(BN), LDP = L::prob(BN);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int64_t qs = (int64_t)Hq * D, ks = (int64_t)Hkv * D;
  const int64_t qoff = (int64_t)b * Sq * qs + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Sk * ks + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * Sk * ks + (int64_t)hk * D;
  const int64_t roff = ((int64_t)b * Hq + h) * Sq;
  const bool has_seg = kModes && md.seg_q != nullptr;
  const bool modes = has_seg || (kModes && md.mask != nullptr);
  const float sc = modes ? 1.f : scale;
  const float* mp = kModes && md.mask ? md.mask + b * md.mask_sb + h * md.mask_sh : nullptr;
  const bool drop = kModes && md.seed != nullptr;
  const uint32_t dbase = drop ? drop_base((uint32_t)*md.seed, b, h) : 0u;
  ModeTile<BM, BN, false> mt;

  load_tile<T, D>(q_s, L::tile, q + qoff, qs, q0, BM, Sq);
  load_tile<T, D>(do_s, L::tile, dout + qoff, qs, q0, BM, Sq);
  if (has_seg) load_seg(segq_s, md.seg_q + (int64_t)b * Sq, q0, BM, Sq, -1);
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const bool in = q0 + r < Sq;
    lse_s[r] = in ? lse[roff + q0 + r] : 0.f;
    delta_s[r] = in ? delta[roff + q0 + r] : 0.f;
  }
  zero(acc, BM * L::acc);

  const int n_kt = kv_tiles<BM, BN>(q0, Sq, Sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<T, D>(k_s, L::tile, kb, ks, k0, BN, Sk);
    load_tile<T, D>(v_s, L::tile, vb, ks, k0, BN, Sk);
    if (has_seg) load_seg(segk_s, md.seg_k + (int64_t)b * Sk, k0, BN, Sk, -2);
    if (mp) mt.prefetch(mp, q0, k0, Sq, Sk);
    __syncthreads();
    mm_nt<BM, BN, D>(q_s, L::tile, k_s, L::tile, s_s, LDS);
    mm_nt<BM, BN, D>(do_s, L::tile, v_s, L::tile, dp_s, LDS);
    __syncthreads();
    if (modes) {
      mt.apply(s_s, LDS, mp != nullptr, segq_s, segk_s, has_seg, scale);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const float p = masked(q0 + r, k0 + c, Sq, Sk, causal)
                          ? 0.f : expf(s_s[r * LDS + c] * sc - lse_s[r]);
      float dp = dp_s[r * LDS + c];
      if (drop) dp = drop_keep(dbase, q0 + r, k0 + c, md.thresh) ? dp * md.inv : 0.f;
      ds_s[r * LDP + c] = from_f<T>(p * (dp - delta_s[r]));
    }
    __syncthreads();
    mm_nn_acc<BM, D, BN>(ds_s, LDP, k_s, L::tile, acc, L::acc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < Sq) dq[qoff + (int64_t)(q0 + r) * qs + c] = from_f<T>(acc[r * L::acc + c] * scale);
  }
}

// ---- dK / dV --------------------------------------------------------------

template <typename T, int D, int BM, int BN>
struct DkvSmem {
  using L = Ld<T, D>;
  static constexpr size_t kv_tile = align128(sizeof(T) * BM * L::tile);
  static constexpr size_t q_tile = align128(sizeof(T) * BN * L::tile);
  static constexpr size_t score = align128(4 * BM * L::score(BN));
  static constexpr size_t prob = L::kBf16 ? align128(2 * BM * L::prob(BN)) : 0;
  static constexpr size_t acc = align128(4 * BM * L::acc);
  static constexpr size_t rows = align128(4 * BN);
  static constexpr size_t segs = align128(4 * BM) + align128(4 * BN);
  static constexpr size_t bytes = 2 * kv_tile + 2 * q_tile + 2 * score + 2 * prob + 2 * acc +
                                  2 * rows + segs;
  static_assert(bytes <= kSmemMax, "dK/dV tiles exceed shared memory");
};

template <typename T, int D, int BM, int BN, bool kModes>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Modes md, int Sq, int Sk, int Hq, int Hkv, int causal, float scale) {
  using L = Ld<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* k_s = cv.take<T>(BM * L::tile);
  T* v_s = cv.take<T>(BM * L::tile);
  T* q_s = cv.take<T>(BN * L::tile);
  T* do_s = cv.take<T>(BN * L::tile);
  float* st_s = cv.take<float>(BM * L::score(BN));     // s^T  [kv][q]
  float* dpt_s = cv.take<float>(BM * L::score(BN));    // dp^T [kv][q]
  T *pt_s, *dst_s;
  if constexpr (L::kBf16) {
    pt_s = cv.take<T>(BM * L::prob(BN));
    dst_s = cv.take<T>(BM * L::prob(BN));
  } else {                                             // fp32: in place
    pt_s = reinterpret_cast<T*>(st_s);
    dst_s = reinterpret_cast<T*>(dpt_s);
  }
  float* dk_acc = cv.take<float>(BM * L::acc);
  float* dv_acc = cv.take<float>(BM * L::acc);
  float* lse_s = cv.take<float>(BN);
  float* delta_s = cv.take<float>(BN);
  int* segk_s = cv.take<int>(BM);
  int* segq_s = cv.take<int>(BN);
  constexpr int LDS = L::score(BN), LDP = L::prob(BN);

  const int k0 = blockIdx.x * BM;                      // heaviest (first) tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int64_t qs = (int64_t)Hq * D, ks = (int64_t)Hkv * D;
  const int64_t koff = (int64_t)b * Sk * ks + (int64_t)hk * D;
  const bool has_seg = kModes && md.seg_q != nullptr;
  const bool modes = has_seg || (kModes && md.mask != nullptr);
  const float sc = modes ? 1.f : scale;
  const bool drop = kModes && md.seed != nullptr;
  const uint32_t seed = drop ? (uint32_t)*md.seed : 0u;
  ModeTile<BM, BN, true> mt;

  load_tile<T, D>(k_s, L::tile, k + koff, ks, k0, BM, Sk);
  load_tile<T, D>(v_s, L::tile, v + koff, ks, k0, BM, Sk);
  if (has_seg) load_seg(segk_s, md.seg_k + (int64_t)b * Sk, k0, BM, Sk, -2);
  zero(dk_acc, BM * L::acc);
  zero(dv_acc, BM * L::acc);

  // first q tile whose last row reaches this kv tile
  const int first = k0 - (Sk - Sq);
  const int jq0 = (causal && first > 0) ? first / BN : 0;
  const int n_qt = (Sq + BN - 1) / BN;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;                     // the q-head: mask and hash
    const int64_t qoff = (int64_t)b * Sq * qs + (int64_t)h * D;
    const int64_t roff = ((int64_t)b * Hq + h) * Sq;
    const uint32_t dbase = drop ? drop_base(seed, b, h) : 0u;
    const float* mp = kModes && md.mask ? md.mask + b * md.mask_sb + h * md.mask_sh : nullptr;
    for (int jq = jq0; jq < n_qt; ++jq) {
      const int q0 = jq * BN;
      __syncthreads();
      load_tile<T, D>(q_s, L::tile, q + qoff, qs, q0, BN, Sq);
      load_tile<T, D>(do_s, L::tile, dout + qoff, qs, q0, BN, Sq);
      for (int r = threadIdx.x; r < BN; r += kThreads) {
        const bool in = q0 + r < Sq;
        lse_s[r] = in ? lse[roff + q0 + r] : 0.f;
        delta_s[r] = in ? delta[roff + q0 + r] : 0.f;
      }
      if (has_seg) load_seg(segq_s, md.seg_q + (int64_t)b * Sq, q0, BN, Sq, -1);
      if (mp) mt.prefetch(mp, q0, k0, Sq, Sk);
      __syncthreads();
      mm_nt<BM, BN, D>(k_s, L::tile, q_s, L::tile, st_s, LDS);
      mm_nt<BM, BN, D>(v_s, L::tile, do_s, L::tile, dpt_s, LDS);
      __syncthreads();
      if (modes) {
        mt.apply(st_s, LDS, mp != nullptr, segq_s, segk_s, has_seg, scale);
        __syncthreads();
      }
      for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
        const int r = i / BN, c = i % BN;                 // kv row r, q column c
        const float p = masked(q0 + c, k0 + r, Sq, Sk, causal)
                            ? 0.f : expf(st_s[r * LDS + c] * sc - lse_s[c]);
        float dp = dpt_s[r * LDS + c], pd = p;
        if (drop) {
          const bool keep = drop_keep(dbase, q0 + c, k0 + r, md.thresh);
          dp = keep ? dp * md.inv : 0.f;
          pd = keep ? p * md.inv : 0.f;
        }
        // both reads before the stores: pt_s may alias delta_s for the compiler
        const float ds = p * (dp - delta_s[c]);
        pt_s[r * LDP + c] = from_f<T>(pd);
        dst_s[r * LDP + c] = from_f<T>(ds);
      }
      __syncthreads();
      mm_nn_acc<BM, D, BN>(pt_s, LDP, do_s, L::tile, dv_acc, L::acc);   // dV += P^T dO
      mm_nn_acc<BM, D, BN>(dst_s, LDP, q_s, L::tile, dk_acc, L::acc);   // dK += dS^T Q
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (k0 + r < Sk) {
      const int64_t o = koff + (int64_t)(k0 + r) * ks + c;
      dk[o] = from_f<T>(dk_acc[r * L::acc + c] * scale);
      dv[o] = from_f<T>(dv_acc[r * L::acc + c]);
    }
  }
}

// ---- launches -------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, bool kModes>
cudaError_t fwd_as(const void* q, const void* k, const void* v, void* out, float* lse,
                   const Modes& md, const Dims& d, cudaStream_t s) {
  constexpr int BM = Cfg<T, D>::fwd_bm, BN = Cfg<T, D>::fwd_bn;
  constexpr size_t bytes = FwdSmem<T, D, BM, BN>::bytes;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D, BM, BN, kModes>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((d.Sq + BM - 1) / BM, d.Hq, d.B);
  flash_fwd_kernel<T, D, BM, BN, kModes><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, md, d.Sq, d.Sk, d.Hq, d.Hkv, d.causal, scale_of<D>());
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                const Modes& md, const Dims& d, cudaStream_t s) {
  return any_mode(md) ? fwd_as<T, D, true>(q, k, v, out, lse, md, d, s)
                      : fwd_as<T, D, false>(q, k, v, out, lse, md, d, s);
}

template <typename T, int D, bool kModes>
cudaError_t bwd_dq_as(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const Modes& md,
                      const Dims& d, cudaStream_t s) {
  constexpr int BM = Cfg<T, D>::dq_bm, BN = Cfg<T, D>::dq_bn;
  constexpr size_t bytes = DqSmem<T, D, BM, BN>::bytes;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D, BM, BN, kModes>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((d.Sq + BM - 1) / BM, d.Hq, d.B);
  flash_bwd_dq_kernel<T, D, BM, BN, kModes><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), md, d.Sq, d.Sk, d.Hq,
      d.Hkv, d.causal, scale_of<D>());
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, const Modes& md,
                   const Dims& d, cudaStream_t s) {
  return any_mode(md) ? bwd_dq_as<T, D, true>(q, k, v, dout, lse, delta, dq, md, d, s)
                      : bwd_dq_as<T, D, false>(q, k, v, dout, lse, delta, dq, md, d, s);
}

template <typename T, int D, bool kModes>
cudaError_t bwd_dkv_as(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const Modes& md, const Dims& d, cudaStream_t s) {
  constexpr int BM = Cfg<T, D>::dkv_bm, BN = Cfg<T, D>::dkv_bn;
  constexpr size_t bytes = DkvSmem<T, D, BM, BN>::bytes;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D, BM, BN, kModes>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((d.Sk + BM - 1) / BM, d.Hkv, d.B);
  flash_bwd_dkv_kernel<T, D, BM, BN, kModes><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), md,
      d.Sq, d.Sk, d.Hq, d.Hkv, d.causal, scale_of<D>());
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, const Modes& md,
                    const Dims& d, cudaStream_t s) {
  return any_mode(md) ? bwd_dkv_as<T, D, true>(q, k, v, dout, lse, delta, dk, dv, md, d, s)
                      : bwd_dkv_as<T, D, false>(q, k, v, dout, lse, delta, dk, dv, md, d, s);
}

// Calls FN<T, D>(args...) for the dtypes and head dims this route serves:
// float32 (dtype 0) at D 64, 96, 128 and 256, bfloat16 (dtype 1) at D 96
// and 256.  bf16 at D 64 and 128 is the sm90 route's (the wrapper's
// _route: flash_attention_fwd_sm90.cu, flash_attention_bwd_sm90.cu), so it
// is neither built nor taken here.
#define PTT_DISPATCH_MMA(FN, ...)                                             \
  do {                                                                        \
    if (dtype == 0 && d.D == 64) return static_cast<int>(FN<float, 64>(__VA_ARGS__));   \
    if (dtype == 0 && d.D == 96) return static_cast<int>(FN<float, 96>(__VA_ARGS__));   \
    if (dtype == 0 && d.D == 128) return static_cast<int>(FN<float, 128>(__VA_ARGS__)); \
    if (dtype == 0 && d.D == 256) return static_cast<int>(FN<float, 256>(__VA_ARGS__)); \
    if (dtype == 1 && d.D == 96) return static_cast<int>(FN<bf16, 96>(__VA_ARGS__));    \
    if (dtype == 1 && d.D == 256) return static_cast<int>(FN<bf16, 256>(__VA_ARGS__));  \
    return static_cast<int>(cudaErrorInvalidValue);                           \
  } while (0)

}  // namespace

// Plain C entry points, loaded with ctypes.  Tensors are contiguous
// [b, s, h, d] (q, out, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv,
// D]) and 16-byte aligned; lse and delta are fp32 [B, Hq, Sq].  dtype: 0 =
// float32, 1 = bfloat16 (all of q, k, v, dout and the outputs).  D is 64,
// 96, 128 or 256 for float32 and 96 or 256 for bfloat16 (bf16 at 64 and 128
// is refused: it runs the ptt_flash_*_sm90 entry points), Hkv divides Hq,
// Sq and Sk are positive, and a causal call has Sq <= Sk.  The modes: mask (fp32 [B|1, Hq|1, Sq, Sk], with its batch
// and head strides, 0 where it broadcasts) or null; seg_q / seg_k (int32
// [B, Sq] / [B, Sk]) or null; seed (int32 [1] on the device) or null for no
// dropout, with the keep threshold and 1 / (1 - rate).  The Python wrapper
// checks all of it.  Each returns the cudaError_t of its launch (0 =
// success).
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             void* lse, const void* mask, int64_t mask_sb, int64_t mask_sh,
                             const void* seg_q, const void* seg_k, const void* seed,
                             uint32_t thresh, float inv, int B, int Sq, int Sk, int Hq,
                             int Hkv, int D, int causal, int dtype, void* stream) {
  const Dims d{B, Sq, Sk, Hq, Hkv, D, causal};
  const Modes md = make_modes(mask, mask_sb, mask_sh, seg_q, seg_k, seed, thresh, inv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_MMA(fwd, q, k, v, out, static_cast<float*>(lse), md, d, s);
}

extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, const void* mask, int64_t mask_sb, int64_t mask_sh,
                                const void* seg_q, const void* seg_k, const void* seed,
                                uint32_t thresh, float inv, int B, int Sq, int Sk, int Hq,
                                int Hkv, int D, int causal, int dtype, void* stream) {
  const Dims d{B, Sq, Sk, Hq, Hkv, D, causal};
  const Modes md = make_modes(mask, mask_sb, mask_sh, seg_q, seg_k, seed, thresh, inv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_MMA(bwd_dq, q, k, v, dout, static_cast<const float*>(lse),
                   static_cast<const float*>(delta), dq, md, d, s);
}

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, const void* mask, int64_t mask_sb,
                                 int64_t mask_sh, const void* seg_q, const void* seg_k,
                                 const void* seed, uint32_t thresh, float inv, int B, int Sq,
                                 int Sk, int Hq, int Hkv, int D, int causal, int dtype,
                                 void* stream) {
  const Dims d{B, Sq, Sk, Hq, Hkv, D, causal};
  const Modes md = make_modes(mask, mask_sb, mask_sh, seg_q, seg_k, seed, thresh, inv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_MMA(bwd_dkv, q, k, v, dout, static_cast<const float*>(lse),
                   static_cast<const float*>(delta), dk, dv, md, d, s);
}
