// Ragged paged attention for Hopper (sm_90a), prefill chunks: wgmma tiles
// fed by a TMA ring over the paged pool.
//
// Replaces: paddle_tpu/kernels/paged_attention.py:_ragged_paged_attn_kernel
// (the Pallas TPU kernel, float mode and quantized=True) for the query shapes
// of prefill chunks, the "sm90" route of kernels/paged_attention.py:_route:
// more than 16 query rows a kv-head (R = T * group > 16), q and the fresh
// rows bf16, the pool bf16 or int8, head_dim 64 or 128, a GQA group that
// divides 64, 16-byte aligned operands.  Decode keeps the "split" route and
// the rest (fp32 q, an fp32 pool, q and pool of other dtypes) the "tile"
// kernel, both in ragged_paged_attention.cu.  It computes what the plain
// _reference_ragged_paged_attention computes: for each sequence b, query
// token t < T and query head, softmax attention over the sequence's cached
// context (context_lens[b] tokens, clamped to W * page_size, in pages of the
// pool [kv_heads, num_pages, page_size, head_dim] addressed by
// block_tables[b, :]), then this step's own fresh rows k_new/v_new
// [B, T, kv_heads, head_dim], token t seeing fresh row j only if j <= t and
// j < q_lens[b] (masked keys at -1e30, the TPU kernel's mask value); scale
// 1/sqrt(head_dim); l clamped to 1e-30 so idle rows and rows past q_lens
// stay finite; out in bf16, lse in fp32.  An int8 pool carries one fp32
// scale per (kv-head, page): the codes go through the tensor cores as bf16
// (exact: every int8 value is a bf16) and the scales are applied in fp32,
// k_scale on S's columns and v_scale on P's columns before P is rounded.
//
// What bounds it on this card: bytes.  A prefill chunk reads every live K/V
// row of the context once per kv-head and does 4 flops per K/V element and
// query row: at the serve phases' last chunk (llama2_7b, B 8, T 64, 32
// heads, d 128, context 448 each, bf16) 75.6 MB (0.0226 ms at 3.35 TB/s)
// against 4.3 GFLOP (0.0043 ms at 989 TFLOP/s).  The int8 pool halves the
// K/V bytes.
//
// What the design does about it:
// - One CTA per (64 query rows, kv-head, sequence), 160 threads: warps 0-3
//   are one consumer warpgroup, warp 4 the producer.  Query row r = t *
//   group + g holds every query head of the kv-head's GQA group, so K/V are
//   read once per 64 rows (a llama2_7b chunk of T 64 is one CTA a head,
//   where the tile kernel's 16-row CTAs read it four times).  Two CTAs fit
//   an SM (__launch_bounds__(160, 2), at most ~100 KB of shared memory).
// - The producer loads Q once (a 4-D tensor map over [B, T, qh, d] whose
//   box is 64 / group tokens x group heads: the 64 rows in r order), then
//   the live context in 64-key tiles into a ring of kStages stages guarded
//   by full/empty mbarriers.  The pool is a 2-D map [kv_heads * num_pages *
//   page_size, d]; a key tile is 64 / box boxes of box = gcd(page_size, 64)
//   rows, each inside one page, lane j issuing box j from its block-table
//   entry (read on the device; entries past the context are never read).
//   A box past the context loads from a row past the pool's end, which TMA
//   fills with zeros.  bf16 lands 128-byte swizzled, K-major, as wgmma
//   reads it; int8 lands raw, and the producer lanes write the tile's 64
//   key and value scales beside it.  Then the fresh rows in 64-key tiles
//   (bf16 pool: through the ring, a 4-D map over [B, T, kvh, d] whose
//   positions past T load as zeros; int8 pool: read by the consumers).
// - The consumers run S = Q K^T by wgmma (both operands K-major in shared
//   memory), the online softmax on S's fp32 fragment (the row max over the
//   quad of threads that owns a row, ex2.approx, the accumulator rescaled
//   in registers), P packed to bf16 as the A operand of O += P V (V read
//   MN-major).  An int8 tile is first converted to bf16 in shared memory by
//   the consumers (a byte placed in a float's mantissa, exact), the stage
//   released only after its P V product (its scales live in it).  Keys past
//   the context are -inf (never counted); fresh keys past the causal
//   diagonal or q_lens -1e30.  A tile whose rows are all past q_lens reads
//   nothing and writes out 0 (l = 0, clamped) and a finite lse.
// - Finalisation: l = max(l, 1e-30), out = acc / l stored as bf16 pairs
//   straight from the fragment, lse = m * scale + log(l).  No atomics: two
//   runs give the same bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 160;          // one consumer warpgroup + one producer warp
constexpr int kConsumers = 128;
constexpr int kBM = 64;                // query rows of a CTA
constexpr int kBN = 64;                // keys of a tile
constexpr uint32_t kBudget = 100 * 1024;   // shared memory a CTA, two CTAs an SM
constexpr float kNegInf = -1e30f;      // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: Q (64 rows); for an int8 pool the consumers' bf16 K and V
// tiles; the ring (per stage a K and a V tile as they land: bf16 swizzled,
// or int8 row-major [64][D]); for an int8 pool each stage's 64 key and 64
// value scales; the barriers.  A bf16 tile is D / 64 column blocks of 64
// rows x 128 bytes (sm90.cuh).
template <int D, bool kQuant>
struct PrefillSmem {
  static constexpr uint32_t tile = kBN * D * 2;
  static constexpr uint32_t raw = kQuant ? kBN * D : tile;   // one K or V tile in the ring
  static constexpr uint32_t stage = 2 * raw;
  static constexpr uint32_t off_q = 0;
  static constexpr uint32_t off_conv = tile;                  // int8: K, then V
  static constexpr uint32_t off_ring = kQuant ? 3 * tile : tile;
  static constexpr int kStages =
      (kBudget - off_ring) / stage < 4 ? (kBudget - off_ring) / stage : 4;
  static constexpr uint32_t off_sc = off_ring + kStages * stage;    // float [kStages][2][64]
  static constexpr uint32_t off_bar = off_sc + (kQuant ? kStages * 2 * kBN * 4 : 0);
  static constexpr uint32_t bytes = off_bar + (1 + 2 * kStages) * 8 + 1024;   // + alignment
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(bytes <= 113 * 1024, "two CTAs must fit an SM");
};

// byte offset of 16-byte chunk `ch` (8 bf16 along d) of row `row` in a
// 128-byte-swizzled bf16 tile of 64 rows
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return (ch >> 3) * (kBN * 128) + row * 128 + (((ch & 7) ^ (row & 7)) << 4);
}

// 4 int8 codes -> 4 bf16 (two pairs), exactly: the byte (code + 128, by the
// xor) in the mantissa of 2^23, less 2^23 + 128
__device__ __forceinline__ uint2 codes_to_bf16(uint32_t u) {
  u ^= 0x80808080u;
  const float base = 8388736.f;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - base;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - base;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - base;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - base;
  return make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));
}

// An int8 tile [64][D] (row-major, as TMA lands it) into a swizzled bf16
// tile; thread t of the warpgroup converts chunks t, t + 128, ...
template <int D>
__device__ __forceinline__ void convert_tile(unsigned char* dst, const unsigned char* raw,
                                             int t) {
  constexpr int kChunks = kBN * D / 8;
#pragma unroll
  for (int u = 0; u < kChunks / kConsumers; ++u) {
    const int i = t + kConsumers * u, row = i / (D / 8), ch = i % (D / 8);
    const uint2 c = *reinterpret_cast<const uint2*>(raw + row * D + ch * 8);
    const uint2 lo = codes_to_bf16(c.x), hi = codes_to_bf16(c.y);
    *reinterpret_cast<uint4*>(dst + swz(row, ch)) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// Fresh rows j0 .. j0 + 63 of one kv-head ([B, T, kvh, D] bf16) into a
// swizzled tile; rows past T are zeros
template <int D>
__device__ __forceinline__ void load_fresh(unsigned char* dst, const bf16* __restrict__ src,
                                           int b, int T, int kvh, int h, int j0, int t) {
  constexpr int kChunks = kBN * D / 8;
  uint4 v[kChunks / kConsumers];
#pragma unroll
  for (int u = 0; u < kChunks / kConsumers; ++u) {
    const int i = t + kConsumers * u, row = i / (D / 8), ch = i % (D / 8), j = j0 + row;
    v[u] = j < T ? *reinterpret_cast<const uint4*>(src + (((int64_t)b * T + j) * kvh + h) * D +
                                                   ch * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < kChunks / kConsumers; ++u) {
    const int i = t + kConsumers * u;
    *reinterpret_cast<uint4*>(dst + swz(i / (D / 8), i % (D / 8))) = v[u];
  }
}

// T: q / fresh rows / out (bf16); the pool bf16 (kQuant false) or int8.
// Grid (row tiles, kv-heads, sequences).
template <int D, bool kQuant>
__global__ void __launch_bounds__(kThreads, 2)
ragged_paged_attn_prefill_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_kn,
    const __grid_constant__ CUtensorMap tm_vn, const bf16* __restrict__ k_new,
    const bf16* __restrict__ v_new, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ context_lens, const int32_t* __restrict__ q_lens,
    bf16* __restrict__ out, float* __restrict__ lse, int T, int qh, int kvh, int num_pages,
    int page_size, int W, int box_rows, int oob_row, float scale) {
  using L = PrefillSmem<D, kQuant>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::off_bar);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + S;

  const int h = blockIdx.y, b = blockIdx.z;
  const int group = qh / kvh, r0 = blockIdx.x * kBM, R = T * group;
  int ctx = context_lens[b];
  ctx = max(0, min(ctx, W * page_size));     // the reference masks within W pages
  const int ql = min(q_lens ? q_lens[b] : T, T);
  const bool has_new = k_new != nullptr;
  // the tile reads K/V only if one of its rows is a valid query token, and
  // the fresh keys its valid rows can see
  const bool live = r0 / group < ql;
  const int fresh_keys = has_new ? min(ql, (r0 + kBM - 1) / group + 1) : 0;
  const int n_ctx = live ? (ctx + kBN - 1) / kBN : 0;
  const int n_it = n_ctx + (live ? (fresh_keys + kBN - 1) / kBN : 0);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {           // ---- producer warp
    const int lane = threadIdx.x - kConsumers;
    if (n_it == 0) return;
    if (lane == 0) {
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(q_bar, L::tile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(smem + L::off_q + c * kBN * 128, &tm_q, q_bar, 64 * c, h * group,
                    r0 / group, b);
    }
    const int64_t bt_row = (int64_t)b * W;
    auto pool_row = [&](int key) {           // the pool row of a live context key
      const int page = min(max(block_tables[bt_row + key / page_size], 0), num_pages - 1);
      return ((int64_t)h * num_pages + page) * page_size + key % page_size;
    };
    const int n_ring = kQuant ? n_ctx : n_it;
    const int n_box = kBN / box_rows;
    for (int it = 0; it < n_ring; ++it) {
      const int s = it % S;
      mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
      unsigned char* ks = smem + L::off_ring + s * L::stage;
      unsigned char* vs = ks + L::raw;
      if (lane == 0) mbar_expect_tx(&full[s], L::stage);
      if (it < n_ctx) {
        const int k0 = it * kBN;
        if (lane < n_box) {
          const int key = k0 + lane * box_rows;
          const int row = key < ctx ? static_cast<int>(pool_row(key)) : oob_row;
          if constexpr (kQuant) {
            tma_load_2d(ks + lane * box_rows * D, &tm_k, &full[s], 0, row);
            tma_load_2d(vs + lane * box_rows * D, &tm_v, &full[s], 0, row);
          } else {
#pragma unroll
            for (int c = 0; c < D / 64; ++c) {
              tma_load_2d(ks + c * kBN * 128 + lane * box_rows * 128, &tm_k, &full[s], 64 * c, row);
              tma_load_2d(vs + c * kBN * 128 + lane * box_rows * 128, &tm_v, &full[s], 64 * c, row);
            }
          }
        }
        if constexpr (kQuant) {
          float* sc = reinterpret_cast<float*>(smem + L::off_sc) + s * 2 * kBN;
          for (int j = lane; j < kBN; j += 32) {
            const int key = k0 + j;
            float ksv = 0.f, vsv = 0.f;
            if (key < ctx) {
              const int page = min(max(block_tables[bt_row + key / page_size], 0), num_pages - 1);
              ksv = k_scale[(int64_t)h * num_pages + page];
              vsv = v_scale[(int64_t)h * num_pages + page];
            }
            sc[j] = ksv;
            sc[kBN + j] = vsv;
          }
        }
      } else if constexpr (!kQuant) {
        if (lane == 0) {
          const int j0 = (it - n_ctx) * kBN;
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(ks + c * kBN * 128, &tm_kn, &full[s], 64 * c, h, j0, b);
            tma_load_4d(vs + c * kBN * 128, &tm_vn, &full[s], 64 * c, h, j0, b);
          }
        }
      }
      mbar_arrive(&full[s]);     // every lane, after its stores
    }
    return;
  }

  // ---- consumers: the warpgroup owns rows r0 .. r0 + 63
  const int t = threadIdx.x;
  const float c2 = scale * kLog2e;           // scores stay raw q k^T
  int t_r[2];                                // the token of this thread's two rows
#pragma unroll
  for (int j = 0; j < 2; ++j) t_r[j] = (r0 + frag_row(t, 2 * j)) / group;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};   // l_r: this thread's part
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const unsigned char* q_s = smem + L::off_q;
  if (n_it > 0) mbar_wait(q_bar, 0);

  for (int it = 0; it < n_it; ++it) {
    const bool is_ctx = it < n_ctx;
    const int s = it % S;
    const unsigned char* ks;
    const unsigned char* vs;
    const float* sc = reinterpret_cast<const float*>(smem + L::off_sc) + s * 2 * kBN;
    if constexpr (kQuant) {
      unsigned char* kc = smem + L::off_conv;
      bar_sync(1, kConsumers);               // the previous tile's products are done
      if (is_ctx) {
        mbar_wait(&full[s], (it / S) & 1);
        const unsigned char* raw = smem + L::off_ring + s * L::stage;
        convert_tile<D>(kc, raw, t);
        convert_tile<D>(kc + L::tile, raw + L::raw, t);
      } else {
        const int j0 = (it - n_ctx) * kBN;
        load_fresh<D>(kc, k_new, b, T, kvh, h, j0, t);
        load_fresh<D>(kc + L::tile, v_new, b, T, kvh, h, j0, t);
      }
      fence_proxy_async();                   // the tiles, to wgmma's proxy
      bar_sync(1, kConsumers);
      ks = kc;
      vs = kc + L::tile;
    } else {
      mbar_wait(&full[s], (it / S) & 1);
      ks = smem + L::off_ring + s * L::stage;
      vs = ks + L::raw;
    }
    float sv[32];
    wgmma_fence();
    wgmma_scores<D, kBM>(sv, q_s, ks);       // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sv);
    if (is_ctx) {
      const int k0 = it * kBN;
      if constexpr (kQuant) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sv[i] *= sc[frag_col(t, i)];
      }
      if (k0 + kBN > ctx) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + frag_col(t, i) >= ctx) sv[i] = -CUDART_INF_F;   // no key: never counted
      }
    } else {
      const int j0 = (it - n_ctx) * kBN;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = j0 + frag_col(t, i), tr = t_r[(i >> 1) & 1];
        if (j >= T) sv[i] = -CUDART_INF_F;
        else if (j > tr || j >= ql) sv[i] = kNegInf;
      }
    }
    // online softmax: the rows' new max over the quad, the rescale
    float mx[2] = {m_r[0], m_r[1]}, alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sv[i]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      alpha[j] = ex2_approx((m_r[j] - mx[j]) * c2);
      m_r[j] = mx[j];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      // subtract first: a row at -1e30 must give exactly p = 1
      const float p = ex2_approx((sv[i] - m_r[(i >> 1) & 1]) * c2);
      rs[(i >> 1) & 1] += p;
      sv[i] = p;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l_r[j] = l_r[j] * alpha[j] + rs[j];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    if constexpr (kQuant) {
      if (is_ctx) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sv[i] *= sc[kBN + frag_col(t, i)];   // v_scale on P's columns
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag_to_a(sv, kk, pa[kk]);
    fence_regs(acc);
    wgmma_fence();
    wgmma_accumulate<D>(acc, pa, vs);        // O += P V
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if ((!kQuant || is_ctx) && (t & 31) == 0) mbar_arrive(&empty[s]);
  }

  // out = acc / l, bf16 pairs straight from the fragment; lse per row
  float inv_l[2], log_l[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float l = l_r[j] + __shfl_xor_sync(0xffffffffu, l_r[j], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    inv_l[j] = 1.f / l;
    log_l[j] = logf(l);
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = r0 + frag_row(t, i);
    if (r < R) {
      const float il = inv_l[(i >> 1) & 1];
      const int64_t row = ((int64_t)b * T + r / group) * qh + h * group + r % group;
      *reinterpret_cast<__nv_bfloat162*>(out + row * D + frag_col(t, i)) =
          __floats2bfloat162_rn(acc[i] * il, acc[i + 1] * il);
    }
  }
  if ((t & 3) == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + frag_row(t, 2 * j);
      if (r < R)
        lse[((int64_t)b * T + r / group) * qh + h * group + r % group] = m_r[j] * scale + log_l[j];
    }
  }
}

// ---- launch ---------------------------------------------------------------

// q [B, T, qh, D] bf16 as a 4-D map {d, head, token, batch} whose box is 64
// columns x `group` heads x 64 / group tokens x 1: the 64 rows r = t * group
// + g of a row tile in order, 128-byte swizzled; tokens past T load as zeros
bool encode_q(CUtensorMap* map, const void* q, int B, int T, int qh, int D, int group) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)qh, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)qh * D * 2,
                                 (cuuint64_t)T * qh * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)group, (cuuint32_t)(kBM / group), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(q), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a pool [rows, D] as a 2-D map whose box is `box_rows` rows: bf16 64
// columns, 128-byte swizzled; int8 the whole row, as it is
bool encode_pool(CUtensorMap* map, const void* pool, int64_t rows, int D, int box_rows,
                 bool quant) {
  const uint64_t dims[2] = {(uint64_t)D, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)D * (quant ? 1 : 2)};
  const uint32_t box[2] = {(uint32_t)(quant ? D : 64), (uint32_t)box_rows};
  if (quant)
    return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_NONE, pool, 2,
                      dims, strides, box);
  return encode_bf16(map, pool, 2, dims, strides, box);
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <int D, bool kQuant>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* ks,
                   const void* vs, const void* bt, const void* cl, const void* ql,
                   const void* kn, const void* vn, void* out, void* lse, int B, int T, int qh,
                   int kvh, int num_pages, int page_size, int W, cudaStream_t stream) {
  const int group = qh / kvh;
  const int64_t rows = (int64_t)kvh * num_pages * page_size;
  if (group < 1 || kBM % group || rows + kBN > INT32_MAX || (kQuant && (!ks || !vs)))
    return cudaErrorInvalidValue;
  const int box_rows = gcd(page_size, kBN);
  CUtensorMap tq, tk, tv, tkn, tvn;
  memset(&tkn, 0, sizeof(tkn));
  memset(&tvn, 0, sizeof(tvn));
  if (!encode_q(&tq, q, B, T, qh, D, group) ||
      !encode_pool(&tk, kc, rows, D, box_rows, kQuant) ||
      !encode_pool(&tv, vc, rows, D, box_rows, kQuant))
    return cudaErrorInvalidValue;
  if (!kQuant && kn != nullptr &&
      (!encode_bshd(&tkn, kn, B, T, kvh, D, kBN) || !encode_bshd(&tvn, vn, B, T, kvh, D, kBN)))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = PrefillSmem<D, kQuant>::bytes;
  const cudaError_t attr =
      allow_dynamic_smem<ragged_paged_attn_prefill_sm90_kernel<D, kQuant>>(bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((T * group + kBM - 1) / kBM, kvh, B);
  ragged_paged_attn_prefill_sm90_kernel<D, kQuant><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, tkn, tvn, static_cast<const bf16*>(kn), static_cast<const bf16*>(vn),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int32_t*>(bt), static_cast<const int32_t*>(cl),
      static_cast<const int32_t*>(ql), static_cast<bf16*>(out), static_cast<float*>(lse), T, qh,
      kvh, num_pages, page_size, W, box_rows, static_cast<int>(rows), 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes, with the arguments of
// ragged_paged_attention.cu's ptt_ragged_paged_attention.  It takes q_dtype
// 1 (bfloat16; q, fresh rows and out), kv_dtype 1 (bfloat16) or 2 (int8,
// with k_scale/v_scale [kv_heads, num_pages] fp32), head_dim 64 or 128 and
// a GQA group that divides 64, and returns cudaErrorInvalidValue for
// anything else (or when a tensor map cannot be encoded); otherwise the
// cudaError_t of the launch (0 = success).  q_lens and k_new/v_new may be
// null (all T valid / no fresh rows).
extern "C" int ptt_ragged_paged_attention_sm90(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* context_lens,
    const void* q_lens, const void* k_new, const void* v_new, void* out, void* lse,
    int B, int T, int qh, int kvh, int head_dim, int num_pages, int page_size, int W,
    int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype != 1 || (kv_dtype != 1 && kv_dtype != 2) || (k_new == nullptr) != (v_new == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define PTT_ARGS q, k_cache, v_cache, k_scale, v_scale, block_tables, context_lens, q_lens, \
                 k_new, v_new, out, lse, B, T, qh, kvh, num_pages, page_size, W, s
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64)
    err = kv_dtype == 2 ? launch<64, true>(PTT_ARGS) : launch<64, false>(PTT_ARGS);
  else if (head_dim == 128)
    err = kv_dtype == 2 ? launch<128, true>(PTT_ARGS) : launch<128, false>(PTT_ARGS);
#undef PTT_ARGS
  return static_cast<int>(err);
}
