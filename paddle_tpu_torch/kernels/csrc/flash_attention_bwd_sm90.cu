// Flash-attention backward for Hopper (sm_90a), bf16 at head dims 64 and
// 128: dQ and dK/dV on wgmma, fed by TMA rings, warp-specialised.
//
// Replaces the Pallas TPU kernels of paddle_tpu/kernels/flash_attention.py:
//   - _fa_bwd_dq_kernel   (launched by _fa_pallas_backward)  -> flash_bwd_dq_sm90_kernel
//   - _fa_bwd_dkv_kernel  (launched by _fa_pallas_backward)  -> flash_bwd_dkv_sm90_kernel
// for bf16 inputs at d 64 and 128, in every mode (causal, GQA, additive mask,
// segment ids, dropout).  fp32, and bf16 at d 96 and 256, stay on the kernels
// of flash_attention.cu (kernels/flash_attention.py: _route).  They
// compute what the plain versions _flash_bwd_dq and _flash_bwd_dkv compute:
//
//   p = exp(s - lse),  s = scale q k^T (+ mask, -1e30 between segments)
//   dp = keep(dO v^T) / (1 - rate),  ds = p * (dp - delta)
//   dq = scale ds k,  dk = scale ds^T q (summed over the GQA group),
//   dv = (keep(p) / (1 - rate))^T dO (summed over the group)
//
// with p and ds rounded to bf16 before their products, as the mma route does.
// Layouts as in flash_attention.cu: q, k, v, dO, dq, dk, dv [b, s, h, d];
// lse and delta fp32 [b, hq, sq].
//
// What bounds them on this card: operations.  At the training shape (b 4,
// s 2048, 32 heads, d 128, causal) dQ is 3 matmuls of b*h*s^2*d/2 = 68.7
// GFLOP (0.208 ms at 989 TFLOP/s) and dK/dV 4 (0.278 ms); each moves a few
// tens of MB (0.02 ms at 3.35 TB/s).
//
// What the design does about it:
// - One CTA of three warpgroups.  Warpgroup 0 is the producer: one warp
//   issues TMA loads into a ring of kStages shared-memory stages, guarded by
//   full/empty mbarriers, and stores the stage's per-row values (lse, delta,
//   segment ids); setmaxnreg lowers it to kProducerRegs.  Warpgroups 1 and 2
//   are consumers, each owning 64 of the CTA's 128 rows, at kConsumerRegs
//   (ptxas: 0 spills; dK/dV's consumer holds 128 accumulator floats for dK
//   and dV, 64 for S^T and dP^T).
// - Every product is wgmma.mma_async (m64nNk16, fp32 accumulators in
//   registers), operands in 128-byte-swizzled shared memory written by TMA.
//   The first products (S, dP) are read back in registers; P and dS are
//   made in place and packed to bf16 as the A operand of the second products
//   (the accumulator's fragment layout is the A layout), so no score tile
//   touches shared memory.  The second products read K (dQ), Q and dO
//   (dK/dV) transposed through the descriptor (tnsp = 1).
// - dQ: one CTA per (128 q rows, q-head, batch); Q and dO loaded once, K
//   and V tiles of 64 rows streamed.  dK/dV: one CTA per (128 kv rows,
//   kv-head, batch); K and V loaded once, Q, dO, lse and delta tiles of 64
//   rows streamed over every q-head of the GQA group, whose sum stays in
//   registers.  The grid starts the heaviest tiles of kWindow (head,
//   batch) pairs first (work_of), so L2 holds the window's streamed
//   operands and the last wave is light.  Each output element is written
//   by one CTA after a sum in a fixed order: no atomics, two runs give the
//   same bits.
// - The element pass is short: one FFMA and one MUFU.EX2 (ex2.approx) for
//   P, two operations for dS, one conversion per bf16 pair.
// - Causal: tiles past the diagonal are never loaded; a consumer whose rows
//   need fewer tiles than its CTA's other consumer skips the extra ones;
//   only tiles that cross the diagonal or a sequence end are masked
//   element by element.  The modes build (kModes) applies mask, segments
//   and dropout to each accumulator element, its (row, column) from the
//   fragment layout; mask entries are read in the element pass (the two
//   accumulators of dK/dV leave no registers to prefetch them).
// - TMA zero-fills rows past a sequence end (the tensor maps are 4-D over
//   [b, s, h, d], so no tile crosses into the next batch row); stores past
//   Sq or Sk are skipped.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using namespace ptt_flash;
using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;          // producer warpgroup + 2 consumer warpgroups
constexpr int kBM = 128;               // the CTA's own rows, 64 a consumer
constexpr int kBN = 64;                // rows of each streamed tile
constexpr int kStages = 4;
constexpr int kWindow = 16;            // (head, batch) pairs the grid walks together
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kRegsNeeded = kProducerRegs * 128 + kConsumerRegs * 256;   // setmaxnreg
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kRowBytes = 128;    // one row of a 64-column block
constexpr uint32_t kBlockRows64 = kBN * kRowBytes;   // a 64-row, 64-column block: 8 KB

// A bf16 tile of R rows x D columns in shared memory: D / 64 blocks of
// R x 128 bytes (sm90.cuh), block c at c * R * 128.
template <int D>
constexpr uint32_t tile_bytes(int rows) { return rows * D * 2; }

// v[i], or with dropout v[i] / (1 - rate) where bit i of `keep` is set and 0
// where it is not
__device__ __forceinline__ float dropped(const float (&v)[32], int i, uint32_t keep, bool drop,
                                         float inv) {
  return drop ? (((keep >> i) & 1) ? v[i] * inv : 0.f) : v[i];
}

// ---- dQ -------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr uint32_t q = tile_bytes<D>(kBM);          // Q or dO
  static constexpr uint32_t kv = tile_bytes<D>(kBN);         // one K or V tile
  static constexpr uint32_t off_q = 0, off_do = q, off_k = 2 * q;   // stage s: K, then V
  static constexpr uint32_t off_segk = off_k + kStages * 2 * kv;   // int [kStages][kBN]
  static constexpr uint32_t off_bar = off_segk + kStages * kBN * 4;
  static constexpr uint32_t bytes = off_bar + (1 + 2 * kStages) * 8 + 1024;   // + alignment
  static_assert(bytes <= 232448, "dQ stages exceed shared memory");
};

template <int D, bool kModes>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq, Modes md,
                         int Sq, int Sk, int Hq, int Hkv, int causal, float scale) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::off_bar);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;
  int* segk_s = reinterpret_cast<int*>(smem + L::off_segk);

  const int n_q = (Sq + kBM - 1) / kBM;
  const Work wk = work_of<kWindow>(n_q, Hq, gridDim.x / (n_q * Hq));
  const int q0 = (n_q - 1 - wk.tile) * kBM;               // longest rows first
  const int h = wk.head, b = wk.batch;
  const int hk = h / (Hq / Hkv);
  const int n_kt = kv_tiles<kBM, kBN>(q0, Sq, Sk, causal);
  const bool has_seg = kModes && md.seg_q != nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup_idx() == 0) {              // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_map(&tm_k);
        tma_prefetch_map(&tm_v);
        mbar_arrive_expect_tx(q_bar, 2 * L::q);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(smem + L::off_q + c * kBM * kRowBytes, &tm_q, q_bar, 64 * c, h, q0, b);
          tma_load_4d(smem + L::off_do + c * kBM * kRowBytes, &tm_do, q_bar, 64 * c, h, q0, b);
        }
      }
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages, k0 = t * kBN;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        if (lane == 0) {
          unsigned char* ks = smem + L::off_k + s * 2 * L::kv;
          mbar_expect_tx(&full[s], 2 * L::kv);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(ks + c * kBlockRows64, &tm_k, &full[s], 64 * c, hk, k0, b);
            tma_load_4d(ks + L::kv + c * kBlockRows64, &tm_v, &full[s], 64 * c, hk, k0, b);
          }
        }
        if (has_seg) {
          for (int r = lane; r < kBN; r += 32)
            segk_s[s * kBN + r] = k0 + r < Sk ? md.seg_k[(int64_t)b * Sk + k0 + r] : -2;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup w owns rows qa .. qa + 63
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, w = warpgroup_idx() - 1;
    const int qa = q0 + 64 * w;
    const int n_mine = qa < Sq ? kv_tiles<64, kBN>(qa, Sq, Sk, causal) : 0;
    const int off = Sk - Sq;
    const int64_t roff = ((int64_t)b * Hq + h) * Sq;
    const float scale_log2 = scale * kLog2e;
    const float* mp = kModes && md.mask ? md.mask + b * md.mask_sb + h * md.mask_sh : nullptr;
    const bool drop = kModes && md.seed != nullptr;
    const uint32_t dbase = drop ? drop_base((uint32_t)*md.seed, b, h) : 0u;

    // this thread's two rows: frag_row(t, 0) and + 8
    float lse_r[2], delta_r[2];
    int segq_r[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qi = qa + frag_row(t, 2 * j);
      const bool in = qi < Sq;
      lse_r[j] = in ? lse[roff + qi] : 0.f;
      delta_r[j] = in ? delta[roff + qi] : 0.f;
      if (has_seg) segq_r[j] = in ? md.seg_q[(int64_t)b * Sq + qi] : -1;
    }
    const float lse2[2] = {lse_r[0] * kLog2e, lse_r[1] * kLog2e};

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const unsigned char* q_s = smem + L::off_q;
    const unsigned char* do_s = smem + L::off_do;
    const uint32_t a_off = w * kBlockRows64;
    mbar_wait(q_bar, 0);

    for (int it = 0; it < n_kt; ++it) {
      const int s = it % kStages, k0 = it * kBN;
      mbar_wait(&full[s], (it / kStages) & 1);
      if (it < n_mine) {
        const unsigned char* ks = smem + L::off_k + s * 2 * L::kv;
        const unsigned char* vs = ks + L::kv;
        float sv[32], dpv[32];
        wgmma_fence();
        wgmma_scores<D, kBM>(sv, q_s + a_off, ks);           // S = Q K^T
        wgmma_commit();
        wgmma_scores<D, kBM>(dpv, do_s + a_off, vs);         // dP = dO V^T
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sv);
        if constexpr (!kModes) {
          const bool edge = (causal && k0 + kBN - 1 > qa + off) || k0 + kBN > Sk;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            float p = ex2_approx(fmaf(sv[i], scale_log2, -lse2[(i >> 1) & 1]));
            if (edge) {
              const int qi = qa + frag_row(t, i), kj = k0 + frag_col(t, i);
              if (kj >= Sk || (causal && kj > qi + off)) p = 0.f;
            }
            sv[i] = p;
          }
          wgmma_wait<0>();
          fence_regs(dpv);
#pragma unroll
          for (int i = 0; i < 32; ++i) dpv[i] = sv[i] * (dpv[i] - delta_r[(i >> 1) & 1]);
        } else {
          const int* segk = segk_s + s * kBN;
          const float* mt = mp ? mp + (int64_t)qa * Sk + k0 : nullptr;   // the tile's mask
          uint32_t keep = 0xFFFFFFFFu;                 // bit i: element i kept by dropout
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int j = (i >> 1) & 1;
            const int qi = qa + frag_row(t, i), c = frag_col(t, i), kj = k0 + c;
            float x = sv[i] * scale;
            if (mp && qi < Sq && kj < Sk) x += __ldg(mt + frag_row(t, i) * Sk + c);
            if (has_seg && segq_r[j] != segk[c]) x = kNegInf;
            sv[i] = masked(qi, kj, Sq, Sk, causal) ? 0.f : ex2_approx((x - lse_r[j]) * kLog2e);
            if (drop && !drop_keep(dbase, qi, kj, md.thresh)) keep &= ~(1u << i);
          }
          wgmma_wait<0>();
          fence_regs(dpv);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            dpv[i] = sv[i] * (dropped(dpv, i, keep, drop, md.inv) - delta_r[(i >> 1) & 1]);
        }
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) frag_to_a(dpv, kk, a[kk]);
        fence_regs(acc);
        wgmma_fence();
        wgmma_accumulate<D>(acc, a, ks);               // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if ((t & 31) == 0) mbar_arrive(&empty[s]);
    }

    // dq = scale * acc, bf16 pairs straight from the fragment
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int qi = qa + frag_row(t, i);
      if (qi < Sq) {
        bf16* dst = dq + (((int64_t)b * Sq + qi) * Hq + h) * D + frag_col(t, i);
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
      }
    }
  }
}

// ---- dK / dV --------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr uint32_t kv = tile_bytes<D>(kBM);         // K or V
  static constexpr uint32_t q = tile_bytes<D>(kBN);          // one Q or dO tile
  static constexpr uint32_t off_k = 0, off_v = kv, off_q = 2 * kv;   // stage s: Q, then dO
  // per stage and q row: lse * log2(e), delta, seg_q, lse
  static constexpr uint32_t off_rows = off_q + kStages * 2 * q;
  static constexpr uint32_t off_bar = off_rows + kStages * 4 * kBN * 4;
  static constexpr uint32_t bytes = off_bar + (1 + 2 * kStages) * 8 + 1024;
  static_assert(bytes <= 232448, "dK/dV stages exceed shared memory");
};

template <int D, bool kModes>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, Modes md, int Sq, int Sk,
                          int Hq, int Hkv, int causal, float scale) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + L::off_bar);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kStages;
  float* rows_s = reinterpret_cast<float*>(smem + L::off_rows);

  const int n_k = (Sk + kBM - 1) / kBM;
  const Work wk = work_of<kWindow>(n_k, Hkv, gridDim.x / (n_k * Hkv));
  const int k0 = wk.tile * kBM;                          // heaviest (first) tiles first
  const int hk = wk.head, b = wk.batch;
  const int group = Hq / Hkv;
  const int off = Sk - Sq;
  const int n_qt = (Sq + kBN - 1) / kBN;
  // first q tile whose last row reaches kv row r
  auto first_tile = [&](int r) {
    const int first = r - off;
    return (causal && first > 0) ? first / kBN : 0;
  };
  const int jq0 = first_tile(k0);
  const bool has_seg = kModes && md.seg_q != nullptr;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup_idx() == 0) {              // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_map(&tm_q);
        tma_prefetch_map(&tm_do);
        mbar_arrive_expect_tx(kv_bar, 2 * L::kv);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(smem + L::off_k + c * kBM * kRowBytes, &tm_k, kv_bar, 64 * c, hk, k0, b);
          tma_load_4d(smem + L::off_v + c * kBM * kRowBytes, &tm_v, kv_bar, 64 * c, hk, k0, b);
        }
      }
      int it = 0;
      for (int hh = 0; hh < group; ++hh) {
        const int h = hk * group + hh;
        const int64_t roff = ((int64_t)b * Hq + h) * Sq;
        for (int jq = jq0; jq < n_qt; ++jq, ++it) {
          const int s = it % kStages, q0 = jq * kBN;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          if (lane == 0) {         // the tiles first: their loads take longest
            unsigned char* qs = smem + L::off_q + s * 2 * L::q;
            mbar_expect_tx(&full[s], 2 * L::q);
#pragma unroll
            for (int c = 0; c < D / 64; ++c) {
              tma_load_4d(qs + c * kBlockRows64, &tm_q, &full[s], 64 * c, h, q0, b);
              tma_load_4d(qs + L::q + c * kBlockRows64, &tm_do, &full[s], 64 * c, h, q0, b);
            }
          }
          float* rs = rows_s + s * 4 * kBN;
          for (int r = lane; r < kBN; r += 32) {
            const bool in = q0 + r < Sq;
            const float l = in ? lse[roff + q0 + r] : 0.f;
            rs[r] = l * kLog2e;
            rs[kBN + r] = in ? delta[roff + q0 + r] : 0.f;
            if constexpr (kModes) {
              rs[3 * kBN + r] = l;
              if (has_seg)
                reinterpret_cast<int*>(rs)[2 * kBN + r] =
                    in ? md.seg_q[(int64_t)b * Sq + q0 + r] : -1;
            }
          }
          mbar_arrive(&full[s]);   // every lane, after its stores
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns kv rows ka .. ka + 63
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, w = warpgroup_idx() - 1;
    const int ka = k0 + 64 * w;
    const int jq_mine = ka < Sk ? first_tile(ka) : n_qt;
    const float scale_log2 = scale * kLog2e;
    const bool drop = kModes && md.seed != nullptr;
    const uint32_t seed = drop ? (uint32_t)*md.seed : 0u;
    int segk_r[2] = {0, 0};
    if (has_seg) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = ka + frag_row(t, 2 * j);
        segk_r[j] = kj < Sk ? md.seg_k[(int64_t)b * Sk + kj] : -2;
      }
    }

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const unsigned char* k_s = smem + L::off_k;
    const unsigned char* v_s = smem + L::off_v;
    const uint32_t a_off = w * kBlockRows64;
    mbar_wait(kv_bar, 0);

    int it = 0;
    for (int hh = 0; hh < group; ++hh) {
      const int h = hk * group + hh;                     // the q-head: mask and hash
      const uint32_t dbase = drop ? drop_base(seed, b, h) : 0u;
      const float* mp = kModes && md.mask ? md.mask + b * md.mask_sb + h * md.mask_sh : nullptr;
      for (int jq = jq0; jq < n_qt; ++jq, ++it) {
        const int s = it % kStages, q0 = jq * kBN;
        mbar_wait(&full[s], (it / kStages) & 1);
        if (jq >= jq_mine) {
          const unsigned char* qs = smem + L::off_q + s * 2 * L::q;
          const unsigned char* dos = qs + L::q;
          const float* lse_s = rows_s + s * 4 * kBN;
          const float* delta_s = lse_s + kBN;
          float sv[32], dpv[32];
          wgmma_fence();
          wgmma_scores<D, kBM>(sv, k_s + a_off, qs);          // S^T = K Q^T
          wgmma_commit();
          wgmma_scores<D, kBM>(dpv, v_s + a_off, dos);        // dP^T = V dO^T
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(sv);
          // element i: kv row ka + frag_row(t, i), q column q0 + frag_col(t, i).
          // P^T first; dV's product is issued before dP^T is read, and dS^T is
          // formed while it runs.
          uint32_t keep = 0xFFFFFFFFu;                 // bit i: element i kept by dropout
          if constexpr (!kModes) {
            const bool edge = (causal && ka + 63 > q0 + off) || q0 + kBN > Sq || ka + 64 > Sk;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int c = frag_col(t, i);
              float p = ex2_approx(fmaf(sv[i], scale_log2, -lse_s[c]));
              if (edge && masked(q0 + c, ka + frag_row(t, i), Sq, Sk, causal)) p = 0.f;
              sv[i] = p;
            }
          } else {
            const int* segq = reinterpret_cast<const int*>(lse_s + 2 * kBN);
            const float* mt = mp ? mp + (int64_t)q0 * Sk + ka : nullptr;   // the tile's mask
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int c = frag_col(t, i), qi = q0 + c, kj = ka + frag_row(t, i);
              float x = sv[i] * scale;
              if (mp && qi < Sq && kj < Sk) x += __ldg(mt + c * Sk + frag_row(t, i));
              if (has_seg && segq[c] != segk_r[(i >> 1) & 1]) x = kNegInf;
              const float l = lse_s[3 * kBN + c];
              sv[i] = masked(qi, kj, Sq, Sk, causal) ? 0.f : ex2_approx((x - l) * kLog2e);
              if (drop && !drop_keep(dbase, qi, kj, md.thresh)) keep &= ~(1u << i);
            }
          }
          uint32_t a[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            a[kk][0] = pack_bf16(dropped(sv, kk * 8 + 0, keep, drop, md.inv),
                                 dropped(sv, kk * 8 + 1, keep, drop, md.inv));
            a[kk][1] = pack_bf16(dropped(sv, kk * 8 + 2, keep, drop, md.inv),
                                 dropped(sv, kk * 8 + 3, keep, drop, md.inv));
            a[kk][2] = pack_bf16(dropped(sv, kk * 8 + 4, keep, drop, md.inv),
                                 dropped(sv, kk * 8 + 5, keep, drop, md.inv));
            a[kk][3] = pack_bf16(dropped(sv, kk * 8 + 6, keep, drop, md.inv),
                                 dropped(sv, kk * 8 + 7, keep, drop, md.inv));
          }
          fence_regs(dv_acc);
          wgmma_fence();
          wgmma_accumulate<D>(dv_acc, a, dos);          // dV += P^T dO
          wgmma_commit();
          // dP^T has landed (the modes build, shorter of registers, also
          // lets dV's product finish, so `a` is free before dS^T)
          wgmma_wait<kModes ? 0 : 1>();
          fence_regs(dpv);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float dp = dropped(dpv, i, keep, drop, md.inv);
            dpv[i] = sv[i] * (dp - delta_s[frag_col(t, i)]);
          }
          uint32_t ads[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) frag_to_a(dpv, kk, ads[kk]);
          fence_regs(dk_acc);
          wgmma_fence();
          wgmma_accumulate<D>(dk_acc, ads, qs);         // dK += dS^T Q
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
        }
        if ((t & 31) == 0) mbar_arrive(&empty[s]);
      }
    }

#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int kj = ka + frag_row(t, i);
      if (kj < Sk) {
        const int64_t o = (((int64_t)b * Sk + kj) * Hkv + hk) * D + frag_col(t, i);
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

// ---- launches -------------------------------------------------------------

template <int D, bool kModes>
cudaError_t dq_as(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, const Modes& md, const Dims& d,
                  cudaStream_t s) {
  CUtensorMap tq, tdo, tk, tv;
  if (!encode_bshd(&tq, q, d.B, d.Sq, d.Hq, D, kBM) ||
      !encode_bshd(&tdo, dout, d.B, d.Sq, d.Hq, D, kBM) ||
      !encode_bshd(&tk, k, d.B, d.Sk, d.Hkv, D, kBN) ||
      !encode_bshd(&tv, v, d.B, d.Sk, d.Hkv, D, kBN))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = DqSmem<D>::bytes;
  const cudaError_t e = prepare_warp_specialized<flash_bwd_dq_sm90_kernel<D, kModes>>(
      bytes, kThreads, kRegsNeeded);
  if (e != cudaSuccess) return e;
  const dim3 grid(((d.Sq + kBM - 1) / kBM) * d.Hq * d.B);
  flash_bwd_dq_sm90_kernel<D, kModes><<<grid, kThreads, bytes, s>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<bf16*>(dq), md, d.Sq, d.Sk, d.Hq, d.Hkv,
      d.causal, scale_of<D>());
  return cudaGetLastError();
}

template <int D, bool kModes>
cudaError_t dkv_as(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, const Modes& md,
                   const Dims& d, cudaStream_t s) {
  CUtensorMap tq, tdo, tk, tv;
  if (!encode_bshd(&tq, q, d.B, d.Sq, d.Hq, D, kBN) ||
      !encode_bshd(&tdo, dout, d.B, d.Sq, d.Hq, D, kBN) ||
      !encode_bshd(&tk, k, d.B, d.Sk, d.Hkv, D, kBM) ||
      !encode_bshd(&tv, v, d.B, d.Sk, d.Hkv, D, kBM))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = DkvSmem<D>::bytes;
  const cudaError_t e = prepare_warp_specialized<flash_bwd_dkv_sm90_kernel<D, kModes>>(
      bytes, kThreads, kRegsNeeded);
  if (e != cudaSuccess) return e;
  const dim3 grid(((d.Sk + kBM - 1) / kBM) * d.Hkv * d.B);
  flash_bwd_dkv_sm90_kernel<D, kModes><<<grid, kThreads, bytes, s>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), md, d.Sq,
      d.Sk, d.Hq, d.Hkv, d.causal, scale_of<D>());
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes, with the arguments of
// flash_attention.cu's ptt_flash_bwd_dq / ptt_flash_bwd_dkv.  They take
// dtype 1 (bfloat16) and D 64 or 128 only, and return cudaErrorInvalidValue
// for anything else (or when a tensor map cannot be encoded); otherwise the
// cudaError_t of the launch (0 = success).
extern "C" int ptt_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, const void* mask, int64_t mask_sb,
                                     int64_t mask_sh, const void* seg_q, const void* seg_k,
                                     const void* seed, uint32_t thresh, float inv, int B, int Sq,
                                     int Sk, int Hq, int Hkv, int D, int causal, int dtype,
                                     void* stream) {
  const Dims d{B, Sq, Sk, Hq, Hkv, D, causal};
  const Modes md = make_modes(mask, mask_sb, mask_sh, seg_q, seg_k, seed, thresh, inv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_SM90_DISPATCH(dq_as, q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), dq, md, d, s);
}

extern "C" int ptt_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, const void* mask, int64_t mask_sb,
                                      int64_t mask_sh, const void* seg_q, const void* seg_k,
                                      const void* seed, uint32_t thresh, float inv, int B,
                                      int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                                      int dtype, void* stream) {
  const Dims d{B, Sq, Sk, Hq, Hkv, D, causal};
  const Modes md = make_modes(mask, mask_sb, mask_sh, seg_q, seg_k, seed, thresh, inv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_SM90_DISPATCH(dkv_as, q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), dk, dv, md, d, s);
}
