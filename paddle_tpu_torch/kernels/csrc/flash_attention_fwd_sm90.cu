// Flash-attention forward for Hopper (sm_90a), bf16 at head dims 64 and
// 128: out and lse on wgmma, fed by a TMA ring, warp-specialised.
//
// Replaces the Pallas TPU kernel of paddle_tpu/kernels/flash_attention.py:
//   - _fa_fwd_kernel  (launched by _fwd_call)  -> flash_fwd_sm90_kernel
// for bf16 inputs at d 64 and 128, in every mode (causal, GQA, sq != sk, any
// lengths, additive mask, segment ids, dropout).  fp32, and bf16 at d 96 and
// 256, stay on the kernel of flash_attention.cu (kernels/flash_attention.py:
// _route).  It computes what the plain version _reference_attention_lse
// computes:
//
//   s = scale q k^T (+ mask; -1e30 past the causal diagonal and between
//   segments),  p = exp(s - max),  l = sum(p)   (the undropped sum)
//   out = (keep(p) / (1 - rate)) v / l,  lse = max + log(l)
//
// with p rounded to bf16 before its product, as the mma route does.  A row
// whose every key is at -1e30 averages the keys it visits: the kv tiles
// kv_tiles<64, 64> gives its 64-row group, as on the mma route, which the
// backward's lse expects; keys past Sk are never counted (-inf, p = 0).
// Layouts as in flash_attention.cu: q, k, v, out [b, s, h, d] (bf16); lse
// fp32 [b, hq, sq].
//
// What bounds it on this card: operations.  At the training shape (b 4,
// s 2048, 32 heads, d 128, causal) it is 2 matmuls of b*h*s^2*d/2 = 68.7
// GFLOP (0.139 ms at 989 TFLOP/s); q, k, v and out are 268 MB (0.080 ms at
// 3.35 TB/s).
//
// What the design does about it:
// - One CTA per (128 q rows, q-head, batch), of three warpgroups.
//   Warpgroup 0 is the producer: one warp loads Q once, then K and V tiles
//   of 64 rows into a ring of kStages shared-memory stages guarded by
//   full/empty mbarriers (with segments, also the tile's key ids);
//   setmaxnreg lowers it to kProducerRegs.  Warpgroups 1 and 2 are
//   consumers, each owning 64 of the CTA's rows, at kConsumerRegs.
// - S = Q K^T is wgmma with both operands K-major in shared memory.  (Q
//   held in registers as the A operand, so that S would read only K from
//   shared memory, was tried: at d 64 ptxas packed P into the registers
//   that held Q, and the next tile's S read P as Q.)  S stays in fp32
//   registers and the online softmax runs there: the row max and sum over
//   the quad of threads that owns a row (__shfl_xor_sync; the sum only at
//   the end, as each thread's partial sum is rescaled like the
//   accumulator), one FFMA and one ex2.approx per element, the O
//   accumulator rescaled in registers.  P is packed
//   pairwise to bf16 as the A operand of O += P V (V read MN-major, tnsp
//   1).  No score tile touches shared memory.
// - The grid starts the heaviest tiles of kWindow (head, batch) pairs
//   first (work_of).  A consumer skips the kv tiles its own rows do not
//   need, and only tiles that cross the diagonal or a sequence end are
//   masked element by element.
// - The modes build (kModes) applies mask, segments and dropout to each
//   score, its (row, column) from the fragment layout.  The tile's mask
//   entries are loaded into registers before its S product is issued, so
//   their latency hides under the product (the forward holds one
//   accumulator, O, so it has the registers).  Dropout hashes each
//   element's global (row, column) with its q-head's index (drop_keep):
//   the plain version's keep-mask, bit for bit.
// - Finalisation: l = max(l, 1e-30), out = acc / l stored as bf16 pairs
//   straight from the fragment, lse = max + log(l) (natural log).  Rows
//   past Sq are not stored.  Each output is written by one CTA after a sum
//   in a fixed order: two runs give the same bits.
// - TMA zero-fills rows past a sequence end (4-D tensor maps over
//   [b, s, h, d]: no tile crosses into the next batch row).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using namespace ptt_flash;
using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;          // producer warpgroup + 2 consumer warpgroups
constexpr int kBM = 128;               // the CTA's q rows, 64 a consumer
constexpr int kBN = 64;                // rows of each K and V tile
constexpr int kStages = 4;
constexpr int kWindow = 16;            // (head, batch) pairs the grid walks together
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kRegsNeeded = kProducerRegs * 128 + kConsumerRegs * 256;   // setmaxnreg
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;      // masked: p = 1 where a row has no live key
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kRowBytes = 128;    // one row of a 64-column block
constexpr uint32_t kBlockRows64 = kBN * kRowBytes;   // a 64-row, 64-column block: 8 KB

// Shared memory: Q (kBM rows), then per stage a K and a V tile (kBN rows),
// each D / 64 column blocks of 128-byte rows (sm90.cuh); the stages' key
// segment ids; the barriers.
template <int D>
struct FwdSmem {
  static constexpr uint32_t q = kBM * D * 2;
  static constexpr uint32_t kv = kBN * D * 2;                // one K or V tile
  static constexpr uint32_t off_q = 0, off_k = q;            // stage s: K, then V
  static constexpr uint32_t off_segk = off_k + kStages * 2 * kv;   // int [kStages][kBN]
  static constexpr uint32_t off_bar = off_segk + kStages * kBN * 4;
  static constexpr uint32_t bytes = off_bar + (1 + 2 * kStages) * 8 + 1024;   // + alignment
  static_assert(bytes <= 232448, "forward stages exceed shared memory");
};

template <int D, bool kModes>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                      float* __restrict__ lse, Modes md, int Sq, int Sk, int Hq, int Hkv,
                      int causal, float scale) {
  using L = FwdSmem<D>;
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
        mbar_arrive_expect_tx(q_bar, L::q);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(smem + L::off_q + c * kBM * kRowBytes, &tm_q, q_bar, 64 * c, h, q0, b);
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
        mbar_arrive(&full[s]);     // every lane, after its stores
      }
    }
  } else {
    // ---- consumers: warpgroup w owns rows qa .. qa + 63
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, w = warpgroup_idx() - 1;
    const int qa = q0 + 64 * w;
    const int n_mine = qa < Sq ? kv_tiles<64, kBN>(qa, Sq, Sk, causal) : 0;
    const int off = Sk - Sq;
    // the exponent's factor: scores are raw q k^T in the plain build, and
    // scaled (with the modes applied) in the modes build
    const float c2 = kModes ? kLog2e : scale * kLog2e;
    const float* mp = kModes && md.mask ? md.mask + b * md.mask_sb + h * md.mask_sh : nullptr;
    const bool drop = kModes && md.seed != nullptr;
    const uint32_t dbase = drop ? drop_base((uint32_t)*md.seed, b, h) : 0u;

    // this thread's two rows: frag_row(t, 0) and + 8
    int segq_r[2] = {0, 0};
    if (has_seg) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = qa + frag_row(t, 2 * j);
        segq_r[j] = qi < Sq ? md.seg_q[(int64_t)b * Sq + qi] : -1;
      }
    }
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};   // l_r: this thread's part
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const unsigned char* q_s = smem + L::off_q + w * kBlockRows64;   // the consumer's rows
    mbar_wait(q_bar, 0);

    for (int it = 0; it < n_kt; ++it) {
      const int s = it % kStages, k0 = it * kBN;
      mbar_wait(&full[s], (it / kStages) & 1);
      if (it < n_mine) {
        const unsigned char* ks = smem + L::off_k + s * 2 * L::kv;
        const unsigned char* vs = ks + L::kv;
        float mk[32];                                // the tile's mask entries
        if (kModes && mp) {
          const float* mt = mp + (int64_t)qa * Sk + k0;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = frag_row(t, i), c = frag_col(t, i);
            mk[i] = (qa + r < Sq && k0 + c < Sk) ? __ldg(mt + (int64_t)r * Sk + c) : 0.f;
          }
        }
        float sv[32];
        wgmma_fence();
        wgmma_scores<D, kBM>(sv, q_s, ks);           // S = Q K^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sv);
        if constexpr (!kModes) {
          const bool edge = (causal && k0 + kBN - 1 > qa + off) || k0 + kBN > Sk;
          if (edge) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int qi = qa + frag_row(t, i), kj = k0 + frag_col(t, i);
              if (kj >= Sk || (causal && kj > qi + off)) sv[i] = -CUDART_INF_F;
            }
          }
        } else {
          const int* segk = segk_s + s * kBN;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int qi = qa + frag_row(t, i), c = frag_col(t, i), kj = k0 + c;
            float x = sv[i] * scale;
            if (mp) x += mk[i];
            if (has_seg && segq_r[(i >> 1) & 1] != segk[c]) x = kNegInf;
            if (kj >= Sk) x = -CUDART_INF_F;              // no key: never counted
            else if (causal && kj > qi + off) x = kNegInf;
            sv[i] = x;
          }
        }
        // online softmax: the rows' new max over the quad, the rescale
        float mx[2] = {m_r[0], m_r[1]}, alpha[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sv[i]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
          alpha[j] = ex2_approx((m_r[j] - mx[j]) * c2);
          m_r[j] = mx[j];
          mc[j] = mx[j] * c2;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = (i >> 1) & 1;
          // the modes build subtracts first: a row at -1e30 must give
          // exactly p = 1, which an FFMA of two 1e30 terms does not
          float p = kModes ? ex2_approx((sv[i] - m_r[j]) * kLog2e)
                           : ex2_approx(fmaf(sv[i], c2, -mc[j]));
          rs[j] += p;                                  // l keeps the undropped sum
          if (drop) {
            const int qi = qa + frag_row(t, i), kj = k0 + frag_col(t, i);
            p = drop_keep(dbase, qi, kj, md.thresh) ? p * md.inv : 0.f;
          }
          sv[i] = p;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) l_r[j] = l_r[j] * alpha[j] + rs[j];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) frag_to_a(sv, kk, pa[kk]);
        fence_regs(acc);
        wgmma_fence();
        wgmma_accumulate<D>(acc, pa, vs);            // O += P V
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if ((t & 31) == 0) mbar_arrive(&empty[s]);
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
      const int qi = qa + frag_row(t, i);
      if (qi < Sq) {
        const float il = inv_l[(i >> 1) & 1];
        bf16* dst = out + (((int64_t)b * Sq + qi) * Hq + h) * D + frag_col(t, i);
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[i] * il, acc[i + 1] * il);
      }
    }
    if ((t & 3) == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = qa + frag_row(t, 2 * j);
        if (qi < Sq)
          lse[((int64_t)b * Hq + h) * Sq + qi] = m_r[j] * (kModes ? 1.f : scale) + log_l[j];
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

template <int D, bool kModes>
cudaError_t fwd_as(const void* q, const void* k, const void* v, void* out, float* lse,
                   const Modes& md, const Dims& d, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(&tq, q, d.B, d.Sq, d.Hq, D, kBM) ||
      !encode_bshd(&tk, k, d.B, d.Sk, d.Hkv, D, kBN) ||
      !encode_bshd(&tv, v, d.B, d.Sk, d.Hkv, D, kBN))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = FwdSmem<D>::bytes;
  const cudaError_t e = prepare_warp_specialized<flash_fwd_sm90_kernel<D, kModes>>(
      bytes, kThreads, kRegsNeeded);
  if (e != cudaSuccess) return e;
  const dim3 grid(((d.Sq + kBM - 1) / kBM) * d.Hq * d.B);
  flash_fwd_sm90_kernel<D, kModes><<<grid, kThreads, bytes, s>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, md, d.Sq, d.Sk, d.Hq, d.Hkv, d.causal,
      scale_of<D>());
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes, with the arguments of
// flash_attention.cu's ptt_flash_fwd.  It takes dtype 1 (bfloat16) and D
// 64 or 128 only, and returns cudaErrorInvalidValue for anything else (or
// when a tensor map cannot be encoded); otherwise the cudaError_t of the
// launch (0 = success).
extern "C" int ptt_flash_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                                  void* lse, const void* mask, int64_t mask_sb,
                                  int64_t mask_sh, const void* seg_q, const void* seg_k,
                                  const void* seed, uint32_t thresh, float inv, int B, int Sq,
                                  int Sk, int Hq, int Hkv, int D, int causal, int dtype,
                                  void* stream) {
  const Dims d{B, Sq, Sk, Hq, Hkv, D, causal};
  const Modes md = make_modes(mask, mask_sb, mask_sh, seg_q, seg_k, seed, thresh, inv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_SM90_DISPATCH(fwd_as, q, k, v, out, static_cast<float*>(lse), md, d, s);
}
