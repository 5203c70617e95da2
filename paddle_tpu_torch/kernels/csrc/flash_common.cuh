// What the flash-attention kernels share (flash_attention.cu,
// flash_attention_fwd_sm90.cu and flash_attention_bwd_sm90.cu): the modes of
// one launch, the dropout hash, the tile bounds, the sm90 kernels' grid
// order and the entry points' host-side helpers.  See flash_attention.cu's
// header for the formulas.
#pragma once

#include <math.h>
#include <stdint.h>

namespace ptt_flash {

// The modes of one launch.
struct Modes {
  const float* mask;        // fp32 [b|1, hq|1, sq, sk] or null
  int64_t mask_sb, mask_sh; // batch and head strides (0 where it broadcasts)
  const int* seg_q;         // int32 [b, sq] or null (then seg_k too)
  const int* seg_k;         // int32 [b, sk]
  const int* seed;          // int32 [1] or null: no dropout
  uint32_t thresh;          // keep where hash >= thresh
  float inv;                // 1 / (1 - rate)
};

// The reference's _drop_mix: hash of (row, col) and the per-CTA base
// seed * C ^ b * C ^ h * C.
__device__ __forceinline__ uint32_t drop_base(uint32_t seed, uint32_t b, uint32_t h) {
  return (seed * 2246822519u) ^ (b * 3266489917u) ^ (h * 668265263u);
}

__device__ __forceinline__ bool drop_keep(uint32_t base, uint32_t row, uint32_t col,
                                          uint32_t thresh) {
  uint32_t z = (row * 2654435761u) ^ (col * 1013904223u) ^ base;
  z ^= z >> 16;
  z *= 2246822519u;
  z ^= z >> 13;
  z *= 3266489917u;
  z ^= z >> 16;
  return z >= thresh;
}

// past a sequence end, or past the causal diagonal: p = 0 in the backward
__device__ __forceinline__ bool masked(int qi, int kj, int Sq, int Sk, int causal) {
  return qi >= Sq || kj >= Sk || (causal && kj > qi + (Sk - Sq));
}

// number of BN-row kv tiles a BM-row q tile starting at q0 needs (reference: _needed)
template <int BM, int BN>
__device__ __forceinline__ int kv_tiles(int q0, int Sq, int Sk, int causal) {
  const int n = (Sk + BN - 1) / BN;
  if (!causal) return n;
  const int last = min(q0 + BM - 1, Sq - 1) + (Sk - Sq);
  return min(n, last / BN + 1);
}

// The CTA's tile (0 the heaviest), head and batch, from a 1-D grid of
// n_tiles x heads x batches.  CTAs start in launch order, so the grid walks
// the (head, batch) pairs in windows of W: inside a window every pair's
// heaviest tile first, then every pair's next one, and so on.  A window's
// pairs share their streamed operands in L2, and the CTAs that start last
// are light, so the card's last wave is short.
struct Work {
  int tile, head, batch;
};

template <int W>
__device__ __forceinline__ Work work_of(int n_tiles, int heads, int batches) {
  const int pairs = heads * batches, per_window = n_tiles * W;
  const int win = blockIdx.x / per_window, r = blockIdx.x % per_window;
  const int in_window = min(W, pairs - win * W);
  const int pair = win * W + r % in_window;
  return {r / in_window, pair % heads, pair / heads};
}

// ---- host side of the C entry points --------------------------------------

struct Dims {
  int B, Sq, Sk, Hq, Hkv, D, causal;
};

// each kernel is built twice: without the modes' code (causal/full
// attention: the training step) and with it
inline bool any_mode(const Modes& md) { return md.mask || md.seg_q || md.seed; }

inline Modes make_modes(const void* mask, int64_t mask_sb, int64_t mask_sh, const void* seg_q,
                        const void* seg_k, const void* seed, uint32_t thresh, float inv) {
  return Modes{static_cast<const float*>(mask), mask_sb, mask_sh,
               static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
               static_cast<const int*>(seed), thresh, inv};
}

template <int D>
float scale_of() { return static_cast<float>(1.0 / sqrt((double)D)); }

}  // namespace ptt_flash

// The sm90 entry points: calls FN<D, kModes>(args...) for bf16 (dtype 1) at
// D 64 or 128, the modes build when the launch has a mode; anything else is
// refused.  Expects `dtype`, `md` (Modes) and `d` (Dims) in scope.
#define PTT_SM90_DISPATCH(FN, ...)                                                     \
  do {                                                                                 \
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);                    \
    const bool m = any_mode(md);                                                       \
    if (d.D == 64) return static_cast<int>(m ? FN<64, true>(__VA_ARGS__)               \
                                             : FN<64, false>(__VA_ARGS__));            \
    if (d.D == 128) return static_cast<int>(m ? FN<128, true>(__VA_ARGS__)             \
                                              : FN<128, false>(__VA_ARGS__));          \
    return static_cast<int>(cudaErrorInvalidValue);                                    \
  } while (0)
