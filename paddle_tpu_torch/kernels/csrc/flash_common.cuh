// What the flash-attention kernels share (flash_attention.cu and
// flash_attention_bwd_sm90.cu): the modes of one launch, the dropout hash
// and the tile bounds.  See flash_attention.cu's header for the formulas.
#pragma once

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

}  // namespace ptt_flash
