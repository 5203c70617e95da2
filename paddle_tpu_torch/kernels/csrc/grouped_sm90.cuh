// The row-gather pieces that the grouped matmuls on wgmma share
// (grouped_matmul_sm90.cu's gmm, tgmm_sm90.cu's tgmm).  In both, a producer
// warpgroup's 128 threads copy gathered bf16 rows global -> shared with
// cp.async, 16 bytes a chunk, straight into TMA's 128-byte swizzle (chunk c
// of row r at c ^ (r % 8), sm90.cuh), and later scale their own chunks in
// place by a per-row bf16 factor; a tile whose rows all read one all-zero
// row (the callers' zero sentinel) adds nothing.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace gsm90 {

using bf16 = __nv_bfloat16;

constexpr uint32_t kRowBytes = 128;     // one swizzled row: 64 bf16
constexpr int kProducerThreads = 128;   // the producer warpgroup

// byte offset of row r's 16-byte chunk c in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

// 8 bf16 (16 bytes) times a bf16 scale in four bf16x2 multiplies, each
// product rounded once to bf16: the plain versions' bf16 `x * scale`
__device__ __forceinline__ uint32_t mul2(uint32_t x, __nv_bfloat162 s) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  v = __hmul2(v, s);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint4 scale8(uint4 v, bf16 s) {
  const __nv_bfloat162 s2 = __bfloat162bfloat162(s);
  return make_uint4(mul2(v.x, s2), mul2(v.y, s2), mul2(v.z, s2), mul2(v.w, s2));
}

__device__ __forceinline__ bool zero8(uint4 v) {
  // +0 and -0 in each bf16 half
  return ((v.x | v.y | v.z | v.w) & 0x7FFF7FFFu) == 0u;
}

}  // namespace gsm90
