// The block-primitive library's kernel generators for Hopper (sm_90a):
// elementwise, reduce and matmul, each compiled around a caller's function.
//
// Replaces the three Pallas generators of paddle_tpu/kernels/primitives.py:
// elementwise_kernel (:71, pallas_call :89), reduce_kernel (:102, :117) and
// matmul_kernel (:130, :165).  Pallas traces a Python function into each
// kernel body.  Here the caller's function is the body of a __device__ float
// function, which paddle_tpu_torch/kernels/primitives.py writes into a
// header that nvcc pre-includes (-include) when it compiles this file.  The
// header defines exactly one of
//
//   PTT_ELEMENTWISE, PTT_ELEMENTWISE_ARITY n and
//       float ptt_elementwise_fn(float a, float b, ...)   (n arguments)
//   PTT_REDUCE and float ptt_reduce_fn(float a, float b)  (a: the running
//       value, b: the next column)
//   PTT_MATMUL and float ptt_epilogue_fn(float a)          (a: the fp32 sum)
//
// and only that generator is compiled.  Compiled alone, with no header, the
// file builds all three around default functors (identity, a + b,
// identity), so it builds like every other source under csrc/.
//
// What bounds each kernel on this card, at llama2_7b widths (B*T = 8192
// rows, bf16; 3.35 TB/s, 989 TFLOP/s):
// - elementwise silu(gate) * up over [8192, 11008]: bytes, two inputs read
//   and one output written, 541.1 MB = 0.1615 ms;
// - reduce max over the logits [8192, 32000]: bytes, 524.3 MB = 0.1565 ms;
//   the reference's contract is a left fold, so each row is also one chain
//   of 32000 dependent steps (~0.2-0.3 ms at 10-20 cycles a step);
// - matmul, the gate projection [8192, 4096] @ [4096, 11008]: operations,
//   738.7 GFLOP = 0.747 ms.
//
// What the design does about it (simple first, fast later):
// - elementwise, two routes (kernels/primitives.py:_elementwise_route):
//   "vec16" when every input and the output start on 16 bytes: each thread
//   moves whole vectors of 8 elements (one 16-byte load of bf16/fp16, two
//   of fp32), kVecUnroll vectors of every input in flight per pass (all
//   loads issued before any arithmetic), the dtype switch taken once per
//   vector; the ragged tail of fewer than 8 elements is masked in the
//   kernel (no padded copy, unlike the reference's :86-88).  "scalar"
//   otherwise: a grid-stride pass over the flat elements, 4 elements a
//   thread per pass in flight, element loads.  On both, each input carries
//   its own dtype code, so one build serves every dtype mix of one functor;
//   every value is widened to float, the functor runs in fp32, the result
//   is rounded once (nearest even) to the first input's dtype: the two
//   routes give the same bits.
// - reduce: the reference's left fold, acc = x[:, 0], then acc =
//   round(fn(acc, x[:, i])) for i = 1 .. cols - 1, each step in fp32 and
//   rounded to x's dtype (nearest even), so the result is bit for bit the
//   plain loop's.  No tree: a tree changes the bits (by 1.25 on a bf16 row
//   sum of 300 N(0, 1) values), and the functor is the caller's opaque
//   body, so nothing may be reassociated.  One lane owns a row and folds
//   its columns in order; a warp owns 32 rows and keeps a ring of 8 tiles
//   of [32 rows, 128 bytes] in shared memory, 7 in flight (28 KB a warp):
//   tiles go global -> shared by cp.async, 16 bytes a chunk, where the
//   rows are 16-byte multiples from a 16-byte aligned x (the "vec16" route
//   of kernels/primitives.py:_reduce_route), else element by element
//   ("scalar").  The raw x-dtype tile stays in shared memory, swizzled
//   (chunk c of row r at c ^ (r % 8)), and each lane reads its row 16
//   bytes at a time (8 bf16/fp16 or 4 fp32 steps a load, 4 wavefronts a
//   warp); the widening happens in registers, off the accumulator's chain.
//   What remains is the chain itself: cols dependent steps (fn, round,
//   widen) a row, which chip_smoke.py times alone as chain_floor_ms.
// - matmul, three routes (kernels/primitives.py:_matmul_route):
//   "sm90", bf16 / fp16 with k > 0, k and n multiples of 8 and both operands
//   16-byte aligned (every matmul of the library's path): wgmma over a TMA
//   ring, warp-specialised, wide_sm90.cuh's tile body.  One producer thread
//   issues TMA for the x tile [128 x 64] and the w tile [64 x BN] (BN 256
//   where n > 128, else 128; w [k, n] read MN-major, tnsp-b 1) of each
//   k-step into a 4-stage ring; two consumer warpgroups of 64 rows run
//   m64nBNk16 at setmaxnreg 232 (the producer at 40), one stage's products
//   in flight; the epilogue runs on the fp32 accumulators in registers
//   (the functor, then the one cast), stages the tile in the ring and
//   stores it 16 bytes at a time.  Ragged m, n and k load zeros by TMA's
//   out-of-bounds fill and are never stored.  CTAs walk the tiles in groups
//   of 16 row tiles so the ones that run together share x rows and w
//   columns through L2.
//   "mma", every other bf16 / fp16 case: WMMA 16x16x16 fragments (mma.sync)
//   with fp32 accumulators, 128 x 128 output tiles, 8 warps of 64 x 32, k
//   steps of 32 staged through shared memory with the next step's loads in
//   flight in registers (the pattern of csrc/weight_only.cu).
//   "fma", fp32: register-tiled FMA, 64 x 64 tiles, 4 x 4 a thread, not
//   TF32.  On "mma" and "fma" rows past m, columns past n and k past its
//   end read as zeros and are never stored (no padded copy, unlike the
//   reference's :141-143); 16-byte loads only when k and n are multiples of
//   8 (4 in fp32) and both operands are 16-byte aligned.
// Later work (not here): a persistent grid with the epilogue overlapping
// the next tile's loads for matmul.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <utility>

#include "sm90.cuh"
#include "wide_sm90.cuh"

#if !defined(PTT_ELEMENTWISE) && !defined(PTT_REDUCE) && !defined(PTT_MATMUL)
#define PTT_ELEMENTWISE 1
#define PTT_ELEMENTWISE_ARITY 1
__device__ __forceinline__ float ptt_elementwise_fn(float a) { return a; }
#define PTT_REDUCE 1
__device__ __forceinline__ float ptt_reduce_fn(float a, float b) { return a + b; }
#define PTT_MATMUL 1
__device__ __forceinline__ float ptt_epilogue_fn(float a) { return a; }
#endif

namespace {

// dtype codes, as the Python wrapper passes them: 0 fp32, 1 bf16, 2 fp16

__device__ __forceinline__ float load_float(const void* p, int code, int64_t i) {
  if (code == 0) return static_cast<const float*>(p)[i];
  if (code == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

// out[i] = v in the dtype `code`, rounded to nearest even as torch's .to() does.
__device__ __forceinline__ void store_float(void* out, int code, int64_t i, float v) {
  if (code == 0)
    static_cast<float*>(out)[i] = v;
  else if (code == 1)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(out)[i] = __float2half_rn(v);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// --------------------------------------------------------- elementwise ---

#ifdef PTT_ELEMENTWISE
namespace ew {

constexpr int kArity = PTT_ELEMENTWISE_ARITY;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // elements a thread has in flight per pass

struct Inputs {
  const void* p[kArity];
  int code[kArity];
};

template <size_t... I>
__device__ __forceinline__ float call(const float (&v)[kArity], std::index_sequence<I...>) {
  return ptt_elementwise_fn(v[I]...);
}

__global__ void __launch_bounds__(kThreads)
elementwise_kernel(Inputs in, void* __restrict__ out, int out_code, int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
       base < n; base += step) {
    float v[kUnroll][kArity];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
#pragma unroll
      for (int j = 0; j < kArity; ++j) v[u][j] = i < n ? load_float(in.p[j], in.code[j], i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < n) store_float(out, out_code, i, call(v[u], std::make_index_sequence<kArity>{}));
    }
  }
}

// ---- the "vec16" route: 8 elements a vector
constexpr int kVec = 8;
// vectors of each input a thread has in flight per pass (the raw words of
// kVecUnroll x kArity vectors stay in registers until the arithmetic)
constexpr int kVecUnroll = kArity <= 2 ? 4 : kArity <= 4 ? 2 : 1;

// vector v (elements 8v .. 8v + 7) of an input as it lies in memory: one
// 16-byte word (bf16 / fp16) or two (fp32)
struct Raw8 {
  uint4 lo, hi;
};

__device__ __forceinline__ Raw8 load_raw8(const void* p, int code, int64_t v) {
  Raw8 r;
  if (code == 0) {
    const uint4* q = static_cast<const uint4*>(p) + 2 * v;
    r.lo = q[0];
    r.hi = q[1];
  } else {
    r.lo = static_cast<const uint4*>(p)[v];
    r.hi = make_uint4(0u, 0u, 0u, 0u);
  }
  return r;
}

// the 8 values of a raw vector as floats (exact)
__device__ __forceinline__ void widen8(const Raw8& r, int code, float (&f)[kVec]) {
  const uint32_t w[4] = {r.lo.x, r.lo.y, r.lo.z, r.lo.w};
  if (code == 0) {
    const uint32_t x[8] = {r.lo.x, r.lo.y, r.lo.z, r.lo.w, r.hi.x, r.hi.y, r.hi.z, r.hi.w};
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = __uint_as_float(x[e]);
  } else if (code == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(w[e] << 16);
      f[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&w[e]));
      f[2 * e] = h.x;
      f[2 * e + 1] = h.y;
    }
  }
}

// 8 results rounded to the dtype `code` (nearest even) and stored as vector v
__device__ __forceinline__ void store8(void* out, int code, int64_t v, const float (&f)[kVec]) {
  if (code == 0) {
    uint4* q = static_cast<uint4*>(out) + 2 * v;
    q[0] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
    q[1] = make_uint4(__float_as_uint(f[4]), __float_as_uint(f[5]), __float_as_uint(f[6]),
                      __float_as_uint(f[7]));
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (code == 1) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&b);
    } else {
      const __half2 hh = __floats2half2_rn(f[2 * e], f[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&hh);
    }
  }
  static_cast<uint4*>(out)[v] = make_uint4(w[0], w[1], w[2], w[3]);
}

// every input and out start on 16 bytes; n / 8 whole vectors, then the
// n % 8 elements of the tail element by element (block 0)
__global__ void __launch_bounds__(kThreads)
elementwise_vec16_kernel(Inputs in, void* __restrict__ out, int out_code, int64_t n) {
  const int64_t nv = n / kVec;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kVecUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kVecUnroll + threadIdx.x;
       base < nv; base += step) {
    Raw8 raw[kVecUnroll][kArity];
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      const int64_t v = base + u * kThreads;
#pragma unroll
      for (int j = 0; j < kArity; ++j)
        if (v < nv) raw[u][j] = load_raw8(in.p[j], in.code[j], v);
    }
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      const int64_t v = base + u * kThreads;
      if (v < nv) {
        float x[kArity][kVec], y[kVec];
#pragma unroll
        for (int j = 0; j < kArity; ++j) widen8(raw[u][j], in.code[j], x[j]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          float a[kArity];
#pragma unroll
          for (int j = 0; j < kArity; ++j) a[j] = x[j][e];
          y[e] = call(a, std::make_index_sequence<kArity>{});
        }
        store8(out, out_code, v, y);
      }
    }
  }
  const int64_t i = nv * kVec + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    float a[kArity];
#pragma unroll
    for (int j = 0; j < kArity; ++j) a[j] = load_float(in.p[j], in.code[j], i);
    store_float(out, out_code, i, call(a, std::make_index_sequence<kArity>{}));
  }
}

}  // namespace ew

// ptt_elementwise: out[i] = cast(fn(float(in_0[i]), ..., float(in_{arity-1}[i])))
// over n flat elements; ptrs / codes are host arrays of `arity` input
// pointers and dtype codes (arity must be the header's); out takes codes[0].
// vec 1 takes the "vec16" route (every pointer 16-byte aligned, else
// cudaErrorInvalidValue), 0 the "scalar" one.  Returns the launch's
// cudaError_t.
extern "C" int ptt_elementwise(const uint64_t* ptrs, const int* codes, int arity, void* out,
                               int64_t n, int vec, void* stream) {
  if (arity != ew::kArity || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ew::Inputs in;
  bool all16 = aligned16(out);
  for (int j = 0; j < ew::kArity; ++j) {
    if (codes[j] < 0 || codes[j] > 2) return static_cast<int>(cudaErrorInvalidValue);
    in.p[j] = reinterpret_cast<const void*>(ptrs[j]);
    in.code[j] = codes[j];
    all16 = all16 && aligned16(in.p[j]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t per_block = static_cast<int64_t>(ew::kThreads) *
                            (vec ? ew::kVecUnroll * ew::kVec : ew::kUnroll);
  const int64_t blocks = std::max<int64_t>((n + per_block - 1) / per_block, 1);
  const int grid = static_cast<int>(blocks < 132 * 8 ? blocks : 132 * 8);
  if (vec) {
    if (!all16) return static_cast<int>(cudaErrorInvalidValue);
    ew::elementwise_vec16_kernel<<<grid, ew::kThreads, 0, s>>>(in, out, codes[0], n);
  } else {
    ew::elementwise_kernel<<<grid, ew::kThreads, 0, s>>>(in, out, codes[0], n);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // PTT_ELEMENTWISE

// -------------------------------------------------------------- reduce ---

#ifdef PTT_REDUCE
namespace rd {

constexpr int kRows = 32;          // rows a block (one warp; one row a lane)
constexpr int kTileBytes = 128;    // bytes of each row in a staged tile
constexpr int kTile = kRows * kTileBytes;   // 4 KB
constexpr int kStages = 8;         // tiles of a warp's ring (7 in flight)

template <typename T>
__device__ __forceinline__ float widen(T v);
template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float widen<__half>(__half v) { return __half2float(v); }

// v rounded to T (nearest even) and widened back: one step of the fold.
// The packed conversion (cvt.rn.bf16x2 / f16x2.f32: one ALU op) rounds as
// the scalar cvt.rn.bf16 / f16.f32 does, which runs on the conversion unit
// at about twice the latency; on the fold's chain that is most of a step.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __low2float(__floats2bfloat162_rn(v, v));
}
template <>
__device__ __forceinline__ float round_to<__half>(float v) {
  return __low2float(__floats2half2_rn(v, v));
}

// byte offset of row r's 16-byte chunk c in a tile: chunk c of a 128-byte
// row stored at c ^ (r % 8), so the 32 lanes reading chunk c of their own
// rows cover every bank once per 8 lanes (4 wavefronts, the least for 512
// bytes)
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * kTileBytes + ((c ^ (r & 7)) << 4);
}

template <typename T>
__device__ __forceinline__ T elem(const unsigned char* tile, int r, int j) {
  constexpr int kPer = 16 / sizeof(T);
  return *reinterpret_cast<const T*>(tile + chunk_at(r, j / kPer) + (j % kPer) * sizeof(T));
}

// VEC: rows of cols * sizeof(T) bytes, a multiple of 16, from a 16-byte
// aligned x: tiles go global -> shared by cp.async, 16 bytes a chunk (lane l
// copies chunk l % 8 of rows l / 8 + 4 i: 4 rows x 128 contiguous bytes an
// instruction).  Otherwise element by element through registers.  Chunks
// and elements past the rows or the columns are zeros (never folded).
template <typename T, bool VEC>
__device__ __forceinline__ void stage_tile(unsigned char* dst, const T* __restrict__ x, int r0,
                                           int nr, int c0, int cols, int lane) {
  constexpr int kPerTile = kTileBytes / sizeof(T), kPer = 16 / sizeof(T);
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < kTile / 16 / 32; ++i) {
      const int r = (lane >> 3) + 4 * i, c = lane & 7, col = c0 + c * kPer;
      const bool ok = r < nr && col < cols;
      const T* g = x + static_cast<int64_t>(r0 + (ok ? r : 0)) * cols + (ok ? col : 0);
      sm90::cp_async16(dst + chunk_at(r, c), g, ok ? 16u : 0u);
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = lane; j < kPerTile; j += 32) {
        const int col = c0 + j;
        const T v = (r < nr && col < cols) ? x[static_cast<int64_t>(r0 + r) * cols + col]
                                           : T(0.f);
        *reinterpret_cast<T*>(dst + chunk_at(r, j / kPer) + (j % kPer) * sizeof(T)) = v;
      }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(32)
reduce_kernel(const T* __restrict__ x, void* __restrict__ out, int out_code, int rows,
              int cols) {
  constexpr int kPerTile = kTileBytes / sizeof(T), kPer = 16 / sizeof(T);
  __shared__ __align__(128) unsigned char ring[kStages][kTile];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, rows - r0);
  const int nt = (cols + kPerTile - 1) / kPerTile;

#pragma unroll 1
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) stage_tile<T, VEC>(ring[t], x, r0, nr, t * kPerTile, cols, lane);
    sm90::cp_async_commit();
  }
  float acc = 0.f;
#pragma unroll 1
  for (int t = 0; t < nt; ++t) {
    const int ahead = t + kStages - 1;
    if (ahead < nt) stage_tile<T, VEC>(ring[ahead % kStages], x, r0, nr, ahead * kPerTile, cols,
                                       lane);
    sm90::cp_async_commit();
    sm90::cp_async_wait<kStages - 1>();   // this lane's copies of tile t
    __syncwarp();                         // and every lane's
    const unsigned char* tile = ring[t % kStages];
    const int cn = min(kPerTile, cols - t * kPerTile);
    if (t > 0 && cn == kPerTile) {
      // a whole tile: the row 16 bytes at a time, widened in registers off
      // the accumulator's chain
#pragma unroll
      for (int c = 0; c < kTileBytes / 16; ++c) {
        const uint4 v = *reinterpret_cast<const uint4*>(tile + chunk_at(lane, c));
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int k = 0; k < kPer; ++k) acc = round_to<T>(ptt_reduce_fn(acc, widen(e[k])));
      }
    } else {
      // the first tile (acc = x[:, 0]) or a ragged last one
      int j = 0;
      if (t == 0) {
        acc = widen(elem<T>(tile, lane, 0));
        j = 1;
      }
      for (; j < cn; ++j) acc = round_to<T>(ptt_reduce_fn(acc, widen(elem<T>(tile, lane, j))));
    }
    __syncwarp();                         // before the stage is staged again
  }
  if (lane < nr) store_float(out, out_code, r0 + lane, acc);
}

template <typename T>
cudaError_t launch(bool vec, const void* x, void* out, int code, int rows, int cols,
                   cudaStream_t s) {
  const int blocks = (rows + kRows - 1) / kRows;
  const T* xt = static_cast<const T*>(x);
  if (vec)
    reduce_kernel<T, true><<<blocks, 32, 0, s>>>(xt, out, code, rows, cols);
  else
    reduce_kernel<T, false><<<blocks, 32, 0, s>>>(xt, out, code, rows, cols);
  return cudaGetLastError();
}

}  // namespace rd

// ptt_reduce: out[r] = the left fold of fn over x[r, 0 .. cols - 1], each
// step rounded to x's dtype; x [rows, cols] contiguous, out [rows] in x's
// dtype (code 0 fp32, 1 bf16, 2 fp16).  vec != 0 stages x with 16-byte
// copies and needs x 16-byte aligned and cols x its item size a multiple
// of 16 (the Python wrapper's route rule); vec 0 copies element by
// element.  Returns cudaErrorInvalidValue for anything else, otherwise the
// launch's cudaError_t.
extern "C" int ptt_reduce(const void* x, void* out, int rows, int cols, int code, int vec,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0 || code < 0 || code > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = static_cast<int64_t>(cols) * (code == 0 ? 4 : 2);
  if (vec && (!aligned16(x) || row_bytes % 16)) return static_cast<int>(cudaErrorInvalidValue);
  switch (code) {
    case 0: return static_cast<int>(rd::launch<float>(vec, x, out, code, rows, cols, s));
    case 1:
      return static_cast<int>(rd::launch<__nv_bfloat16>(vec, x, out, code, rows, cols, s));
    default: return static_cast<int>(rd::launch<__half>(vec, x, out, code, rows, cols, s));
  }
}
#endif  // PTT_REDUCE

// -------------------------------------------------------------- matmul ---

#ifdef PTT_MATMUL
namespace mm {

using namespace nvcuda;

// ---- bf16 / fp16: WMMA ----
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;                 // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64, kWN = 32;             // a warp's output tile
constexpr int kFM = kWM / 16, kFN = kWN / 16; // its fragments
constexpr int kChunks = kBM * kBK / 8 / kThreads;  // 16-byte chunks a thread (A; B the same)
static_assert(kBK * kBN / 8 / kThreads == kChunks, "A and B tiles take equal chunks");

// 8 elements of T from p (row `row` of `rows`, columns [col, col + 8) of
// `cols`; out-of-range elements 0).  VEC: cols % 8 == 0 and p 16-byte
// aligned, so a chunk lies wholly inside or outside.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load8(const T* __restrict__ p, int row, int rows, int col,
                                       int cols) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return v;
  const T* q = p + static_cast<int64_t>(row) * cols + col;
  if constexpr (VEC) {
    if (col < cols) v = *reinterpret_cast<const uint4*>(q);
  } else {
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col + i < cols) e[i] = q[i];
  }
  return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
mma_kernel(const T* __restrict__ x, const T* __restrict__ w, void* __restrict__ out, int m,
           int k, int n, int out_code) {
  constexpr int LDA = kBK + 8;  // +16 bytes a row: fewer bank conflicts
  constexpr int LDB = kBN + 8;
  constexpr int LDC = 20;
  __shared__ __align__(32) T a_s[kBM][LDA];
  __shared__ __align__(32) T b_s[kBK][LDB];
  __shared__ __align__(32) float c_s[kThreads / 32][16][LDC];

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / (kBN / kWN), wn = warp % (kBN / kWN);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ar[kChunks], br[kChunks];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int i = tid + q * kThreads;
      ar[q] = load8<T, VEC>(x, m0 + i / (kBK / 8), m, k0 + (i % (kBK / 8)) * 8, k);
      br[q] = load8<T, VEC>(w, k0 + i / (kBN / 8), k, n0 + (i % (kBN / 8)) * 8, n);
    }
  };
  load(0);
  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int i = tid + q * kThreads;
      *reinterpret_cast<uint4*>(&a_s[i / (kBK / 8)][(i % (kBK / 8)) * 8]) = ar[q];
      *reinterpret_cast<uint4*>(&b_s[i / (kBN / 8)][(i % (kBN / 8)) * 8]) = br[q];
    }
    __syncthreads();
    if (k0 + kBK < k) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(a[i], &a_s[wm * kWM + i * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(b[j], &b_s[kk][wn * kWN + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each fragment through the warp's own staging tile, then the
  // functor on the fp32 sum, the cast and a masked store
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(&c_s[warp][0][0], acc[i][j], LDC, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int r = t * 2 + lane / 16, c = lane % 16;
        const int row = m0 + wm * kWM + i * 16 + r;
        const int col = n0 + wn * kWN + j * 16 + c;
        if (row < m && col < n)
          store_float(out, out_code, static_cast<int64_t>(row) * n + col,
                      ptt_epilogue_fn(c_s[warp][r][c]));
      }
      __syncwarp();
    }
}

// ---- fp32: register-tiled FMA ----
constexpr int kFT = 64;          // output tile (rows and columns)
constexpr int kFK = 16;          // k step

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int row, int rows, int col,
                                        int cols) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return v;
  const float* q = p + static_cast<int64_t>(row) * cols + col;
  if constexpr (VEC) {
    if (col < cols) v = *reinterpret_cast<const float4*>(q);
  } else {
    if (col < cols) v.x = q[0];
    if (col + 1 < cols) v.y = q[1];
    if (col + 2 < cols) v.z = q[2];
    if (col + 3 < cols) v.w = q[3];
  }
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(256)
fma_kernel(const float* __restrict__ x, const float* __restrict__ w, void* __restrict__ out,
           int m, int k, int n, int out_code) {
  __shared__ float a_s[kFK][kFT + 4];   // x tile, transposed: a_s[kk][row]
  __shared__ __align__(16) float b_s[kFK][kFT];
  const int m0 = blockIdx.y * kFT;
  const int n0 = blockIdx.x * kFT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // columns tx + 16 j, rows ty + 16 i
  const int ar = tid / 4, ac = (tid % 4) * 4;     // this thread's x chunk
  const int br = tid / 16, bc = (tid % 16) * 4;   // and w chunk
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float4 av = load4<VEC>(x, m0 + ar, m, ac, k);
  float4 bv = load4<VEC>(w, br, k, n0 + bc, n);
  for (int k0 = 0; k0 < k; k0 += kFK) {
    a_s[ac][ar] = av.x;
    a_s[ac + 1][ar] = av.y;
    a_s[ac + 2][ar] = av.z;
    a_s[ac + 3][ar] = av.w;
    *reinterpret_cast<float4*>(&b_s[br][bc]) = bv;
    __syncthreads();
    if (k0 + kFK < k) {
      av = load4<VEC>(x, m0 + ar, m, k0 + kFK + ac, k);
      bv = load4<VEC>(w, k0 + kFK + br, k, n0 + bc, n);
    }
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (row < m && col < n)
        store_float(out, out_code, static_cast<int64_t>(row) * n + col,
                    ptt_epilogue_fn(acc[i][j]));
    }
  }
}

// ---- bf16 / fp16 on the "sm90" route: wgmma over a TMA ring ----

// the caller's epilogue on one fp32 sum (its column is not read)
struct EpilogueFn {
  __device__ __forceinline__ float operator()(float a, int) const { return ptt_epilogue_fn(a); }
};

// One CTA per 128 x BN output tile (wide_sm90.cuh): warpgroup 0's thread 0
// issues TMA for the x tile [128 x 64] and the w tile [64 x BN] (BN / 64
// boxes of 64 x 64 from w [k, n], MN-major) of each k-step into the ring;
// the two consumer warpgroups run the wgmma and the epilogue.  Rows past m,
// columns past n and k past its end load as zeros (TMA's out-of-bounds
// fill) and are never stored.
template <int BN, typename T>
__global__ void __launch_bounds__(wide90::kThreads, 1)
mm_sm90_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               void* __restrict__ out, int m, int k, int n, int out_code) {
  using namespace sm90;
  namespace w9 = wide90;
  using S = w9::Smem<BN, 0>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::off_bar);
  uint64_t* empty = full + w9::kStages;
  int m0, n0;
  w9::tile_origin(m, n, BN, m0, n0);
  const int nk = (k + w9::kBK - 1) / w9::kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < w9::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);             // the consumers' warps
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (warpgroup_idx() == 0) {              // ---- producer: one thread
    setmaxnreg_dec<w9::kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_x);
      tma_prefetch_map(&tm_w);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % w9::kStages, k0 = kt * w9::kBK;
        unsigned char* a_s = smem + s * S::stage;
        mbar_wait(&empty[s], ((kt / w9::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], S::a + S::b);
        tma_load_2d(a_s, &tm_x, &full[s], k0, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(a_s + S::a + j * 64 * w9::kRowBytes, &tm_w, &full[s], n0 + 64 * j, k0);
      }
    }
  } else {                                 // ---- consumers: rows m0 + 64 w ..
    setmaxnreg_inc<w9::kConsumerRegs>();
    const int w = warpgroup_idx() - 1, t = threadIdx.x % 128;
    float acc[BN / 2];
    w9::mainloop<BN, T, w9::kStages>(acc, smem, S::stage, full, empty, nk, w, t,
                                     w9::NoPrep());
    w9::epilogue<BN>(acc, smem, out, out_code, m, n, m0, n0, w, t, EpilogueFn());
  }
}

template <int BN, typename T>
cudaError_t launch_sm90(const void* x, const void* w, void* out, int m, int k, int n,
                        int out_code, cudaStream_t s) {
  CUtensorMap tx, tw;
  if (!wide90::encode_x<T>(&tx, x, m, k)) return cudaErrorInvalidValue;
  const uint64_t dims[2] = {(uint64_t)n, (uint64_t)k};     // w [k, n], n contiguous
  const uint64_t strides[1] = {(uint64_t)n * 2};
  const uint32_t box[2] = {64, 64};
  if (!sm90::encode_bf16(&tw, w, 2, dims, strides, box, wide90::map_type<T>()))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = wide90::Smem<BN, 0>::bytes;
  const cudaError_t e = sm90::prepare_warp_specialized<mm_sm90_kernel<BN, T>>(
      bytes, wide90::kThreads, wide90::kRegsNeeded);
  if (e != cudaSuccess) return e;
  mm_sm90_kernel<BN, T><<<wide90::grid_size(m, n, BN), wide90::kThreads, bytes, s>>>(
      tx, tw, out, m, k, n, out_code);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sm90_bn(const void* x, const void* w, void* out, int m, int k, int n,
                           int out_code, cudaStream_t s) {
  return n > 128 ? launch_sm90<256, T>(x, w, out, m, k, n, out_code, s)
                 : launch_sm90<128, T>(x, w, out, m, k, n, out_code, s);
}

template <typename T>
cudaError_t launch_mma(bool vec, const void* x, const void* w, void* out, int m, int k, int n,
                       int out_code, cudaStream_t s) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (vec)
    mma_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, wt, out, m, k, n, out_code);
  else
    mma_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, wt, out, m, k, n, out_code);
  return cudaGetLastError();
}

cudaError_t launch_fma(bool vec, const void* x, const void* w, void* out, int m, int k, int n,
                       int out_code, cudaStream_t s) {
  const dim3 grid((n + kFT - 1) / kFT, (m + kFT - 1) / kFT);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  if (vec)
    fma_kernel<true><<<grid, 256, 0, s>>>(xf, wf, out, m, k, n, out_code);
  else
    fma_kernel<false><<<grid, 256, 0, s>>>(xf, wf, out, m, k, n, out_code);
  return cudaGetLastError();
}

}  // namespace mm

// ptt_matmul: out [m, n] = cast(epilogue(x [m, k] @ w [k, n])), the sum in
// fp32; x and w of one dtype (code 0 fp32, 1 bf16, 2 fp16), out of any;
// all contiguous on the stream's device (the Python wrapper checks that).
// route is kernels/primitives.py:_matmul_route's: 0 "fma" (fp32), 1 "mma"
// (bf16/fp16, WMMA), 2 "sm90" (bf16/fp16 with k > 0, k and n multiples of 8
// and x, w 16-byte aligned: wgmma over a TMA ring).  k may be 0 on "fma"
// and "mma" (the sum is 0).  Returns cudaErrorInvalidValue for a route the
// operands do not fit, otherwise the launch's cudaError_t.
extern "C" int ptt_matmul(const void* x, const void* w, void* out, int m, int k, int n,
                          int code, int out_code, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k < 0 || out_code < 0 || out_code > 2 || code < 0 || code > 2 ||
      (route == 0) != (code == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = aligned16(x) && aligned16(w);
  switch (route) {
    case 0:
      return static_cast<int>(mm::launch_fma(aligned && k % 4 == 0 && n % 4 == 0, x, w, out,
                                             m, k, n, out_code, s));
    case 1:
      return static_cast<int>(
          code == 1 ? mm::launch_mma<__nv_bfloat16>(aligned && k % 8 == 0 && n % 8 == 0, x, w,
                                                    out, m, k, n, out_code, s)
                    : mm::launch_mma<__half>(aligned && k % 8 == 0 && n % 8 == 0, x, w, out, m,
                                             k, n, out_code, s));
    case 2:
      if (!aligned || k <= 0 || k % 8 || n % 8 || !aligned16(out))
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(
          code == 1 ? mm::launch_sm90_bn<__nv_bfloat16>(x, w, out, m, k, n, out_code, s)
                    : mm::launch_sm90_bn<__half>(x, w, out, m, k, n, out_code, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif  // PTT_MATMUL
