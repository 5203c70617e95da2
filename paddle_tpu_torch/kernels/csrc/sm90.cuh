// Hopper (sm_90a) building blocks in raw PTX: mbarriers, TMA tile loads and
// their tensor maps, cp.async and the proxy fence, wgmma descriptors and
// instructions, setmaxnreg.
//
// Shared-memory tiles are in the 128-byte swizzle that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and that wgmma reads with descriptor layout 1:
// an "atom" is 8 rows of 128 bytes (64 bf16), row r's 16-byte chunk c
// stored at chunk c ^ (r % 8), and a tile of R rows x 64 bf16 is R / 8
// atoms back to back (1024 bytes apart), 1024-byte aligned.  A tile wider
// than 64 elements is several such column blocks, one after the other.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace sm90 {

// ---- shared-memory addresses and mbarriers --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// adds `bytes` to the transactions the current phase waits for (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed (a plain spin: a
// timeout with clock64 and __trap in this loop costs the consumers their
// setmaxnreg budget, ptxas then spills and serialises the wgmma)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// ---- TMA ------------------------------------------------------------------

// one box of a 4-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// one box of a 3-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one box of a 2-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes from global to shared memory without registers (L2 only);
// `bytes` 0 writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes from global to shared memory
// in one bulk copy (TMA, no tensor map); completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// arrive on `bar` once every cp.async this thread has issued so far has
// landed (the arrival is one of those the barrier's count expects)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's most recent groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's generic-proxy writes to shared memory (st.shared,
// a completed cp.async) visible to the async proxy that wgmma and TMA read
// through; then an mbarrier arrive hands the tile on
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (the
// libraries link no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A bf16 tensor [B, S, H, D] (D contiguous) as a 4-D map whose box is
// `rows` positions of one (batch, head) by 64 columns, 128-byte swizzled:
// coordinates {column, head, position, batch}.  Positions past S load as
// zeros; a box never crosses into the next batch row.
inline bool encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                        int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A tensor of `rank` (2 or 3) dimensions of `type`, dims[0] contiguous, as
// a map whose box is box[0] x box[1] (x box[2]) elements with `swizzle`;
// `strides` are the byte strides of dims 1 and 2.  Elements outside the
// tensor load as zeros.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, CUtensorMapSwizzle swizzle,
                       const void* base, int rank, const uint64_t* dims, const uint64_t* strides,
                       const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr || rank < 2 || rank > 3) return false;
  cuuint64_t d[3], st[2];
  cuuint32_t b[3], elem[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
  }
  for (int i = 0; i + 1 < rank; ++i) st[i] = strides[i];
  return fn(map, type, rank, const_cast<void*>(base), d, st, b, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 (or, with `type`, fp16) tensor of `rank` (2 or 3) dimensions as a
// map whose box is box[0] (64: one 128-byte row) x box[1] (x 1), 128-byte
// swizzled (encode_map).
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                        const uint64_t* strides, const uint32_t* box,
                        CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  return encode_map(map, type, CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims, strides, box);
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at `p` (layout type 1).  K-major
// (the reduction dimension contiguous): `sbo` = 1024, the stride between
// 8-row atoms; a step of 16 along K adds 32 bytes to the address inside a
// 64-column block.  MN-major (read transposed, tnsp = 1): `sbo` = 1024, the
// stride between 8-deep groups along K, and `lbo` the stride between
// 64-column blocks along M or N.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// the descriptor of the operand `bytes` further on: a 32-bit add to the
// address field (it cannot carry out of it inside 256 KB of shared memory)
__device__ __forceinline__ uint64_t desc_advance(uint64_t d, uint32_t bytes) {
  const uint32_t lo = static_cast<uint32_t>(d) + (bytes >> 4);
  return (d & 0xFFFFFFFF00000000ull) | lo;
}

// the warpgroup of the calling thread, as a value the compiler knows to be
// the same across the warp (so what is computed from it, such as
// descriptors, can live in uniform registers)
__device__ __forceinline__ int warpgroup_idx() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] = A[64 x 16] B[16 x 64] (FIRST: D's old values are neither
// read nor kept alive) or D += A B; A and B K-major in shared memory
template <bool FIRST>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(da), "l"(db), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
}

// D[64 x N] += A[64 x 16] B[16 x N], both operands in shared memory
// (128-byte swizzled descriptors): TA / TB 0 for a K-major operand, 1 for
// an MN-major one (read transposed).  N is 8, 16, 32, 64, 128 or 256 (N / 2
// accumulator floats a thread, the fragment of frag_row / frag_col).  T is
// the operands' type: __nv_bfloat16 (the default) or __half.
template <int N, int TA, int TB, typename T = __nv_bfloat16>
struct WgmmaSS;

// true for fp16 operands (the instruction's .f16.f16), false for bf16
template <typename T>
constexpr bool kWgmmaF16 = std::is_same<T, __half>::value;

#define PTT_WGMMA_SS_N8(TY)  \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3}, " \
      "%4, %5, p, 1, 1, %7, %8;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

template <int TA, int TB, typename T>
struct WgmmaSS<8, TA, TB, T> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db) {
    if constexpr (kWgmmaF16<T>) {
      PTT_WGMMA_SS_N8("f16");
    } else {
      PTT_WGMMA_SS_N8("bf16");
    }
  }
};
#undef PTT_WGMMA_SS_N8

#define PTT_WGMMA_SS_N16(TY)  \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, " \
      "%8, %9, p, 1, 1, %11, %12;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]) \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

template <int TA, int TB, typename T>
struct WgmmaSS<16, TA, TB, T> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db) {
    if constexpr (kWgmmaF16<T>) {
      PTT_WGMMA_SS_N16("f16");
    } else {
      PTT_WGMMA_SS_N16("bf16");
    }
  }
};
#undef PTT_WGMMA_SS_N16

#define PTT_WGMMA_SS_N32(TY)  \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
      "%16, %17, p, 1, 1, %19, %20;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

template <int TA, int TB, typename T>
struct WgmmaSS<32, TA, TB, T> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db) {
    if constexpr (kWgmmaF16<T>) {
      PTT_WGMMA_SS_N32("f16");
    } else {
      PTT_WGMMA_SS_N32("bf16");
    }
  }
};
#undef PTT_WGMMA_SS_N32

#define PTT_WGMMA_SS_N64(TY)  \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n" \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, %35, %36;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
        "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

template <int TA, int TB, typename T>
struct WgmmaSS<64, TA, TB, T> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    if constexpr (kWgmmaF16<T>) {
      PTT_WGMMA_SS_N64("f16");
    } else {
      PTT_WGMMA_SS_N64("bf16");
    }
  }
};
#undef PTT_WGMMA_SS_N64

#define PTT_WGMMA_SS_N128(TY)  \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n" \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n" \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n" \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, %67, %68;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

template <int TA, int TB, typename T>
struct WgmmaSS<128, TA, TB, T> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    if constexpr (kWgmmaF16<T>) {
      PTT_WGMMA_SS_N128("f16");
    } else {
      PTT_WGMMA_SS_N128("bf16");
    }
  }
};
#undef PTT_WGMMA_SS_N128

#define PTT_WGMMA_SS_N256(TY)  \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n" \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n" \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n" \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,\n" \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,\n" \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,\n" \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,\n" \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, " \
      "%128, %129, p, 1, 1, %131, %132;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), \
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), \
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), \
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), \
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), \
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), \
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), \
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), \
        "+f"(d[127]) \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

template <int TA, int TB, typename T>
struct WgmmaSS<256, TA, TB, T> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) {
    if constexpr (kWgmmaF16<T>) {
      PTT_WGMMA_SS_N256("f16");
    } else {
      PTT_WGMMA_SS_N256("bf16");
    }
  }
};
#undef PTT_WGMMA_SS_N256


// S[64 x 64] = A B^T over D (a multiple of 64): A the 64 rows at `a` of a
// tile of A_ROWS rows, B a 64-row tile, both K-major (D / 64 column blocks
// of 128-byte rows, block c of a tile of R rows at c * R * 128).
// Descriptors are a base plus a constant, so none is held in registers
// across a caller's tile loop.
template <int D, int A_ROWS>
__device__ __forceinline__ void wgmma_scores(float (&acc)[32], const unsigned char* a,
                                             const unsigned char* b) {
  const uint64_t da = desc_sw128(a, 16, 1024), db = desc_sw128(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t blk = kk / 4, k32 = (kk % 4) * 32;
    const uint64_t a_k = desc_advance(da, blk * A_ROWS * 128 + k32);
    const uint64_t b_k = desc_advance(db, blk * 64 * 128 + k32);
    if (kk == 0) wgmma_ss_m64n64k16<true>(acc, a_k, b_k);
    else wgmma_ss_m64n64k16<false>(acc, a_k, b_k);
  }
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (a[0..3], the
// accumulator's fragment layout packed to bf16 pairs), B MN-major in shared
// memory (tnsp = 1); `accumulate` 0 overwrites D
__device__ __forceinline__ void wgmma_rs_m64n64k16_t(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], as wgmma_rs_m64n64k16_t
__device__ __forceinline__ void wgmma_rs_m64n128k16_t(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x N] += A B for N = 64 or 128 (N / 2 accumulator floats)
template <int NF>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[NF], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  static_assert(NF == 32 || NF == 64, "N is 64 or 128");
  if constexpr (NF == 32) wgmma_rs_m64n64k16_t(d, a, db, accumulate);
  else wgmma_rs_m64n128k16_t(d, a, db, accumulate);
}

// ACC[64 x D] += A[64 x 64] B[64 x D]: A four bf16 register fragments (k
// steps of 16 rows of B), B a 64-row tile read transposed (MN-major; LBO
// the 8 KB between its 64-column blocks)
template <int D>
__device__ __forceinline__ void wgmma_accumulate(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                                 const unsigned char* b) {
  const uint64_t db = desc_sw128(b, 64 * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_t(acc, a[kk], desc_advance(db, kk * 16 * 128), 1);
}

// Accumulator fragment of an m64nN product: thread t of the warpgroup holds
// element i at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ int frag_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// two floats as a bf16 pair (the first in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of step k (columns 16k .. 16k + 15) of an accumulator
// fragment, packed to bf16: the C layout of m64nN equals the A layout of
// m64nNk16 column block by column block.
template <int N>
__device__ __forceinline__ void frag_to_a(const float (&c)[N], int k, uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[8 * k + 0], c[8 * k + 1]);
  a[1] = pack_bf16(c[8 * k + 2], c[8 * k + 3]);
  a[2] = pack_bf16(c[8 * k + 4], c[8 * k + 5]);
  a[3] = pack_bf16(c[8 * k + 6], c[8 * k + 7]);
}

// 2^x in one MUFU.EX2 (approximate, subnormal results flushed to 0), where
// exp2f adds instructions for subnormals to every element
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- warp specialisation --------------------------------------------------

// named barrier `id` over `threads` threads (a multiple of 32; id 0 is
// __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// named barrier `id` over `threads` threads that also returns whether
// `pred` holds in every one of them
__device__ __forceinline__ bool bar_and(int id, int threads, bool pred) {
  uint32_t all;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.and.pred q, %2, %3, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(all)
      : "r"(static_cast<uint32_t>(pred)), "r"(id), "r"(threads)
      : "memory");
  return all != 0;
}

// the first 1024-byte boundary at or after p (a 128-byte-swizzled tile's
// alignment)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uintptr_t a = (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023);
  return reinterpret_cast<unsigned char*>(a);
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- per-device launch set-up ----------------------------------------------

// A function attribute belongs to the device that was current when it was
// set, so set-up done once per process would leave a launch on another card
// without it.  Runs `setup` once for each device that launches `Kernel`
// (the current device) and returns its result there; two threads that race
// both run it, which is harmless for an attribute.
constexpr int kMaxDevices = 64;

template <auto Kernel, typename Setup>
cudaError_t once_per_device(Setup setup) {
  static std::atomic<int> state[kMaxDevices];  // 0: not yet, else error + 1
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return setup();
  int s = state[dev].load(std::memory_order_acquire);
  if (s == 0) {
    s = static_cast<int>(setup()) + 1;
    state[dev].store(s, std::memory_order_release);
  }
  return static_cast<cudaError_t>(s - 1);
}

// Allows `Kernel` `bytes` of dynamic shared memory on the current device.
template <auto Kernel>
cudaError_t allow_dynamic_smem(size_t bytes) {
  return once_per_device<Kernel>([=]() -> cudaError_t {
    return cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
  });
}

// A warp-specialised kernel's consumers raise their registers with
// setmaxnreg.inc, which waits for registers the producer gives back; it can
// only be met when the launch holds threads x numRegs >= `regs_needed`, the
// sum of both roles' budgets.  Checked once per kernel and device, so a
// build that breaks it fails the launch instead of hanging the card; then
// allows `smem_bytes` of dynamic shared memory.
template <auto Kernel>
cudaError_t prepare_warp_specialized(size_t smem_bytes, int threads, int regs_needed) {
  return once_per_device<Kernel>([=]() -> cudaError_t {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, Kernel);
    if (e != cudaSuccess) return e;
    if (attr.numRegs * threads < regs_needed) return cudaErrorLaunchOutOfResources;
    return cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem_bytes));
  });
}

}  // namespace sm90
