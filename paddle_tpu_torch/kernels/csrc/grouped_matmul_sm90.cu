// Grouped (ragged) expert matmul for Hopper (sm_90a), bf16: gmm on wgmma,
// fed by a TMA ring, warp-specialised.
//
// Replaces, in paddle_tpu/kernels/grouped_matmul.py (the Pallas TPU
// kernel), _gmm_kernel with its fused row gather _gather_rows, in every form
// it has, for bf16 operands (fp32 stays on grouped_matmul.cu's kernel:
// kernels/grouped_matmul.py:_route).  ptt_gmm_sm90 takes ptt_gmm's
// arguments and computes what the plain _gmm_reference computes,
//
//   out[m, :] = s[m] * lhs[rows[m], :] @ W[tile_groups[m / bm]]
//
// with W = rhs[e] ([C, O], the forward) or rhs[e]^T (trans_rhs: rhs
// [E, O, C], the backward's dlhs); rows null reads lhs[m]; s null is 1,
// else s[m] multiplies the gathered row in bf16 before the product (the
// Pallas kernel's `lblk * scale`, rounded as the plain version rounds it).
// Accumulation is fp32; out is bf16.
//
// What bounds it on this card:
// - training and prefill (hundreds to thousands of rows an expert):
//   operations.  2 M C O flops at 989 TFLOP/s counting the live rows: at
//   the Mixtral training shape (M 20480 padded rows, 16384 live, H 4096,
//   I 14336) 1.946 ms a call.
// - decode (a handful of rows an expert): bytes.  Every expert that owns a
//   live row has its whole [C, O] weight read once: at Mixtral widths up to
//   8 x 4096 x 14336 x 2 B = 940 MB, 0.28 ms at 3.35 TB/s.
//
// What the design does about it (one plan, kernels/grouped_matmul.py:
// sm90_plan, picks the form from bm):
// - Ring and roles.  Each CTA runs a kStages-deep shared-memory ring with
//   full/empty mbarriers.  Warpgroup 0 is the producer: one thread issues
//   TMA for the weight tiles (and, in the wide form with neither gather nor
//   scale, for the lhs tile), and all 128 of its threads gather lhs rows
//   when the form has them: rows[] is read once per tile into shared
//   memory, each 16-byte chunk goes global -> shared by cp.async (no
//   registers held) straight into the 128-byte swizzle (chunk c of row r at
//   c ^ (r % 8)), K tails zero-filled; kLag stages later the thread waits
//   for its own copies, scales its own chunks in place (row_scale, bf16),
//   fences the proxy and arrives.  The consumers run wgmma with fp32
//   accumulators, keep one k-step's products in flight and release a stage
//   when its products are done.
// - Wide form (bm a multiple of 128; the training plan's bm 512): a CTA
//   computes 128 rows x BN columns (BN 256 where O allows, else 128) in
//   k-steps of 64, two consumer warpgroups of 64 rows each (m64nBNk16, SS:
//   lhs K-major; W MN-major in the forward, K-major with trans_rhs), at
//   setmaxnreg 232 against the producer's 40.  A tile never straddles two
//   experts (128 divides bm); its expert is read once.  The tile walk goes
//   in groups of kGroupRows row tiles, all column tiles of a group before
//   the next, so the CTAs that run together share both their lhs rows and
//   an expert's weight columns through L2.
// - Narrow form (bm < 128: decode's 16, bm 8, 24, 64): bytes-bound, so the
//   operands swap: out^T [64 output columns x TM rows] = W^T tile (wgmma's
//   A, 64 rows) x the TM gathered rows (wgmma's n = TM, 8..64).  One
//   consumer warpgroup; ~40 KB of shared memory at TM 16, so several CTAs
//   share an SM and the weight stream fills the card: at decode gate/up
//   14336 / 64 x 9 row tiles = 2016 CTAs, row tiles fastest so the tiles of
//   one expert read its weight columns together.  The out^T fragment is
//   staged in shared memory and written with 16-byte stores.
// - Padding.  With a gather, a row tile whose rows all read one all-zero
//   row (the callers' sentinel) writes zeros without loading its weights
//   or running a product.  Without a gather padding rows cannot be told
//   from live ones, so every row is computed.
// - Ragged shapes: C a multiple of 32, O of 64 (grouped_matmul.py: _BK,
//   _BN), any bm that the row tiles divide.  K tails are zero-filled by
//   TMA's out-of-bounds fill and by the cp.async source size; an N tail of
//   a wide tile (O % 128 == 64) loads zeros and is not stored.
// - Each output element is written once after a sum in a fixed order: two
//   runs give the same bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "grouped_sm90.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;
using namespace gsm90;   // kRowBytes, kProducerThreads, swz, scale8, zero8
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                 // contraction per k-step: one 128-byte row
constexpr int kStages = 4;
constexpr int kLag = 2;                 // stages a gathering thread runs ahead of its arrive
constexpr int kWideRows = 128;          // wide: rows of a CTA, 64 a consumer
constexpr int kWideThreads = 384;
constexpr int kNarrowCols = 64;         // narrow: output columns of a CTA
constexpr int kNarrowThreads = 256;
constexpr int kGroupRows = 16;          // wide: row tiles a raster group walks
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kRegsNeeded = kProducerRegs * 128 + kConsumerRegs * 256;   // setmaxnreg
static_assert(kLag + 1 < kStages, "a lagged arrive must not wait on its own stage");

__device__ __forceinline__ int expert_of(const int32_t* tile_groups, int m0, int bm, int E) {
  const int g = tile_groups[m0 / bm];
  return min(max(g, 0), E - 1);
}

__device__ __forceinline__ int64_t source_row(const int32_t* rows, int m, int L) {
  const int src = rows ? rows[m] : m;
  return (int64_t)min(max(src, 0), L - 1);
}

// Whether the gathered rows [m0, m0 + rows_n) all read one all-zero row of
// lhs: then the tile's output is exactly 0.  Every thread of the CTA calls
// it (it ends in __syncthreads_and).
__device__ bool padding_tile(const bf16* lhs, const int32_t* rows, int m0, int rows_n, int C,
                             int L) {
  bool pad = rows != nullptr;
  if (pad) {
    const int r0 = rows[m0];
    for (int r = threadIdx.x; r < rows_n; r += blockDim.x) pad &= rows[m0 + r] == r0;
    const uint4* src = reinterpret_cast<const uint4*>(lhs + source_row(rows, m0, L) * C);
    for (int c = threadIdx.x; pad && c < C / 8; c += blockDim.x) pad &= zero8(__ldg(src + c));
  }
  return __syncthreads_and(pad) != 0;
}

// zeros into out[m0 .. m0 + rows_n, n0 .. n0 + cols) (cols a multiple of 8)
__device__ void store_zeros(bf16* out, int m0, int rows_n, int n0, int cols, int O) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows_n * chunks; i += blockDim.x) {
    const int r = i / chunks, c8 = (i % chunks) * 8;
    if (n0 + c8 < O)
      *reinterpret_cast<uint4*>(out + (int64_t)(m0 + r) * O + n0 + c8) = make_uint4(0, 0, 0, 0);
  }
}

// The producer's share of one stage's lhs tile: ROWS rows x 64 columns from
// k0, row r read from lhs[src[r]] (shared memory), chunk by chunk with
// cp.async into the swizzled tile at `dst`; columns past C are zeros.
template <int ROWS>
__device__ __forceinline__ void gather_issue(unsigned char* dst, const bf16* lhs,
                                             const int64_t* src, int k0, int C, int t) {
  constexpr int kChunks = ROWS * 8;
#pragma unroll
  for (int id = t; id < kChunks; id += kProducerThreads) {
    const int r = id >> 3, c = id & 7, k = k0 + c * 8;
    const bf16* g = lhs + src[r] * C + (k < C ? k : 0);
    cp_async16(dst + swz(r, c), g, k < C ? 16u : 0u);
  }
}

// row_scale on the chunks this thread copied (after its copies landed)
template <int ROWS>
__device__ __forceinline__ void gather_scale(unsigned char* dst, const bf16* scl, int t) {
  constexpr int kChunks = ROWS * 8;
#pragma unroll
  for (int id = t; id < kChunks; id += kProducerThreads) {
    uint4* p = reinterpret_cast<uint4*>(dst + swz(id >> 3, id & 7));
    *p = scale8(*p, scl[id >> 3]);
  }
}

// ------------------------------------------------------------ wide form ---

template <int BN>
struct WideSmem {
  static constexpr uint32_t a = kWideRows * kRowBytes;     // 128 rows x 64: 16 KB
  static constexpr uint32_t b = BN * kRowBytes;            // 64 x BN or BN x 64
  static constexpr uint32_t stage = a + b;
  static constexpr uint32_t off_src = kStages * stage;     // int64 [128]
  static constexpr uint32_t off_scl = off_src + kWideRows * 8;   // bf16 [128]
  static constexpr uint32_t off_bar = off_scl + kWideRows * 4;
  static constexpr uint32_t bytes = off_bar + 2 * kStages * 8 + 1024;   // + alignment
  static_assert(bytes <= 232448, "wide stages exceed shared memory");
};

template <int BN, bool TRANS, bool GATHER>
__global__ void __launch_bounds__(kWideThreads, 1)
gmm_sm90_wide_kernel(const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_a, const bf16* __restrict__ lhs,
                     const int32_t* __restrict__ tile_groups, const int32_t* __restrict__ rows,
                     const bf16* __restrict__ scale, bf16* __restrict__ out, int M, int C, int O,
                     int E, int L, int bm) {
  using S = WideSmem<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int64_t* src_s = reinterpret_cast<int64_t*>(smem + S::off_src);
  bf16* scl_s = reinterpret_cast<bf16*>(smem + S::off_scl);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::off_bar);
  uint64_t* empty = full + kStages;

  // the tile walk: groups of kGroupRows row tiles, column tiles outer
  const int n_mt = M / kWideRows, n_nt = (O + BN - 1) / BN;
  const int per_group = kGroupRows * n_nt;
  const int group = blockIdx.x / per_group, first = group * kGroupRows;
  const int g_rows = min(kGroupRows, n_mt - first);
  const int in = blockIdx.x % per_group;
  const int m0 = (first + in % g_rows) * kWideRows, n0 = (in / g_rows) * BN;
  const int e = expert_of(tile_groups, m0, bm, E);
  const int nk = (C + kBK - 1) / kBK;

  if (GATHER && padding_tile(lhs, rows, m0, kWideRows, C, L)) {
    store_zeros(out, m0, kWideRows, n0, BN, O);
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducerThreads);
      mbar_init(&empty[s], 8);                 // the consumers' warps
    }
    fence_barrier_init();
  }
  if (GATHER) {
    for (int r = threadIdx.x; r < kWideRows; r += kWideThreads) {
      src_s[r] = source_row(rows, m0 + r, L);
      if (scale) scl_s[r] = scale[m0 + r];
    }
  }
  __syncthreads();

  if (warpgroup_idx() == 0) {              // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    const int t = threadIdx.x;
    if (t == 0) {
      tma_prefetch_map(&tm_w);
      if (!GATHER) tma_prefetch_map(&tm_a);
    }
    for (int kt = 0; kt < nk + kLag; ++kt) {
      if (kt < nk) {
        const int s = kt % kStages, k0 = kt * kBK;
        unsigned char* a_s = smem + s * S::stage;
        unsigned char* b_s = a_s + S::a;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        if (t == 0) {
          mbar_expect_tx(&full[s], GATHER ? S::b : S::a + S::b);
          if (TRANS) {
            tma_load_3d(b_s, &tm_w, &full[s], k0, n0, e);            // BN rows of [O, C]
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)                         // 64-column blocks
              tma_load_3d(b_s + j * 64 * kRowBytes, &tm_w, &full[s], n0 + 64 * j, k0, e);
          }
          if (!GATHER) tma_load_2d(a_s, &tm_a, &full[s], k0, m0);
        }
        if (GATHER) gather_issue<kWideRows>(a_s, lhs, src_s, k0, C, t);
      }
      cp_async_commit();
      if (kt >= kLag) {
        const int s = (kt - kLag) % kStages;
        cp_async_wait<kLag>();
        if (GATHER && scale) gather_scale<kWideRows>(smem + s * S::stage, scl_s, t);
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
  } else {                                 // ---- consumers: rows m0 + 64 w ..
    setmaxnreg_inc<kConsumerRegs>();
    const int w = warpgroup_idx() - 1, t = threadIdx.x % 128;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      const unsigned char* a_s = smem + s * S::stage;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint64_t da = desc_sw128(a_s + w * 64 * kRowBytes, 16, 1024);
      const uint64_t db = TRANS ? desc_sw128(a_s + S::a, 16, 1024)
                                : desc_sw128(a_s + S::a, 64 * kRowBytes, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        WgmmaSS<BN, 0, TRANS ? 0 : 1>::mma(
            acc, desc_advance(da, kk * 32),
            desc_advance(db, TRANS ? kk * 32 : kk * 16 * kRowBytes));
      wgmma_commit();
      wgmma_wait<1>();                     // the previous step's products are done
      if (kt > 0 && (t & 31) == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // bf16 pairs straight from the fragment
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = m0 + 64 * w + frag_row(t, i), c = n0 + frag_col(t, i);
      if (c < O)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)r * O + c) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// ---------------------------------------------------------- narrow form ---

template <int TM>
struct NarrowSmem {
  static constexpr uint32_t a = kNarrowCols * kRowBytes;   // W^T: 64 columns x 64: 8 KB
  static constexpr uint32_t b = TM * kRowBytes;            // TM rows x 64
  static constexpr uint32_t stage = a + b;                 // a multiple of 1024
  static constexpr uint32_t off_out = kStages * stage;     // bf16 [TM][64]
  static constexpr uint32_t off_src = off_out + TM * kRowBytes;   // int64 [TM]
  static constexpr uint32_t off_scl = off_src + TM * 8;    // bf16 [TM]
  static constexpr uint32_t off_bar = off_scl + TM * 4;
  static constexpr uint32_t bytes = off_bar + 2 * kStages * 8 + 1024;
};

template <int TM, bool TRANS>
__global__ void __launch_bounds__(kNarrowThreads)
gmm_sm90_narrow_kernel(const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ lhs,
                       const int32_t* __restrict__ tile_groups,
                       const int32_t* __restrict__ rows, const bf16* __restrict__ scale,
                       bf16* __restrict__ out, int M, int C, int O, int E, int L, int bm) {
  using S = NarrowSmem<TM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* out_s = reinterpret_cast<bf16*>(smem + S::off_out);
  int64_t* src_s = reinterpret_cast<int64_t*>(smem + S::off_src);
  bf16* scl_s = reinterpret_cast<bf16*>(smem + S::off_scl);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::off_bar);
  uint64_t* empty = full + kStages;

  const int n_mt = M / TM;                 // row tiles fastest: one expert's
  const int m0 = (blockIdx.x % n_mt) * TM; // tiles read its columns together
  const int n0 = (blockIdx.x / n_mt) * kNarrowCols;
  const int e = expert_of(tile_groups, m0, bm, E);
  const int nk = (C + kBK - 1) / kBK;

  if (padding_tile(lhs, rows, m0, TM, C, L)) {
    store_zeros(out, m0, TM, n0, kNarrowCols, O);
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducerThreads);
      mbar_init(&empty[s], 4);
    }
    fence_barrier_init();
  }
  for (int r = threadIdx.x; r < TM; r += kNarrowThreads) {
    src_s[r] = source_row(rows, m0 + r, L);
    if (scale) scl_s[r] = scale[m0 + r];
  }
  __syncthreads();

  if (warpgroup_idx() == 0) {              // ---- producer
    const int t = threadIdx.x;
    if (t == 0) tma_prefetch_map(&tm_w);
    for (int kt = 0; kt < nk + kLag; ++kt) {
      if (kt < nk) {
        const int s = kt % kStages, k0 = kt * kBK;
        unsigned char* a_s = smem + s * S::stage;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        if (t == 0) {
          mbar_expect_tx(&full[s], S::a);
          if (TRANS) tma_load_3d(a_s, &tm_w, &full[s], k0, n0, e);   // [64 o][64 c]
          else tma_load_3d(a_s, &tm_w, &full[s], n0, k0, e);         // [64 c][64 o]
        }
        gather_issue<TM>(a_s + S::a, lhs, src_s, k0, C, t);
      }
      cp_async_commit();
      if (kt >= kLag) {
        const int s = (kt - kLag) % kStages;
        cp_async_wait<kLag>();
        if (scale) gather_scale<TM>(smem + s * S::stage + S::a, scl_s, t);
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
  } else {                                 // ---- consumer: out^T = W^T rows^T
    const int t = threadIdx.x % 128;
    float acc[TM / 2];
#pragma unroll
    for (int i = 0; i < TM / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      const unsigned char* a_s = smem + s * S::stage;
      mbar_wait(&full[s], (kt / kStages) & 1);
      // W^T: K-major from [O, C] (trans_rhs), MN-major from [C, O]
      const uint64_t da = TRANS ? desc_sw128(a_s, 16, 1024)
                                : desc_sw128(a_s, 64 * kRowBytes, 1024);
      const uint64_t db = desc_sw128(a_s + S::a, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        WgmmaSS<TM, TRANS ? 0 : 1, 0>::mma(
            acc, desc_advance(da, TRANS ? kk * 32 : kk * 16 * kRowBytes),
            desc_advance(db, kk * 32));
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && (t & 31) == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // the fragment holds out^T: element i is column n0 + frag_row, row
    // m0 + frag_col; stage it as [row][64 columns], then 16-byte stores
#pragma unroll
    for (int i = 0; i < TM / 2; ++i)
      out_s[frag_col(t, i) * kNarrowCols + frag_row(t, i)] = __float2bfloat16(acc[i]);
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    for (int i = t; i < TM * 8; i += 128) {
      const int r = i >> 3, c8 = (i & 7) * 8;
      *reinterpret_cast<uint4*>(out + (int64_t)(m0 + r) * O + n0 + c8) =
          *reinterpret_cast<const uint4*>(out_s + r * kNarrowCols + c8);
    }
  }
}

// ---------------------------------------------------------------- launch ---

// The weight as a 3-D map: [E, C, O] (forward: box 64 columns of O x 64 rows
// of C) or [E, O, C] (trans_rhs: box 64 columns of C x `rows` rows of O).
bool encode_weight(CUtensorMap* map, const void* rhs, int E, int C, int O, bool trans,
                   int rows) {
  const uint64_t inner = trans ? C : O, outer = trans ? O : C;
  const uint64_t dims[3] = {inner, outer, (uint64_t)E};
  const uint64_t strides[2] = {inner * 2, inner * outer * 2};
  const uint32_t box[3] = {64, (uint32_t)(trans ? rows : 64), 1};
  return encode_bf16(map, rhs, 3, dims, strides, box);
}

template <int BN, bool TRANS, bool GATHER>
cudaError_t launch_wide(const void* lhs, const void* rhs, const void* tg, const void* rows,
                        const void* scale, void* out, int M, int C, int O, int E, int L,
                        int bm, cudaStream_t s) {
  CUtensorMap tw, ta;
  if (!encode_weight(&tw, rhs, E, C, O, TRANS, BN)) return cudaErrorInvalidValue;
  if (!GATHER) {
    const uint64_t dims[2] = {(uint64_t)C, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)C * 2};
    const uint32_t box[2] = {64, kWideRows};
    if (!encode_bf16(&ta, lhs, 2, dims, strides, box)) return cudaErrorInvalidValue;
  } else {
    ta = tw;                               // unused
  }
  constexpr size_t bytes = WideSmem<BN>::bytes;
  const cudaError_t e = prepare_warp_specialized<gmm_sm90_wide_kernel<BN, TRANS, GATHER>>(
      bytes, kWideThreads, kRegsNeeded);
  if (e != cudaSuccess) return e;
  const int grid = (M / kWideRows) * ((O + BN - 1) / BN);
  gmm_sm90_wide_kernel<BN, TRANS, GATHER><<<grid, kWideThreads, bytes, s>>>(
      tw, ta, static_cast<const bf16*>(lhs), static_cast<const int32_t*>(tg),
      static_cast<const int32_t*>(rows), static_cast<const bf16*>(scale),
      static_cast<bf16*>(out), M, C, O, E, L, bm);
  return cudaGetLastError();
}

template <int BN, bool TRANS>
cudaError_t wide_as(bool gather, const void* lhs, const void* rhs, const void* tg,
                    const void* rows, const void* scale, void* out, int M, int C, int O, int E,
                    int L, int bm, cudaStream_t s) {
  return gather ? launch_wide<BN, TRANS, true>(lhs, rhs, tg, rows, scale, out, M, C, O, E, L,
                                               bm, s)
                : launch_wide<BN, TRANS, false>(lhs, rhs, tg, rows, scale, out, M, C, O, E, L,
                                                bm, s);
}

template <int TM, bool TRANS>
cudaError_t launch_narrow(const void* lhs, const void* rhs, const void* tg, const void* rows,
                          const void* scale, void* out, int M, int C, int O, int E, int L,
                          int bm, cudaStream_t s) {
  CUtensorMap tw;
  if (!encode_weight(&tw, rhs, E, C, O, TRANS, kNarrowCols)) return cudaErrorInvalidValue;
  constexpr size_t bytes = NarrowSmem<TM>::bytes;
  const cudaError_t attr = allow_dynamic_smem<gmm_sm90_narrow_kernel<TM, TRANS>>(bytes);
  if (attr != cudaSuccess) return attr;
  const int grid = (M / TM) * (O / kNarrowCols);
  gmm_sm90_narrow_kernel<TM, TRANS><<<grid, kNarrowThreads, bytes, s>>>(
      tw, static_cast<const bf16*>(lhs), static_cast<const int32_t*>(tg),
      static_cast<const int32_t*>(rows), static_cast<const bf16*>(scale),
      static_cast<bf16*>(out), M, C, O, E, L, bm);
  return cudaGetLastError();
}

template <bool TRANS>
cudaError_t narrow_as(int tm, const void* lhs, const void* rhs, const void* tg,
                      const void* rows, const void* scale, void* out, int M, int C, int O,
                      int E, int L, int bm, cudaStream_t s) {
#define PTT_ARGS lhs, rhs, tg, rows, scale, out, M, C, O, E, L, bm, s
  switch (tm) {
    case 8: return launch_narrow<8, TRANS>(PTT_ARGS);
    case 16: return launch_narrow<16, TRANS>(PTT_ARGS);
    case 32: return launch_narrow<32, TRANS>(PTT_ARGS);
    case 64: return launch_narrow<64, TRANS>(PTT_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PTT_ARGS
}

}  // namespace

// Plain C entry point, loaded with ctypes, with ptt_gmm's arguments
// (grouped_matmul.cu).  It takes dtype 1 (bfloat16) only.  tm is the plan's
// row tile (kernels/grouped_matmul.py: sm90_plan): 128 runs the wide form
// (bm a multiple of 128), 8, 16, 32 or 64 the narrow one (tm divides bm).
// M must be a multiple of bm, C of 32 and O of 64, and the operands 16-byte
// aligned; the Python wrapper checks all of it.  Returns
// cudaErrorInvalidValue for anything else or when a tensor map cannot be
// encoded; otherwise the cudaError_t of the launch (0 = success).
extern "C" int ptt_gmm_sm90(const void* lhs, const void* rhs, const void* tile_groups,
                            const void* rows, const void* scale, void* out, int M, int C,
                            int O, int E, int L, int bm, int tm, int trans, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || C % 32 || O % 64 || M % bm || bm % tm || E <= 0 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* tg = tile_groups;
  if (tm == kWideRows) {
    const bool gather = rows != nullptr || scale != nullptr;
#define PTT_ARGS gather, lhs, rhs, tg, rows, scale, out, M, C, O, E, L, bm, s
    if (O % 256 == 0)
      return static_cast<int>(trans ? wide_as<256, true>(PTT_ARGS)
                                    : wide_as<256, false>(PTT_ARGS));
    return static_cast<int>(trans ? wide_as<128, true>(PTT_ARGS)
                                  : wide_as<128, false>(PTT_ARGS));
#undef PTT_ARGS
  }
#define PTT_ARGS tm, lhs, rhs, tg, rows, scale, out, M, C, O, E, L, bm, s
  return static_cast<int>(trans ? narrow_as<true>(PTT_ARGS) : narrow_as<false>(PTT_ARGS));
#undef PTT_ARGS
}
