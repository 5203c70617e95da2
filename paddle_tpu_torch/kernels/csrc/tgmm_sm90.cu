// The MoE weight gradient for Hopper (sm_90a), bf16: tgmm on wgmma, fed by
// a TMA / cp.async ring, warp-specialised.
//
// Replaces, in paddle_tpu/kernels/grouped_matmul.py (the Pallas TPU
// kernel), _tgmm_kernel (:334, launched by tgmm :476) for bf16 operands
// (fp32 stays on grouped_matmul.cu's FMA kernel: kernels/grouped_matmul.py:
// _route).  ptt_tgmm_sm90 takes ptt_tgmm's arguments and computes what the
// plain _tgmm_reference computes, the per-expert weight gradient
//
//   out[e] = sum over the rows m of e's tiles of
//            lhs[lrows[m], :]^T (x) s[m] * rhs[rrows[m], :]        [K, N]
//
// (lrows / rrows null read row m; s null is 1, else s[m] multiplies the
// gathered rhs row in bf16, as the plain version rounds it), accumulated in
// fp32, out bf16; an expert that owns no tile gets an exact zero block.
//
// What bounds it on this card: operations.  At the Mixtral training shape
// (M 20480 padded rows, 16384 of them live; K x N 4096 x 14336 for dw_gate
// and dw_up, 14336 x 4096 for dw_down) the live rows' 2 x 16384 x 4096 x
// 14336 flops take 1.946 ms at 989 TFLOP/s (2.43 ms on all M rows); the
// bytes (each operand's live rows once if neighbouring CTAs share them
// through L2, the 940 MB output once) about 0.46 ms at 3.35 TB/s.
//
// What the design does about it:
// - Grid and walk.  One CTA per (expert, 128 K rows, BN N columns), BN 256
//   where N allows, else 128.  The reduction over the expert's rows is the
//   CTA's own loop in k-steps of 64 rows: no split over rows, no atomics, so
//   two runs give the same bits.  Each CTA finds every expert's span from
//   tile_groups on the device (a parallel scan, nothing read back to the
//   host) and ranks the experts by rows, heaviest first, so the long CTAs
//   start first; inside an expert the CTAs go in raster groups of kGroupK
//   K tiles, N tiles outer, so the CTAs running together walk the same
//   rows and share them through L2.
// - Roles.  A producer warpgroup (setmaxnreg 64) and two consumer
//   warpgroups (216), each owning 64 K rows x BN and running m64nBNk16 SS
//   wgmma with fp32 accumulators, over a 4-stage ring with full/empty
//   mbarriers: a stage is 64 rows x 128 lhs columns (16 KB) and 64 rows x
//   BN rhs columns (32 KB at BN 256).  Both operands are MN-major (the rows
//   are the reduction; K or N is contiguous): A is lhs^T with tnsp-a 1, B
//   is rhs with tnsp-b 1, read from TMA's 128-byte swizzle.
// - Loads, two routes.  Where bm % 64 == 0 every span starts and ends on
//   a k-step, so both operands come by TMA, 64 x 64 boxes; a gathered
//   operand (and the scaled rhs) is first made contiguous by a gather pass,
//   tgmm_gather_rows_kernel (ptt_gather_rows: 16-byte chunks, bytes-bound,
//   about 0.1 ms at the Mixtral shape; the wrapper allocates its [M, W]
//   output).
//   Gathering inside the kernel instead, by cp.async into the swizzle, is
//   slower there, and so is that path over contiguous rows: the copies,
//   not the scattered rows, cost (chip_smoke.py kernel_tgmm times both,
//   in_kernel_gather_ms beside kernel_ms).  Where bm % 64 != 0
//   a step can straddle two experts, so both operands come row by row by
//   cp.async from all 128 producer threads, straight into the swizzle, rows
//   past the span zero-filled, the gather in the kernel: each thread reads
//   its 4 rows' indices once for all the column blocks and arrives on the
//   stage's full barrier through cp.async.mbarrier.arrive.noinc, which
//   fires when its copies have landed (no producer thread waits for its
//   own copies).  The step's 64 rhs_scale values come into the stage the
//   same way; the consumers, each on half the rows, multiply the rhs tile
//   by them in place in bf16 while the previous step's products run, fence
//   the proxy and meet at a named barrier before their own products.
// - Padding is skipped on the cp.async route.  A k-step whose rows of the
//   gathered operand all read one row that is zero in this CTA's columns
//   (the callers' zero sentinel: padding_tile's rule,
//   grouped_matmul_sm90.cu) adds exactly nothing: it gets no copy and no
//   product.  The producer decides each step before its copies (the row
//   indices loaded 4 steps at a time, a chunk ahead, into shared memory;
//   the zero row checked once and remembered) and hands only live steps to
//   the ring; each stage carries a header, and a stage whose header is 0
//   ends the consumers' loop.  On the TMA
//   route the padding rows are the gather pass's zeros and are computed.
// - Epilogue.  fp32 -> bf16 through shared memory (the ring, once both
//   consumers are done with it), then 16-byte stores; a K or N tail past the
//   tensor was loaded as zeros and is not stored.  A CTA whose expert owns
//   no row writes zeros without a product.
// Later work (not here): a persistent grid, and an epilogue that overlaps
// the next tile's loads.

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

constexpr int kStep = 64;               // rows of one k-step (the reduction)
constexpr int kTileK = 128;             // K rows of a CTA, 64 a consumer
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kGroupK = 8;              // K tiles a raster group walks
constexpr int kAhead = 4;               // steps of row indices the producer loads at once
constexpr int kMaxExperts = 256;
constexpr uint32_t kBlock = kStep * kRowBytes;   // 64 rows x 64 columns: 8 KB
constexpr int kProducerRegs = 64, kConsumerRegs = 216;
constexpr int kRegsNeeded = kProducerRegs * 128 + kConsumerRegs * 256;   // setmaxnreg
constexpr int kProducerBar = 2;         // named barriers: the producer's steps,
constexpr int kConsumerBar = 3;         // both consumers, each consumer (4, 5)

template <int BN>
struct Smem {
  static constexpr uint32_t a = (kTileK / 64) * kBlock;    // lhs: 16 KB
  static constexpr uint32_t b = (BN / 64) * kBlock;        // rhs: 16 or 32 KB
  static constexpr uint32_t stage = a + b;
  static constexpr uint32_t off_src = kStages * stage;     // int32 [2][kAhead][128]
  static constexpr uint32_t off_scl = off_src + 2 * kAhead * 128 * 4;   // bf16 [kStages][64]
  static constexpr uint32_t off_hdr = off_scl + kStages * 64 * 2;   // int32 [kStages]
  static constexpr uint32_t off_first = off_hdr + kStages * 4;      // int32 [E + 1]
  static constexpr uint32_t off_bar = off_first + (kMaxExperts + 1) * 4 + 4;
  static constexpr uint32_t bytes = off_bar + 2 * kStages * 8 + 1024;   // + alignment
  static constexpr int pitch = BN + 8;                     // epilogue row, bf16
  static_assert(off_bar % 8 == 0, "mbarriers are 8-byte aligned");
  static_assert(2 * 64 * pitch * 2 <= kStages * stage, "epilogue fits the ring");
  static_assert(bytes <= 232448, "stages exceed shared memory");
};

__device__ __forceinline__ int clamp_row(int r, int L) { return min(max(r, 0), L - 1); }

// The producer's share of one k-step of a cp.async operand: 64 rows x
// BLOCKS 64-column blocks from col0 of a [*, W] bf16 operand, row r read
// from x[src[r]] (src[r] < 0: a row past the span, zeros), chunk by chunk
// into the swizzled tile at dst (block j at dst + j x 8 KB); columns past W
// are zeros.  Thread t copies chunk t % 8 of rows t / 8 + 16 i, so it reads
// each of its 4 rows' index once for all the blocks.
template <int BLOCKS>
__device__ __forceinline__ void issue_rows(unsigned char* dst, const bf16* x,
                                           const int32_t* src, int col0, int W, int t) {
  const int c = t & 7;
#pragma unroll 1
  for (int r = t >> 3; r < kStep; r += 16) {
    const int row = src[r];
    const bf16* g = x + (int64_t)max(row, 0) * W + col0 + c * 8;
#pragma unroll
    for (int j = 0; j < BLOCKS; ++j) {
      const bool ok = row >= 0 && col0 + 64 * j + c * 8 < W;
      cp_async16(dst + j * kBlock + swz(r, c), ok ? g + 64 * j : x, ok ? 16u : 0u);
    }
  }
}

// rhs_scale on consumer w's half of a step's rhs tile, rows 32 w .. 32 w
// + 31 of every block, in bf16 (scl[r] multiplies row r): thread t scales
// chunk t % 8 of rows 32 w + t / 8 and 32 w + t / 8 + 16
template <int BLOCKS>
__device__ __forceinline__ void scale_half(unsigned char* dst, const bf16* scl, int w, int t) {
  const int c = t & 7;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 32 * w + (t >> 3) + 16 * h;
    const bf16 s = scl[r];
#pragma unroll
    for (int j = 0; j < BLOCKS; ++j) {
      uint4* q = reinterpret_cast<uint4*>(dst + j * kBlock + swz(r, c));
      *q = scale8(*q, s);
    }
  }
}

// zeros into out[k0 .. k0 + 128, n0 .. n0 + BN) of one expert, clipped to
// [K, N)
template <int BN>
__device__ void store_zero_tile(bf16* out, int k0, int n0, int K, int N) {
  constexpr int chunks = BN / 8;
  for (int i = threadIdx.x; i < kTileK * chunks; i += kThreads) {
    const int r = k0 + i / chunks, c = n0 + (i % chunks) * 8;
    if (r < K && c < N)
      *reinterpret_cast<uint4*>(out + (int64_t)r * N + c) = make_uint4(0, 0, 0, 0);
  }
}

template <int BN, bool CP>
__global__ void __launch_bounds__(kThreads, 1)
tgmm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b, const bf16* __restrict__ lhs,
                 const bf16* __restrict__ rhs, const int32_t* __restrict__ tile_groups,
                 const int32_t* __restrict__ lrows, const int32_t* __restrict__ rrows,
                 const bf16* __restrict__ rscale, bf16* __restrict__ out, int K, int N, int E,
                 int Ll, int Lr, int bm, int T) {
  using S = Smem<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int32_t* src_s = reinterpret_cast<int32_t*>(smem + S::off_src);
  bf16* scl_s = reinterpret_cast<bf16*>(smem + S::off_scl);
  volatile int32_t* hdr = reinterpret_cast<volatile int32_t*>(smem + S::off_hdr);
  int32_t* first_s = reinterpret_cast<int32_t*>(smem + S::off_first);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::off_bar);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducerThreads + 1);   // + the header's arrive
      mbar_init(&empty[s], 8);                 // the consumers' warps
    }
    fence_barrier_init();
  }
  // every expert's first tile (tile_groups nondecreasing, clamped to
  // [0, E)); first_s[E] = T
  for (int t = tid; t < T; t += kThreads) {
    const int g = min(max(tile_groups[t], 0), E - 1);
    const int gp = t > 0 ? min(max(tile_groups[t - 1], 0), E - 1) : -1;
    for (int e = gp + 1; e <= g; ++e) first_s[e] = t;
    if (t == T - 1)
      for (int e = g + 1; e <= E; ++e) first_s[e] = T;
  }
  __syncthreads();
  // this CTA's expert: rank blockIdx.x / per_expert of the experts by rows,
  // heaviest first (ties by id)
  const int n_kt = (K + kTileK - 1) / kTileK, n_nt = (N + BN - 1) / BN;
  const int per_expert = n_kt * n_nt;
  const int rank = blockIdx.x / per_expert;
  __shared__ int expert_s;
  for (int e = tid; e < E; e += kThreads) {
    const int size = first_s[e + 1] - first_s[e];
    int r = 0;
    for (int f = 0; f < E; ++f) {
      const int sf = first_s[f + 1] - first_s[f];
      r += sf > size || (sf == size && f < e);
    }
    if (r == rank) expert_s = e;
  }
  __syncthreads();
  const int e = expert_s;
  const int r0 = first_s[e] * bm, r1 = first_s[e + 1] * bm;
  const int within = blockIdx.x % per_expert;
  const int per_group = kGroupK * n_nt, group = within / per_group;
  const int g_k = min(kGroupK, n_kt - group * kGroupK), in = within % per_group;
  const int k0 = (group * kGroupK + in % g_k) * kTileK, n0 = (in / g_k) * BN;
  bf16* o = out + (int64_t)e * K * N;

  if (r0 == r1) {                          // an expert with no row
    store_zero_tile<BN>(o, k0, n0, K, N);
    return;
  }
  const int nsteps = (r1 - r0 + kStep - 1) / kStep;

  if (warpgroup_idx() == 0) {              // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    const int t = tid;
    // the operand whose gather decides padding steps: lhs's, else rhs's
    const int32_t* check = lrows ? lrows : rrows;
    if (!CP && t == 0) {
      tma_prefetch_map(&tm_a);
      tma_prefetch_map(&tm_b);
    }
    // thread t indexes row t % 64 of each step, of lhs (t < 64) or of rhs;
    // the indices come kAhead steps at a time into a ring of two chunks in
    // shared memory (src_s [2][kAhead][128]), the next chunk loaded into
    // registers a chunk before it is needed, so no step waits on a load
    const int side = t >> 6, p = t & 63;
    const int32_t* rows = side ? rrows : lrows;
    const int L = side ? Lr : Ll;
    const int check_side = lrows ? 0 : 1;
    auto load_idx = [&](int i) {           // -1: past the span (or the steps)
      const int m = r0 + i * kStep + p;
      return i < nsteps && m < r1 ? (rows ? clamp_row(rows[m], L) : m) : -1;
    };
    int nxt[kAhead];
    if (CP) {
#pragma unroll
      for (int q = 0; q < kAhead; ++q) src_s[q * 128 + t] = load_idx(q);
#pragma unroll
      for (int q = 0; q < kAhead; ++q) nxt[q] = load_idx(kAhead + q);
      bar_sync(kProducerBar, kProducerThreads);
    }
    int live_n = 0, zero_row = -1;
    for (int i = 0; i < nsteps; ++i) {
      const int32_t* src = src_s + (((i / kAhead) & 1) * kAhead + i % kAhead) * 128;
      bool live = true;
      if (CP) {
        if (i % kAhead == kAhead - 1) {    // the next chunk in, the one after loading
          int32_t* next = src_s + (((i / kAhead + 1) & 1) * kAhead) * 128;
#pragma unroll
          for (int q = 0; q < kAhead; ++q) next[q * 128 + t] = nxt[q];
#pragma unroll
          for (int q = 0; q < kAhead; ++q) nxt[q] = load_idx((i / kAhead + 2) * kAhead + q);
        }
        const int idx = src[t], v = src[check_side * 64];
        const bool same = side != check_side || idx < 0 || idx == v;
        const bool uniform = bar_and(kProducerBar, kProducerThreads, same);
        if (check && uniform) {
          if (v != zero_row) {             // is row v zero in this CTA's columns?
            const bool on_lhs = check == lrows;
            const int c0 = on_lhs ? k0 : n0, W = on_lhs ? K : N;
            const int c = c0 + 8 * t;
            bool z = true;
            if (t < (on_lhs ? kTileK : BN) / 8 && c < W)
              z = zero8(__ldg(reinterpret_cast<const uint4*>((on_lhs ? lhs : rhs) +
                                                              (int64_t)v * W + c)));
            if (bar_and(kProducerBar, kProducerThreads, z)) zero_row = v;
          }
          live = v != zero_row;
        }
      }
      if (!live) continue;
      const int s = live_n % kStages, m0 = r0 + i * kStep;
      unsigned char* a_s = smem + s * S::stage;
      unsigned char* b_s = a_s + S::a;
      mbar_wait(&empty[s], ((live_n / kStages) & 1) ^ 1);
      if (CP) {
        issue_rows<kTileK / 64>(a_s, lhs, src, k0, K, t);
        issue_rows<BN / 64>(b_s, rhs, src + 64, n0, N, t);
      }
      if (rscale && t < 8) {               // the step's 64 scales, past the span 0
        const int m = m0 + 8 * t, n = min(max(r1 - m, 0), 8);
        cp_async16(scl_s + s * 64 + 8 * t, rscale + (n ? m : 0), 2 * n);
      }
      // each thread's copies arrive on the stage's barrier when they land
      cp_async_mbar_arrive(&full[s]);
      if (t == 0) {                        // the header, then the TMA tiles
        hdr[s] = 1;
        mbar_arrive_expect_tx(&full[s], CP ? 0 : S::stage);
        if (!CP) {
#pragma unroll
          for (int j = 0; j < kTileK / 64; ++j)
            tma_load_2d(a_s + j * kBlock, &tm_a, &full[s], k0 + 64 * j, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(b_s + j * kBlock, &tm_b, &full[s], n0 + 64 * j, m0);
        }
      }
      ++live_n;
    }
    // the end of the steps: a stage with header 0 and no copies
    const int s = live_n % kStages;
    mbar_wait(&empty[s], ((live_n / kStages) & 1) ^ 1);
    if (t == 0) {
      hdr[s] = 0;
      mbar_arrive(&full[s]);
    }
    mbar_arrive(&full[s]);
  } else {                                 // ---- consumers: K rows k0 + 64 w ..
    setmaxnreg_inc<kConsumerRegs>();
    const int w = warpgroup_idx() - 1, t = tid % 128;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int j = 0;; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      if (hdr[s] == 0) break;
      unsigned char* a_s = smem + s * S::stage;
      if (CP && rscale) {
        // rhs_scale in place, each consumer on half the rows, while the
        // previous step's products run; then both halves before the products
        scale_half<BN / 64>(a_s + S::a, scl_s + s * 64, w, t);
        fence_proxy_async();
        bar_sync(kConsumerBar, 256);
      } else if (CP) {
        fence_proxy_async();               // the copies (generic proxy) before wgmma reads
      }
      // lhs^T and rhs, both MN-major: each 16 rows of the step 2 KB on
      const uint64_t da = desc_sw128(a_s + w * kBlock, kBlock, 1024);
      const uint64_t db = desc_sw128(a_s + S::a, kBlock, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
        WgmmaSS<BN, 1, 1>::mma(acc, desc_advance(da, kk * 16 * kRowBytes),
                               desc_advance(db, kk * 16 * kRowBytes));
      wgmma_commit();
      wgmma_wait<1>();                     // the previous step's products are done
      if (j > 0 && (t & 31) == 0) mbar_arrive(&empty[(j - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // both consumers are done with the ring: stage the tile there as bf16
    // [64 rows][BN + 8] (the 16-byte pad spreads the fragment's rows over
    // the banks), then 16-byte stores
    bar_sync(kConsumerBar, 256);
    bf16* st = reinterpret_cast<bf16*>(smem) + w * 64 * S::pitch;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(st + frag_row(t, i) * S::pitch + frag_col(t, i)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    bar_sync(kConsumerBar + 1 + w, 128);
    constexpr int chunks = BN / 8;
    for (int q = t; q < 64 * chunks; q += 128) {
      const int r = q / chunks, c8 = (q % chunks) * 8;
      const int kr = k0 + 64 * w + r, col = n0 + c8;
      if (kr < K && col < N)
        *reinterpret_cast<uint4*>(o + (int64_t)kr * N + col) =
            *reinterpret_cast<const uint4*>(st + r * S::pitch + c8);
    }
  }
}

// ------------------------------------------------------------ gather pass ---

// out[m, :] = x[rows[m], :] (row m when rows is null), times s[m] in bf16
// when s is given: the rows a gathered (or scaled) operand of tgmm's TMA
// route reads, made contiguous.  A grid-stride pass of 16-byte chunks;
// bytes-bound.
constexpr int kGatherThreads = 256;

__global__ void __launch_bounds__(kGatherThreads)
tgmm_gather_rows_kernel(const bf16* __restrict__ x, const int32_t* __restrict__ rows,
                   const bf16* __restrict__ scale, bf16* __restrict__ out, int M, int W,
                   int L) {
  const int chunks = W / 8;
  const int64_t n = (int64_t)M * chunks;
  for (int64_t i = (int64_t)blockIdx.x * kGatherThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kGatherThreads) {
    const int m = static_cast<int>(i / chunks), c = static_cast<int>(i % chunks);
    const int64_t r = rows ? clamp_row(rows[m], L) : m;
    uint4 v = __ldg(reinterpret_cast<const uint4*>(x + r * W) + c);
    if (scale) v = scale8(v, scale[m]);
    reinterpret_cast<uint4*>(out + (int64_t)m * W)[c] = v;
  }
}

// ---------------------------------------------------------------- launch ---

// A bf16 [rows, cols] operand as a 2-D map of 64 x 64 boxes
bool encode_rows(CUtensorMap* map, const void* base, int rows, int cols) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, (uint32_t)kStep};
  return encode_bf16(map, base, 2, dims, strides, box);
}

template <int BN, bool CP>
cudaError_t launch(const void* lhs, const void* rhs, const void* tg, const void* lrows,
                   const void* rrows, const void* rscale, void* out, int K, int N, int E,
                   int Ll, int Lr, int bm, int T, cudaStream_t s) {
  CUtensorMap ta{}, tb{};               // maps only for the TMA route
  if (!CP && (!encode_rows(&ta, lhs, Ll, K) || !encode_rows(&tb, rhs, Lr, N)))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = Smem<BN>::bytes;
  const cudaError_t e = prepare_warp_specialized<tgmm_sm90_kernel<BN, CP>>(
      bytes, kThreads, kRegsNeeded);
  if (e != cudaSuccess) return e;
  const int grid = E * ((K + kTileK - 1) / kTileK) * ((N + BN - 1) / BN);
  tgmm_sm90_kernel<BN, CP><<<grid, kThreads, bytes, s>>>(
      ta, tb, static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(lrows),
      static_cast<const int32_t*>(rrows), static_cast<const bf16*>(rscale),
      static_cast<bf16*>(out), K, N, E, Ll, Lr, bm, T);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes, with ptt_tgmm's arguments
// (grouped_matmul.cu).  It takes dtype 1 (bfloat16) only.  out [E, K, N];
// lhs [Ll, K] and rhs [Lr, N], read at lrows[m] / rrows[m] (or row m when
// null) for m < M; rscale [M] or null; M = T x bm.  Both operands go as
// TMA tiles where 64 divides bm and neither rows nor a scale are given,
// else by cp.async, gathered and scaled in the kernel (the Python wrapper
// hands the TMA route contiguous operands from ptt_gather_rows).  K and N
// must be multiples of 64, bm of 8 (a step's 8-row runs of scales are
// 16-byte copies), E at most 256, and the operands 16-byte aligned; the
// Python wrapper checks all of it.  Returns cudaErrorInvalidValue for
// anything else or when a tensor map cannot be encoded; otherwise the
// cudaError_t of the launch (0 = success).
extern "C" int ptt_tgmm_sm90(const void* lhs, const void* rhs, const void* tile_groups,
                             const void* lrows, const void* rrows, const void* rscale,
                             void* out, int M, int K, int N, int E, int Ll, int Lr, int bm,
                             int T, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || K <= 0 || N <= 0 || K % 64 || N % 64 || E <= 0 || E > kMaxExperts ||
      bm <= 0 || bm % 8 || T <= 0 || M != T * bm || Ll <= 0 || Lr <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA only where every span starts and ends on a k-step
  // TMA tiles only where every span starts and ends on a k-step
  const bool cp = bm % kStep != 0 || lrows || rrows || rscale;
  const void* tg = tile_groups;
#define PTT_ARGS lhs, rhs, tg, lrows, rrows, rscale, out, K, N, E, Ll, Lr, bm, T, s
  cudaError_t e;
  if (N % 256 == 0)
    e = cp ? launch<256, true>(PTT_ARGS) : launch<256, false>(PTT_ARGS);
  else
    e = cp ? launch<128, true>(PTT_ARGS) : launch<128, false>(PTT_ARGS);
#undef PTT_ARGS
  return static_cast<int>(e);
}

// ptt_gather_rows: out [M, W] = x [L, W] at rows[m] (row m when null),
// each row times scale[m] in bf16 when scale is not null; bf16, W a multiple
// of 8, the operands 16-byte aligned (the Python wrapper checks it).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a bad shape).
extern "C" int ptt_gather_rows(const void* x, const void* rows, const void* scale, void* out,
                               int M, int W, int L, void* stream) {
  if (M <= 0 || W <= 0 || W % 8 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (int64_t)M * (W / 8);
  const int grid = static_cast<int>(
      chunks / kGatherThreads + 1 < 132 * 8 ? chunks / kGatherThreads + 1 : 132 * 8);
  tgmm_gather_rows_kernel<<<grid, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int32_t*>(rows),
      static_cast<const bf16*>(scale), static_cast<bf16*>(out), M, W, L);
  return static_cast<int>(cudaGetLastError());
}
