// Ragged paged attention for Hopper (sm_90a), the serving hot op.
//
// Replaces: paddle_tpu/kernels/paged_attention.py:_ragged_paged_attn_kernel
// (the Pallas TPU kernel, float mode and quantized=True), launched there by
// _pallas_ragged_paged_attention.  It computes exactly what the plain
// _reference_ragged_paged_attention computes: for each sequence b, each
// query token t < T and each query head, softmax attention over
//   (1) the sequence's cached context, context_lens[b] tokens held in pages
//       of a paged KV pool [kv_heads, num_pages, page_size, head_dim] and
//       addressed through block_tables[b, :], then
//   (2) this step's own fresh rows k_new/v_new [B, T, kv_heads, head_dim],
//       where token i attends fresh token j only if j <= i and j < q_lens[b].
// Outputs out [B, T, q_heads, head_dim] in q's dtype and lse [B, T, q_heads]
// in fp32.  Scale is 1/sqrt(head_dim); all softmax math is fp32.
//
// Two dtypes, chosen apart: q / fresh rows / out (fp32 or bf16) and the
// pool (fp32, bf16 or int8).  An int8 pool carries one fp32 scale per
// (kv-head, page) (k_scale/v_scale [kv_heads, num_pages]); each staged
// key and value row is dequantized as it is loaded (int8 * scale, fp32),
// and everything after that is the float mode unchanged.  The TPU's
// page_size % 32 rule for int8 (sublane packing) does not apply here: any
// multiple of 8 up to 128 works in every mode.
//
// What bounds it on this card: bytes.  Decode reads every live K/V row of
// the context once per kv-head and does 4 flops per K/V element pair, far
// below the ~295 flops/byte an H100 needs to be compute bound; the least
// time is (K/V bytes of the live context) / 3.35 TB/s: at llama2_7b decode
// (B 8, 32 kv-heads, context 512, bf16) 67 MB, 0.0201 ms.  The int8 pool
// halves those bytes against bf16 (plus 4 bytes of scale per page).
//
// Two routes, one rule (kernels/paged_attention.py:_route, on the query
// rows a kv-head carries, R = T * group):
//
// "split" (R <= 16: decode at every GQA group, speculative verify) --
// ragged_paged_attn_split_kernel and ragged_paged_attn_merge_kernel, C
// entry point ptt_ragged_paged_attention_split:
// - Grid (split, kv-head, sequence), 4 warps; the split count comes from
//   the shapes alone (paged_attention.py:split_plan: about 2 x 132 CTAs),
//   and split s of S takes pages [n s / S, n (s + 1) / S) of the n live
//   pages of context_lens[b], read here on the device.  The split's
//   block-table entries are read once into shared memory.
// - The group's R query rows live in shared memory, pre-scaled, fp32.
// - The split's keys go in blocks of 8 rows, each inside one page (pages
//   hold multiples of 8 rows), block u to warp u % 4.  Each warp streams
//   its blocks through its own ring of kStages stages: lane 0 issues one
//   bulk copy (TMA, 1-D) for a block's K rows and one for its V rows,
//   completing on the stage's mbarrier, kStages blocks in flight; no
//   barrier spans the CTA while the context streams.  An int8 block is
//   dequantized in registers with its page's two scales.
// - Each warp keeps its own online softmax (m from -1e30, l, acc) for
//   every row: a group of D / 8 lanes holds a key, 8 elements a lane,
//   partial dots reduced by shuffles; P V with each lane owning D / 32
//   columns and p broadcast from its key's group.  Rows of a block past
//   the context are never used (-inf scores, zero values by a select), so
//   no key branches; loads come before arithmetic in every step.
// - The last split folds in this step's fresh rows (causal within the
//   step: token t sees fresh row j <= t with j < q_lens[b]; masked keys at
//   -1e30, the TPU kernel's mask value).
// - The four warps' states merge by lse weights (the one barrier); one
//   split writes out (q's dtype) and lse (fp32) with l clamped to 1e-30,
//   as the TPU kernel does, so rows past q_lens stay finite; more splits
//   write partials
//   (m = -inf for a split with no key) to a workspace, and the merge
//   kernel combines them in split order.  No atomics: two runs give the
//   same bits.
//
// "tile" (R > 16: prefill chunks) -- ragged_paged_attn_kernel, C entry
// point ptt_ragged_paged_attention, the first design (simple first):
// - One thread block per (row tile, kv-head, sequence).  Query row
//   r = t * group + g holds every query head of the GQA group of this
//   kv-head, so each K/V row is read from device memory once per row tile,
//   not once per query head.
// - The block walks only the live context: positions < context_lens[b],
//   i.e. ceil(context_lens[b] / page_size) block-table entries and no more.
//   Table entries past the context are never read; entries inside it are
//   clamped to valid page ids before they are dereferenced.
// - Keys are staged TK at a time in shared memory (fp32), independent of
//   page_size; one warp owns RPW query rows and keeps each row's running
//   max, sum and accumulator (head_dim / 32 values per lane) in fp32
//   registers (online softmax).
// - The step's fresh rows are folded in last, under the causal mask.
// - Rows past q_lens[b] and idle rows come out finite: the final sum is
//   clamped to 1e-30, as the TPU kernel does.
// Later work (not here): wgmma tiles for prefill (the GQA group's query
// rows as M, pages through a TMA ring).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kTK = 32;        // keys staged per tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRPW = 4;        // query rows per warp
constexpr int kRows = kWarps * kRPW;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// T: q / fresh rows / out; KV: the pool (float, bf16 or int8 with scales)
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attn_kernel(const T* __restrict__ q, const KV* __restrict__ k_cache,
                         const KV* __restrict__ v_cache,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int32_t* __restrict__ block_tables,
                         const int32_t* __restrict__ context_lens,
                         const int32_t* __restrict__ q_lens,
                         const T* __restrict__ k_new, const T* __restrict__ v_new,
                         T* __restrict__ out, float* __restrict__ lse,
                         int T_, int qh, int kvh, int num_pages, int page_size,
                         int W, float scale) {
  constexpr int C = D / 32;          // accumulator values per lane per row
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = qh / kvh;
  const int R = T_ * group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  __shared__ float q_s[kRows][D];
  __shared__ float k_s[kTK][D + 1];   // +1: lanes read distinct keys, no bank conflicts
  __shared__ float v_s[kTK][D];
  __shared__ int64_t row_off[kTK];    // element offset of each staged key row
  __shared__ float k_sc[kTK], v_sc[kTK];  // dequant scale of each staged row
  constexpr bool kQuant = sizeof(KV) == 1;

  // this block's query rows, pre-scaled; rows past R are zero
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int rl = i / D, e = i % D;
    const int r = tile * kRows + rl;
    float val = 0.f;
    if (r < R) {
      const int t = r / group, g = r % group;
      val = to_f(q[(((int64_t)b * T_ + t) * qh + h * group + g) * D + e]) * scale;
    }
    q_s[rl][e] = val;
  }

  int ctx = context_lens[b];
  ctx = max(0, min(ctx, W * page_size));     // the reference masks within W pages
  const int ql = q_lens ? q_lens[b] : T_;

  float m[kRPW], l[kRPW], acc[kRPW][C];
#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  // One online-softmax update of every row this warp owns over the staged
  // tile of n keys.  fresh == true applies the intra-step causal mask.
  auto update = [&](int base, int n, bool fresh) {
#pragma unroll
    for (int i = 0; i < kRPW; ++i) {
      const int rl = warp * kRPW + i;
      const int r = tile * kRows + rl;
      if (r >= R) continue;                    // warp-uniform
      float s = -INFINITY;                     // lanes past n: no key at all
      if (lane < n) {
        float dot = 0.f;
#pragma unroll 8
        for (int e = 0; e < D; ++e) dot += q_s[rl][e] * k_s[lane][e];
        bool valid = true;
        if (fresh) {
          const int j = base + lane, ti = r / group;
          valid = (j <= ti) && (j < ql);
        }
        s = valid ? dot : kNegInf;
      }
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
      for (int kk = 0; kk < n; ++kk) {
        const float pk = __shfl_sync(0xffffffffu, p, kk);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] += pk * v_s[kk][lane + 32 * c];
      }
      m[i] = m_new;
    }
  };

  // (1) the cached context, page by page through the block table
  for (int base = 0; base < ctx; base += kTK) {
    const int n = min(kTK, ctx - base);
    __syncthreads();                           // previous tile fully consumed
    if (threadIdx.x < n) {
      const int p = base + threadIdx.x;
      int page = block_tables[(int64_t)b * W + p / page_size];
      page = min(max(page, 0), num_pages - 1);
      row_off[threadIdx.x] =
          (((int64_t)h * num_pages + page) * page_size + p % page_size) * D;
      if constexpr (kQuant) {
        k_sc[threadIdx.x] = k_scale[(int64_t)h * num_pages + page];
        v_sc[threadIdx.x] = v_scale[(int64_t)h * num_pages + page];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int kk = i / D, e = i % D;
      const int64_t off = row_off[kk] + e;
      if constexpr (kQuant) {
        k_s[kk][e] = to_f(k_cache[off]) * k_sc[kk];
        v_s[kk][e] = to_f(v_cache[off]) * v_sc[kk];
      } else {
        k_s[kk][e] = to_f(k_cache[off]);
        v_s[kk][e] = to_f(v_cache[off]);
      }
    }
    __syncthreads();
    update(base, n, false);
  }

  // (2) this step's fresh rows, causal within the step
  if (k_new != nullptr) {
    for (int base = 0; base < T_; base += kTK) {
      const int n = min(kTK, T_ - base);
      __syncthreads();
      for (int i = threadIdx.x; i < n * D; i += kThreads) {
        const int kk = i / D, e = i % D;
        const int64_t off = (((int64_t)b * T_ + base + kk) * kvh + h) * D + e;
        k_s[kk][e] = to_f(k_new[off]);
        v_s[kk][e] = to_f(v_new[off]);
      }
      __syncthreads();
      update(base, n, true);
    }
  }

  // finalize: out = acc / l, lse = m + log(l), with l clamped as the TPU
  // kernel does so idle and past-q_lens rows stay finite
#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    const int r = tile * kRows + warp * kRPW + i;
    if (r >= R) continue;
    const int t = r / group, g = r % group;
    const float lc = fmaxf(l[i], 1e-30f);
    const int64_t row = ((int64_t)b * T_ + t) * qh + h * group + g;
#pragma unroll
    for (int c = 0; c < C; ++c) out[row * D + lane + 32 * c] = from_f<T>(acc[i][c] / lc);
    if (lane == 0) lse[row] = m[i] + logf(lc);
  }
}

template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* ks,
                   const void* vs, const void* bt, const void* cl, const void* ql,
                   const void* kn, const void* vn, void* out, void* lse, int B,
                   int T_, int qh, int kvh, int num_pages, int page_size, int W,
                   cudaStream_t stream) {
  const int R = T_ * (qh / kvh);
  dim3 grid((R + kRows - 1) / kRows, kvh, B);
  ragged_paged_attn_kernel<T, KV, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kc), static_cast<const KV*>(vc),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int32_t*>(bt), static_cast<const int32_t*>(cl),
      static_cast<const int32_t*>(ql), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(out), static_cast<float*>(lse),
      T_, qh, kvh, num_pages, page_size, W, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch_d(int head_dim, const void* q, const void* kc, const void* vc,
                     const void* ks, const void* vs, const void* bt, const void* cl,
                     const void* ql, const void* kn, const void* vn, void* out,
                     void* lse, int B, int T_, int qh, int kvh, int num_pages,
                     int page_size, int W, cudaStream_t s) {
#define PTT_ARGS q, kc, vc, ks, vs, bt, cl, ql, kn, vn, out, lse, B, T_, qh, kvh, \
                 num_pages, page_size, W, s
  if (head_dim == 64) return launch<T, KV, 64>(PTT_ARGS);
  if (head_dim == 128) return launch<T, KV, 128>(PTT_ARGS);
#undef PTT_ARGS
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_kv(int kv_dtype, int head_dim, const void* q, const void* kc,
                      const void* vc, const void* ks, const void* vs, const void* bt,
                      const void* cl, const void* ql, const void* kn, const void* vn,
                      void* out, void* lse, int B, int T_, int qh, int kvh,
                      int num_pages, int page_size, int W, cudaStream_t s) {
#define PTT_ARGS head_dim, q, kc, vc, ks, vs, bt, cl, ql, kn, vn, out, lse, B, T_, \
                 qh, kvh, num_pages, page_size, W, s
  if (kv_dtype == 0) return launch_d<T, float>(PTT_ARGS);
  if (kv_dtype == 1) return launch_d<T, __nv_bfloat16>(PTT_ARGS);
  if (kv_dtype == 2) return launch_d<T, int8_t>(PTT_ARGS);
#undef PTT_ARGS
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------ the split route ---

constexpr int kSplitRows = 16;      // R = T * group query rows at most
constexpr int kWarpKeys = 8;        // keys a warp's block: within one page (page % 8 == 0)
constexpr int kStages = 4;          // a warp's ring of key blocks
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kTable = 256;         // block-table entries a split keeps in shared memory

// N consecutive elements (N 2, 4 or 8) of a row in shared memory as fp32,
// in one load (two for 8 fp32); bf16 and int8 are unpacked from the loaded
// words with shifts (exact), so nothing goes through local memory
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&x)[N]) {
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x;
    x[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      x[i] = a.x;
      x[i + 1] = a.y;
      x[i + 2] = a.z;
      x[i + 3] = a.w;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float (&x)[N]) {
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    x[2 * i] = bf16_lo(w[i]);
    x[2 * i + 1] = bf16_hi(w[i]);
  }
}
template <int N>
__device__ __forceinline__ void load_n(const int8_t* p, float (&x)[N]) {
  uint32_t w[(N + 3) / 4];
  if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = i8_at(w[i / 4], i % 4);
}

// One online-softmax step of a warp over its block of keys: the nk <= 8
// live rows at ks / vs (rows of D elements of E; an int8 block's codes
// times the page's scales ksc / vsc), for each of the R query rows, into the
// warp's own (m, l, acc).  Scores: a group of D / 8 lanes holds a key, 8
// elements a lane, and reduces its partial dots by shuffles; rows past nk
// do not exist (-inf, and their values are never used: shared memory there
// holds whatever an earlier block left); with `fresh` the block's row i is
// this step's fresh row j0 + i, seen by token t only if j0 + i <= t and
// j0 + i < ql (else the mask value).  P V: lane owns D / 32 columns; each
// key's p is broadcast from its group.  Every load of a step is issued
// before its arithmetic, and nothing branches on a key.
template <typename E, int D, int RMAX>
__device__ __forceinline__ void warp_block(const E* ks, const E* vs, float ksc, float vsc,
                                           int nk, int j0, const float* q_s, int R, int group,
                                           bool fresh, int ql, float (&m)[RMAX],
                                           float (&l)[RMAX], float (&acc)[RMAX][D / 32]) {
  constexpr int LPR = D / 8, KPW = 32 / LPR, STEPS = kWarpKeys / KPW, DL = D / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR, e0 = (lane % LPR) * 8;
  float k[STEPS][8];
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    load_n<8>(ks + (st * KPW + sub) * D + e0, k[st]);
#pragma unroll
    for (int i = 0; i < 8; ++i) k[st][i] *= ksc;
  }
  float s[RMAX][STEPS];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < R) {                                       // uniform
      float q[8], dot[STEPS];
      load_n<8>(q_s + r * D + e0, q);
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        dot[st] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot[st] = fmaf(q[i], k[st][i], dot[st]);
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
        for (int st = 0; st < STEPS; ++st)
          dot[st] += __shfl_xor_sync(0xffffffffu, dot[st], o);
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int i = st * KPW + sub, j = j0 + i;
        float x = dot[st];
        if (i >= nk) x = -INFINITY;
        else if (fresh && (j > r / group || j >= ql)) x = kNegInf;
        s[r][st] = x;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < R) {
      float mx = s[r][0];
#pragma unroll
      for (int st = 1; st < STEPS; ++st) mx = fmaxf(mx, s[r][st]);
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float a = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        s[r][st] = expf(s[r][st] - m_new);
        sum += s[r][st];
      }
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = a * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[r][e] *= a;
    }
  }
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    float v[KPW][DL];
#pragma unroll
    for (int kk = 0; kk < KPW; ++kk) {
      const int i = st * KPW + kk;
      load_n<DL>(vs + i * D + lane * DL, v[kk]);
#pragma unroll
      for (int e = 0; e < DL; ++e) v[kk][e] = i < nk ? v[kk][e] * vsc : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
#pragma unroll
        for (int kk = 0; kk < KPW; ++kk) {
          const float p = __shfl_sync(0xffffffffu, s[r][st], kk * LPR);
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[r][e] = fmaf(p, v[kk][e], acc[r][e]);
        }
      }
    }
  }
}

// Shared memory of a split CTA: the group's query rows (fp32, pre-scaled);
// each warp's ring of kStages blocks of kWarpKeys K and V rows in the pool's
// dtype, with its full barriers (after the context the rings hold the
// fresh rows, fp32, and then the warps' accumulators for the combine); the
// split's block-table entries and, for an int8 pool, their pages' scales;
// the warps' (m, l).
template <typename KV, int D>
struct SplitSmem {
  static constexpr uint32_t row = D * sizeof(KV);
  static constexpr uint32_t block = kWarpKeys * row;                // K or V of a block
  static constexpr uint32_t stage = 2 * block;
  static constexpr uint32_t off_ring = kSplitRows * D * 4;
  static constexpr uint32_t ring = kSplitWarps * kStages * stage;
  static constexpr uint32_t off_bar = off_ring + ring;              // [warps][kStages]
  static constexpr uint32_t off_bt = off_bar + kSplitWarps * kStages * 8;   // int [kTable]
  static constexpr uint32_t off_sc = off_bt + kTable * 4;           // float [2][kTable]
  static constexpr uint32_t off_ml = off_sc + 2 * kTable * 4;       // [warps][16][2]
  static constexpr uint32_t bytes = off_ml + kSplitWarps * kSplitRows * 2 * 4;
  static_assert(ring >= 2u * kSplitRows * D * 4, "fresh rows must fit the rings");
  static_assert(ring >= 1u * kSplitWarps * kSplitRows * D * 4, "the combine must fit the rings");
};

// T: q / fresh rows / out; KV: the pool; RMAX 1, 4 or 16 bounds R.  One CTA
// per (split, kv-head, sequence).  Split sp of S takes pages [n sp / S,
// n (sp + 1) / S) of the sequence's n = ceil(context / page) live pages
// (read here, on the device), and the last split also the step's fresh
// rows.  The split's keys go in blocks of 8 (one page each: pages hold
// multiples of 8 rows and splits start on a page), block u to warp u % 4;
// each warp streams its blocks through its own ring (lane 0 issues one
// bulk copy for a block's K rows and one for its V rows, completing on the
// stage's barrier) and keeps its own online softmax, so no barrier spans
// the CTA until the four warps are combined.  With one split the CTA
// writes out and lse; with more its partial (m, l, acc) goes to ws for the
// merge.
template <typename T, typename KV, int D, int RMAX>
__global__ void __launch_bounds__(kSplitThreads)
ragged_paged_attn_split_kernel(const T* __restrict__ q, const KV* __restrict__ k_cache,
                               const KV* __restrict__ v_cache,
                               const float* __restrict__ k_scale,
                               const float* __restrict__ v_scale,
                               const int32_t* __restrict__ block_tables,
                               const int32_t* __restrict__ context_lens,
                               const int32_t* __restrict__ q_lens,
                               const T* __restrict__ k_new, const T* __restrict__ v_new,
                               T* __restrict__ out, float* __restrict__ lse,
                               float* __restrict__ ws, int T_, int qh, int kvh, int num_pages,
                               int page_size, int W, float scale) {
  using L = SplitSmem<KV, D>;
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int DL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + L::off_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::off_bar);
  int* bt_s = reinterpret_cast<int*>(smem + L::off_bt);
  float* ksc_s = reinterpret_cast<float*>(smem + L::off_sc);
  float* vsc_s = ksc_s + kTable;
  float* ml_s = reinterpret_cast<float*>(smem + L::off_ml);

  const int sp = blockIdx.x, splits = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int group = qh / kvh, R = T_ * group;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int ctx = context_lens[b];
  ctx = max(0, min(ctx, W * page_size));     // the reference masks within W pages
  const int ql = q_lens ? q_lens[b] : T_;
  const int n_pages = (ctx + page_size - 1) / page_size;
  const int p_lo = (int)((int64_t)n_pages * sp / splits);
  const int p_hi = (int)((int64_t)n_pages * (sp + 1) / splits);
  const int k_lo = p_lo * page_size, k_hi = min(ctx, p_hi * page_size);
  const int n_ctx = max(0, k_hi - k_lo);
  const int n_blocks = (n_ctx + kWarpKeys - 1) / kWarpKeys;
  const bool fresh = sp == splits - 1 && k_new != nullptr;

  // the group's query rows, pre-scaled; rows past R are zero
  for (int i = tid; i < kSplitRows * D; i += kSplitThreads) {
    const int r = i / D, e = i % D;
    float val = 0.f;
    if (r < R) {
      const int t = r / group, g = r % group;
      val = to_f(q[(((int64_t)b * T_ + t) * qh + h * group + g) * D + e]) * scale;
    }
    q_s[i] = val;
  }
  // the split's block-table entries (the first kTable of them), clamped to
  // valid page ids, and their pages' scales, in one parallel read
  const int64_t bt_row = (int64_t)b * W;
  for (int i = tid; i < min(p_hi - p_lo, kTable); i += kSplitThreads) {
    const int page = min(max(block_tables[bt_row + p_lo + i], 0), num_pages - 1);
    bt_s[i] = page;
    if (kQuant) {
      ksc_s[i] = k_scale[(int64_t)h * num_pages + page];
      vsc_s[i] = v_scale[(int64_t)h * num_pages + page];
    }
  }
  if (tid < kSplitWarps * kStages) sm90::mbar_init(&full[tid], 1);
  sm90::fence_barrier_init();
  __syncthreads();

  // warp w's blocks u = w, w + 4, ...; block u is keys k_lo + 8u .. of the
  // page p_lo + i
  uint64_t* my_full = full + warp * kStages;
  unsigned char* my_ring = ring + warp * kStages * L::stage;
  const int my_blocks = n_blocks > warp ? (n_blocks - warp + kSplitWarps - 1) / kSplitWarps : 0;
  auto page_at = [&](int i) {
    return i < kTable ? bt_s[i] : min(max(block_tables[bt_row + p_lo + i], 0), num_pages - 1);
  };
  auto issue = [&](int n) {                    // lane 0: the warp's n-th block
    const int u = warp + n * kSplitWarps, key = k_lo + u * kWarpKeys;
    const int i = u * kWarpKeys / page_size;   // page index within the split
    const int rows = min(kWarpKeys, k_hi - key);
    const int64_t row = ((int64_t)h * num_pages + page_at(i)) * page_size + key % page_size;
    unsigned char* dst = my_ring + (n % kStages) * L::stage;
    uint64_t* bar = &my_full[n % kStages];
    sm90::mbar_arrive_expect_tx(bar, 2 * rows * L::row);
    sm90::bulk_load(dst, reinterpret_cast<const unsigned char*>(k_cache) + row * L::row,
                    rows * L::row, bar);
    sm90::bulk_load(dst + L::block, reinterpret_cast<const unsigned char*>(v_cache) + row * L::row,
                    rows * L::row, bar);
  };

  float m[RMAX], l[RMAX], acc[RMAX][DL];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[r][e] = 0.f;
  }

  // (1) the split's context: each warp its own blocks, kStages in flight
  if (lane == 0)
    for (int n = 0; n < min(kStages, my_blocks); ++n) issue(n);
  for (int n = 0; n < my_blocks; ++n) {
    const int st = n % kStages, u = warp + n * kSplitWarps;
    sm90::mbar_wait(&my_full[st], (n / kStages) & 1);
    const KV* ks = reinterpret_cast<const KV*>(my_ring + st * L::stage);
    const KV* vs = reinterpret_cast<const KV*>(my_ring + st * L::stage + L::block);
    float ksc = 1.f, vsc = 1.f;
    if (kQuant) {
      const int i = u * kWarpKeys / page_size;
      ksc = i < kTable ? ksc_s[i] : k_scale[(int64_t)h * num_pages + page_at(i)];
      vsc = i < kTable ? vsc_s[i] : v_scale[(int64_t)h * num_pages + page_at(i)];
    }
    warp_block<KV, D, RMAX>(ks, vs, ksc, vsc, min(kWarpKeys, n_ctx - u * kWarpKeys), 0, q_s,
                            R, group, false, ql, m, l, acc);
    __syncwarp();                              // the block is read: its stage is free
    if (lane == 0 && n + kStages < my_blocks) {
      sm90::fence_proxy_async();
      issue(n + kStages);
    }
  }

  // (2) this step's fresh rows, causal within the step, in the last split:
  // rows 8w .. 8w + 7 to warp w
  float* fk_s = reinterpret_cast<float*>(ring);
  float* fv_s = fk_s + kSplitRows * D;
  if (fresh) {
    __syncthreads();                           // the rings are free
    for (int i = tid; i < T_ * D; i += kSplitThreads) {
      const int j = i / D, e = i % D;
      const int64_t off = (((int64_t)b * T_ + j) * kvh + h) * D + e;
      fk_s[i] = to_f(k_new[off]);
      fv_s[i] = to_f(v_new[off]);
    }
    __syncthreads();
    const int j0 = warp * kWarpKeys;
    if (j0 < T_)
      warp_block<float, D, RMAX>(fk_s + j0 * D, fv_s + j0 * D, 1.f, 1.f,
                                 min(kWarpKeys, T_ - j0), j0, q_s, R, group, true, ql, m, l,
                                 acc);
  }

  // (3) the warps' states combined in a fixed order: out and lse, or the
  // split's partial (m = -inf for a split with no key at all)
  __syncthreads();                             // the rings are free again
  float* acc_s = reinterpret_cast<float*>(ring);   // [warps][16][D]
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= R) break;
    if (lane == 0) {
      ml_s[(warp * kSplitRows + r) * 2] = m[r];
      ml_s[(warp * kSplitRows + r) * 2 + 1] = l[r];
    }
#pragma unroll
    for (int e = 0; e < DL; ++e)
      acc_s[(warp * kSplitRows + r) * D + lane * DL + e] = acc[r][e];
  }
  __syncthreads();
  const bool empty = n_blocks == 0 && !fresh;
  float* part = splits > 1
                    ? ws + (((int64_t)b * kvh + h) * splits + sp) * kSplitRows * (D + 2)
                    : nullptr;
  for (int i = tid; i < R * D; i += kSplitThreads) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) M = fmaxf(M, ml_s[(w * kSplitRows + r) * 2]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = expf(ml_s[(w * kSplitRows + r) * 2] - M);
      lsum = fmaf(wt, ml_s[(w * kSplitRows + r) * 2 + 1], lsum);
      a = fmaf(wt, acc_s[(w * kSplitRows + r) * D + d], a);
    }
    if (part == nullptr) {
      const int t = r / group, g = r % group;
      const int64_t orow = ((int64_t)b * T_ + t) * qh + h * group + g;
      const float lc = fmaxf(lsum, 1e-30f);
      out[orow * D + d] = from_f<T>(a / lc);
      if (d == 0) lse[orow] = M + logf(lc);
    } else {
      if (d == 0) {
        part[2 * r] = empty ? -INFINITY : M;
        part[2 * r + 1] = lsum;
      }
      part[2 * kSplitRows + r * D + d] = a;
    }
  }
}

// The partials of one (kv-head, sequence) merged by their lse weights, in
// split order: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,
// lse = M + log(l) with l clamped to 1e-30 as the single-split path does;
// empty splits (m = -inf) weigh nothing.  Each row's weights are computed
// once, in shared memory, before the columns are summed.
constexpr int kMergeSplits = 64;    // splits a merge CTA weighs in shared memory

template <typename T, int D>
__global__ void __launch_bounds__(kSplitThreads)
ragged_paged_attn_merge_kernel(const float* __restrict__ ws, T* __restrict__ out,
                               float* __restrict__ lse, int T_, int qh, int kvh, int splits) {
  __shared__ float w_s[kSplitRows][kMergeSplits];   // e^(m_s - M)
  __shared__ float row_s[kSplitRows][2];             // M, l
  const int h = blockIdx.x, b = blockIdx.y, group = qh / kvh, R = T_ * group;
  const float* part = ws + ((int64_t)b * kvh + h) * splits * kSplitRows * (D + 2);
  const int64_t stride = kSplitRows * (D + 2);
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float M = kNegInf;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, part[s * stride + 2 * r]);
    float l = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ms = part[s * stride + 2 * r];
      const float w = ms == -INFINITY ? 0.f : expf(ms - M);
      l = fmaf(w, ms == -INFINITY ? 0.f : part[s * stride + 2 * r + 1], l);
      w_s[r][s] = w;
    }
    row_s[r][0] = M;
    row_s[r][1] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += kSplitThreads) {
    const int r = i / D, d = i % D;
    float a = 0.f;
    for (int s = 0; s < splits; ++s)
      if (w_s[r][s] != 0.f) a = fmaf(w_s[r][s], part[s * stride + 2 * kSplitRows + r * D + d], a);
    const int t = r / group, g = r % group;
    const int64_t row = ((int64_t)b * T_ + t) * qh + h * group + g;
    out[row * D + d] = from_f<T>(a / row_s[r][1]);
    if (d == 0) lse[row] = row_s[r][0] + logf(row_s[r][1]);
  }
}

template <typename T, typename KV, int D, int RMAX>
cudaError_t launch_split_r(const void* q, const void* kc, const void* vc, const void* ks,
                           const void* vs, const void* bt, const void* cl, const void* ql,
                           const void* kn, const void* vn, void* out, void* lse, void* ws,
                           int B, int T_, int qh, int kvh, int num_pages, int page_size, int W,
                           int splits, cudaStream_t stream) {
  constexpr size_t bytes = SplitSmem<KV, D>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ragged_paged_attn_split_kernel<T, KV, D, RMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  ragged_paged_attn_split_kernel<T, KV, D, RMAX>
      <<<dim3(splits, kvh, B), kSplitThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(kc), static_cast<const KV*>(vc),
          static_cast<const float*>(ks), static_cast<const float*>(vs),
          static_cast<const int32_t*>(bt), static_cast<const int32_t*>(cl),
          static_cast<const int32_t*>(ql), static_cast<const T*>(kn),
          static_cast<const T*>(vn), static_cast<T*>(out), static_cast<float*>(lse),
          static_cast<float*>(ws), T_, qh, kvh, num_pages, page_size, W,
          1.0f / sqrtf((float)D));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  ragged_paged_attn_merge_kernel<T, D><<<dim3(kvh, B), kSplitThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), static_cast<float*>(lse), T_, qh,
      kvh, splits);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t launch_split(const void* q, const void* kc, const void* vc, const void* ks,
                         const void* vs, const void* bt, const void* cl, const void* ql,
                         const void* kn, const void* vn, void* out, void* lse, void* ws,
                         int B, int T_, int qh, int kvh, int num_pages, int page_size, int W,
                         int splits, cudaStream_t stream) {
  const int R = T_ * (qh / kvh);
  if (R > kSplitRows || splits < 1 || splits > kMergeSplits ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
#define PTT_ARGS q, kc, vc, ks, vs, bt, cl, ql, kn, vn, out, lse, ws, B, T_, qh, kvh, \
                 num_pages, page_size, W, splits, stream
  if (R == 1) return launch_split_r<T, KV, D, 1>(PTT_ARGS);
  if (R <= 4) return launch_split_r<T, KV, D, 4>(PTT_ARGS);
  return launch_split_r<T, KV, D, kSplitRows>(PTT_ARGS);
#undef PTT_ARGS
}

template <typename T, typename KV>
cudaError_t launch_split_d(int head_dim, const void* q, const void* kc, const void* vc,
                           const void* ks, const void* vs, const void* bt, const void* cl,
                           const void* ql, const void* kn, const void* vn, void* out,
                           void* lse, void* ws, int B, int T_, int qh, int kvh, int num_pages,
                           int page_size, int W, int splits, cudaStream_t s) {
#define PTT_ARGS q, kc, vc, ks, vs, bt, cl, ql, kn, vn, out, lse, ws, B, T_, qh, kvh, \
                 num_pages, page_size, W, splits, s
  if (head_dim == 64) return launch_split<T, KV, 64>(PTT_ARGS);
  if (head_dim == 128) return launch_split<T, KV, 128>(PTT_ARGS);
#undef PTT_ARGS
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_split_kv(int kv_dtype, int head_dim, const void* q, const void* kc,
                            const void* vc, const void* ks, const void* vs, const void* bt,
                            const void* cl, const void* ql, const void* kn, const void* vn,
                            void* out, void* lse, void* ws, int B, int T_, int qh, int kvh,
                            int num_pages, int page_size, int W, int splits, cudaStream_t s) {
#define PTT_ARGS head_dim, q, kc, vc, ks, vs, bt, cl, ql, kn, vn, out, lse, ws, B, T_, qh, \
                 kvh, num_pages, page_size, W, splits, s
  if (kv_dtype == 0) return launch_split_d<T, float>(PTT_ARGS);
  if (kv_dtype == 1) return launch_split_d<T, __nv_bfloat16>(PTT_ARGS);
  if (kv_dtype == 2) return launch_split_d<T, int8_t>(PTT_ARGS);
#undef PTT_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q_dtype (q, fresh rows, out):
// 0 = float32, 1 = bfloat16.  kv_dtype (the pool): 0 = float32,
// 1 = bfloat16, 2 = int8 (k_scale/v_scale [kv_heads, num_pages] fp32 then
// required, else ignored and may be null).  q_lens and k_new/v_new may be
// null (all T valid / no fresh rows).  Returns the cudaError_t of the
// launch (0 = success); an unsupported dtype/head_dim returns
// cudaErrorInvalidValue.
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* context_lens,
    const void* q_lens, const void* k_new, const void* v_new, void* out, void* lse,
    int B, int T, int qh, int kvh, int head_dim, int num_pages, int page_size, int W,
    int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_ARGS kv_dtype, head_dim, q, k_cache, v_cache, k_scale, v_scale, \
                 block_tables, context_lens, q_lens, k_new, v_new, out, lse, B, T, \
                 qh, kvh, num_pages, page_size, W, s
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0) err = launch_kv<float>(PTT_ARGS);
  else if (q_dtype == 1) err = launch_kv<__nv_bfloat16>(PTT_ARGS);
#undef PTT_ARGS
  return static_cast<int>(err);
}

// The split route's entry point (kernels/paged_attention.py: _route gives
// "split" when T * group <= 16): ptt_ragged_paged_attention's arguments,
// then the plan's split count (paged_attention.py: split_plan) and the fp32
// workspace for the partials, [B, kvh, splits, 16, head_dim + 2] (unused,
// and may be null, with one split).  Launches the split kernel and, with
// more than one split, the merge kernel after it.  Returns the cudaError_t
// of the launches (0 = success); what the route does not take returns
// cudaErrorInvalidValue.
extern "C" int ptt_ragged_paged_attention_split(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* context_lens,
    const void* q_lens, const void* k_new, const void* v_new, void* out, void* lse,
    int B, int T, int qh, int kvh, int head_dim, int num_pages, int page_size, int W,
    int q_dtype, int kv_dtype, int splits, void* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_ARGS kv_dtype, head_dim, q, k_cache, v_cache, k_scale, v_scale, \
                 block_tables, context_lens, q_lens, k_new, v_new, out, lse, ws, B, T, \
                 qh, kvh, num_pages, page_size, W, splits, s
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0) err = launch_split_kv<float>(PTT_ARGS);
  else if (q_dtype == 1) err = launch_split_kv<__nv_bfloat16>(PTT_ARGS);
#undef PTT_ARGS
  return static_cast<int>(err);
}
