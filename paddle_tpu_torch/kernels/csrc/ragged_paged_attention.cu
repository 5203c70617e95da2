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
// time is (K/V bytes of the live context) / 3.35 TB/s.  The int8 pool
// halves those bytes against bf16 (plus 4 bytes of scale per page).
//
// What the design does about it (simple first, fast later):
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
// Later work (not here): TMA page loads, wgmma for prefill tiles, and a
// split over page chunks with an lse merge for long contexts at small batch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
