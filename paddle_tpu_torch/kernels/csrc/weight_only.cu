// Weight-only quantized matmul for Hopper (sm_90a): W8A16 and W4A16.
//
// Replaces _wo_kernel in paddle_tpu/kernels/weight_only.py (the Pallas TPU
// kernel launched there by weight_only_matmul through the _wo_core custom
// VJP).  ptt_weight_only computes what the plain _wo_reference computes,
//
//     out[m, n] = cast(scale[n] * sum_k x[m, k] * q[k, n])
//
// with q int8 [k, n], or int4 packed two nibbles per byte into [ceil(k/2), n]
// (low nibble = even row k, high nibble = odd row k + 1; the high nibble of
// the last byte of an odd k is padding and is never used), scale fp32 [n],
// the sum in fp32, x fp32, bf16 or fp16 [m, k] and out fp32, bf16 or fp16.
// The scale is applied once, after the k loop, in fp32, then the cast: the
// reference's _finalize.
//
// What bounds it on this card: at decode (m = 8) bytes, the weight read
// once: llama2_7b's gate/up weight [4096, 11008] is 45.1 MB in int8 (0.0135
// ms at 3.35 TB/s) and 22.5 MB in int4 (0.0068 ms); in a prefill chunk
// (m = 512) operations, 2 m k n = 46.2 GFLOP at 989 TFLOP/s (0.047 ms).
//
// What the design does about it (simple first, fast later):
// - One thread block (4 warps) per (row tile, 64 output columns); the row
//   tile is 16 rows for m <= 16 and 64 rows above that (bf16/fp16), 8 or
//   64 rows (fp32).  blockIdx.x walks the row tiles, so the blocks that run
//   together read the same weight columns and share them through L2: the
//   weight comes from device memory about once.
// - The block walks k in steps of 32 logical rows.  Each step it loads the
//   weight tile as 16-byte vectors along n (32 x 64 int8 codes, or 16 x 64
//   packed bytes), dequantizes it into shared memory in x's dtype (int8
//   codes in [-127, 127] and int4 codes in [-8, 7] are exact in bf16 and
//   fp16) and stages the x tile beside it.  The next step's loads are in
//   flight in registers while the current step's products run.
// - bf16 / fp16 x: WMMA 16x16x16 fragments (mma.sync on the tensor cores)
//   in x's dtype with fp32 accumulators: the products are exact, so this is
//   the reference's fp32 dot up to summation order.  At decode the 16-row
//   tile computes 8 padding rows of zeros.
// - fp32 x: register-tiled FMA (not TF32, which would round x); each step's
//   32 products are summed apart and then added to the running sum, which
//   keeps the fp32 summation error near the reference's.
// - Edges run here, not in a fallback: rows past m, columns past n and rows
//   past k read as zeros and are never stored, and x[:, k] is never read.
//   Shapes whose rows are not 16-byte multiples (n % 16, k % 8) or whose
//   pointers are not 16-byte aligned take the same kernel with element
//   loads instead of vectors.
// Later work (not here): split-K or a GEMV form for small m (at n = 4096 the
// 64-column tiles give only 64 blocks for 132 SMs), cp.async/TMA rings, and
// wgmma for prefill.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // logical weight rows (k) per step
constexpr int kThreads = 128;  // 4 warps

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// out[i] = v in the output dtype (0 fp32, 1 bf16, 2 fp16), rounded to nearest
// even as torch's .to() does.
__device__ __forceinline__ void store_out(void* out, int64_t i, float v, int code) {
  if (code == 0)
    static_cast<float*>(out)[i] = v;
  else if (code == 1)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<__half*>(out)[i] = __float2half_rn(v);
}

// 16 bytes of x: row `row`, elements [col, col + 16 / sizeof(T)); rows past m
// and elements past k read as 0.  VEC: k % 8 == 0 and x 16-byte aligned, so
// a chunk lies wholly inside or outside k.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_x(const T* __restrict__ x, int row, int m,
                                        int col, int k) {
  constexpr int VE = 16 / sizeof(T);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= m) return v;
  const T* p = x + (int64_t)row * k + col;
  if constexpr (VEC) {
    if (col < k) v = *reinterpret_cast<const uint4*>(p);
  } else {
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < VE; ++i)
      if (col + i < k) e[i] = p[i];
  }
  return v;
}

// 16 weight bytes: stored row `row` of `rows`, columns [col, col + 16) of n;
// rows past `rows` and columns past n read as 0.  VEC: n % 16 == 0 and w
// 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ uint4 load_w(const int8_t* __restrict__ w, int row, int rows,
                                        int col, int n) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return v;
  const int8_t* p = w + (int64_t)row * n + col;
  if constexpr (VEC) {
    if (col < n) v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    int8_t* b = reinterpret_cast<int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (col + i < n) b[i] = p[i];
  }
  return v;
}

// 16 signed codes -> 16 values of T at dst (16-byte aligned).
template <typename T>
__device__ __forceinline__ void store_codes(T* dst, const int (&c)[16]) {
  __align__(16) T v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = from_float<T>(static_cast<float>(c[e]));
#pragma unroll
  for (int q = 0; q < 16 * (int)sizeof(T) / 16; ++q)
    reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(v)[q];
}

// Dequantize one thread's 16 weight bytes into the [kBK][LDB] tile of T:
// int8, stored row r -> tile row r; int4, packed row r -> tile rows 2r (low
// nibbles) and 2r + 1 (high nibbles, zero when 2r + 1 is at or past k).
template <typename T, bool INT4, int LDB>
__device__ __forceinline__ void dequant_to(T (*b_s)[LDB], uint4 raw, int r, int c,
                                          int k0, int k) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  if constexpr (!INT4) {
    int v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = b[e];
    store_codes(&b_s[r][c], v);
  } else {
    const bool hi_live = k0 + 2 * r + 1 < k;
    int lo[16], hi[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int byte = b[e];                                  // sign-extended
      lo[e] = static_cast<int>(static_cast<unsigned>(byte) << 28) >> 28;
      hi[e] = hi_live ? (byte >> 4) : 0;
    }
    store_codes(&b_s[2 * r][c], lo);
    store_codes(&b_s[2 * r + 1][c], hi);
  }
}

// Register staging of one k step: x chunks and this thread's weight chunk.
template <typename T, int BM, bool INT4, bool VEC>
struct Step {
  static constexpr int VE = 16 / sizeof(T);                 // x elements per chunk
  static constexpr int XC = BM * kBK / VE;                  // x chunks per step
  static constexpr int XPT = (XC + kThreads - 1) / kThreads;
  static constexpr int WROWS = INT4 ? kBK / 2 : kBK;        // stored weight rows
  static constexpr int WC = WROWS * kBN / 16;               // weight chunks (<= 128)
  uint4 xr[XPT];
  uint4 wr;

  __device__ __forceinline__ void load(const T* __restrict__ x,
                                       const int8_t* __restrict__ w, int m0, int n0,
                                       int k0, int m, int k, int n, int tid) {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = tid + j * kThreads;
      xr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < XC) {
        const int r = i / (kBK / VE), c = (i % (kBK / VE)) * VE;
        xr[j] = load_x<T, VEC>(x, m0 + r, m, k0 + c, k);
      }
    }
    if (tid < WC) {
      const int r = tid / (kBN / 16), c = (tid % (kBN / 16)) * 16;
      const int rows = INT4 ? (k + 1) / 2 : k;
      wr = load_w<VEC>(w, (INT4 ? k0 / 2 : k0) + r, rows, n0 + c, n);
    }
  }
};

// --------------------------------------------------- bf16 / fp16 x: WMMA ---

template <typename T, int BM, bool INT4, bool VEC>
__global__ void __launch_bounds__(kThreads)
wo_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scale, void* __restrict__ out, int m, int k,
              int n, int out_code) {
  constexpr int WM = BM >= 32 ? 2 : 1;       // warps along M
  constexpr int WN = 4 / WM;                 // warps along N
  constexpr int FM = BM / 16 / WM;           // 16-row fragments per warp
  constexpr int FN = kBN / WN / 16;          // 16-col fragments per warp
  constexpr int LDA = kBK + 8;               // +16 bytes: fewer bank conflicts
  constexpr int LDB = kBN + 8;
  constexpr int LDC = kBN + 4;
  using S = Step<T, BM, INT4, VEC>;
  __shared__ __align__(32) T a_s[BM][LDA];
  __shared__ __align__(32) T b_s[kBK][LDB];
  __shared__ __align__(32) float c_s[BM][LDC];
  __shared__ float s_s[kBN];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;

  if (tid < kBN) s_s[tid] = n0 + tid < n ? scale[n0 + tid] : 0.f;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  S st;
  st.load(x, w, m0, n0, 0, m, k, n, tid);
  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < S::XPT; ++j) {
      const int i = tid + j * kThreads;
      if (i < S::XC) {
        const int r = i / (kBK / S::VE), c = (i % (kBK / S::VE)) * S::VE;
        *reinterpret_cast<uint4*>(&a_s[r][c]) = st.xr[j];
      }
    }
    if (tid < S::WC)
      dequant_to<T, INT4, LDB>(b_s, st.wr, tid / (kBN / 16), (tid % (kBN / 16)) * 16,
                               k0, k);
    __syncthreads();
    if (k0 + kBK < k) st.load(x, w, m0, n0, k0 + kBK, m, k, n, tid);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &a_s[(wm * FM + i) * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &b_s[kk][(wn * FN + j) * 16], LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&c_s[(wm * FM + i) * 16][(wn * FN + j) * 16], acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    if (m0 + r < m && n0 + c < n)
      store_out(out, (int64_t)(m0 + r) * n + n0 + c, c_s[r][c] * s_s[c], out_code);
  }
}

// ------------------------------------------------------------ fp32 x: FMA ---

template <int TM, bool INT4, bool VEC>
__global__ void __launch_bounds__(kThreads)
wo_fma_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scale, void* __restrict__ out, int m, int k,
              int n, int out_code) {
  constexpr int RM = TM / 8;                 // rows per thread
  using S = Step<float, TM, INT4, VEC>;
  __shared__ float a_s[TM][kBK + 1];         // +1: distinct banks per row
  __shared__ __align__(16) float b_s[kBK][kBN];
  __shared__ float s_s[kBN];

  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;    // columns tx + 16 j, rows ty + 8 i

  if (tid < kBN) s_s[tid] = n0 + tid < n ? scale[n0 + tid] : 0.f;
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  S st;
  st.load(x, w, m0, n0, 0, m, k, n, tid);
  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < S::XPT; ++j) {
      const int i = tid + j * kThreads;
      if (i < S::XC) {
        const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(&st.xr[j]);
        a_s[r][c] = v.x;
        a_s[r][c + 1] = v.y;
        a_s[r][c + 2] = v.z;
        a_s[r][c + 3] = v.w;
      }
    }
    if (tid < S::WC)
      dequant_to<float, INT4, kBN>(b_s, st.wr, tid / (kBN / 16), (tid % (kBN / 16)) * 16,
                                   k0, k);
    __syncthreads();
    if (k0 + kBK < k) st.load(x, w, m0, n0, k0 + kBK, m, k, n, tid);
    float part[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = a_s[ty + 8 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a, b[j], part[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (row < m && n0 + c < n)
        store_out(out, (int64_t)row * n + n0 + c, acc[i][j] * s_s[c], out_code);
    }
  }
}

// ----------------------------------------------------------------- launch ---

template <typename T, int BM, bool INT4, bool VEC>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int m,
                   int k, int n, int out_code, cudaStream_t s) {
  dim3 grid((m + BM - 1) / BM, (n + kBN - 1) / kBN);
  if constexpr (std::is_same_v<T, float>) {
    wo_fma_kernel<BM, INT4, VEC><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), out, m, k, n, out_code);
  } else {
    wo_mma_kernel<T, BM, INT4, VEC><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), out, m, k, n, out_code);
  }
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t launch_bm(bool int4, bool vec, const void* x, const void* w,
                      const void* scale, void* out, int m, int k, int n, int out_code,
                      cudaStream_t s) {
  if (int4)
    return vec ? launch<T, BM, true, true>(x, w, scale, out, m, k, n, out_code, s)
               : launch<T, BM, true, false>(x, w, scale, out, m, k, n, out_code, s);
  return vec ? launch<T, BM, false, true>(x, w, scale, out, m, k, n, out_code, s)
             : launch<T, BM, false, false>(x, w, scale, out, m, k, n, out_code, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// ptt_weight_only: out [m, n] = cast(scale * (x [m, k] @ q)); q int8 [k, n]
// (int4 = 0) or packed [ceil(k/2), n] (int4 = 1); scale fp32 [n]; x_dtype
// and out_dtype 0 fp32, 1 bf16, 2 fp16.  All operands contiguous, on the
// stream's device; the Python wrapper checks that.  Returns the launch's
// cudaError_t.
extern "C" int ptt_weight_only(const void* x, const void* w, const void* scale,
                               void* out, int m, int k, int n, int int4, int x_dtype,
                               int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || k <= 0 || n <= 0 || out_dtype < 0 || out_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 16 == 0 && k % 8 == 0 && aligned16(x) && aligned16(w);
  const bool i4 = int4 != 0;
  switch (x_dtype) {
    case 0:
      return static_cast<int>(
          m <= 8 ? launch_bm<float, 8>(i4, vec, x, w, scale, out, m, k, n, out_dtype, s)
                 : launch_bm<float, 64>(i4, vec, x, w, scale, out, m, k, n, out_dtype, s));
    case 1:
      return static_cast<int>(
          m <= 16
              ? launch_bm<__nv_bfloat16, 16>(i4, vec, x, w, scale, out, m, k, n, out_dtype, s)
              : launch_bm<__nv_bfloat16, 64>(i4, vec, x, w, scale, out, m, k, n, out_dtype,
                                             s));
    case 2:
      return static_cast<int>(
          m <= 16 ? launch_bm<__half, 16>(i4, vec, x, w, scale, out, m, k, n, out_dtype, s)
                  : launch_bm<__half, 64>(i4, vec, x, w, scale, out, m, k, n, out_dtype, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
